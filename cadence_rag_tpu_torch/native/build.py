"""Build a C++ source of this directory into a shared library with g++.

The library lands in ``build/cadence_rag_tpu_torch/native/`` beside the
package (git-ignored), named by a hash of the source and the flags, so an
edit rebuilds it. The build runs under an exclusive ``fcntl`` lock on a
file beside it, and the finished library is moved into place in one
``os.replace``: processes that start at once (test workers) build it once,
and none loads a half-written file. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

from ..kernels.build import BUILD_DIR

NATIVE_DIR = BUILD_DIR / "native"


def library_path(src: Path, flags: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return NATIVE_DIR / f"_{src.stem}.{h.hexdigest()[:16]}.so"


def load_library(src: Path, flags: Sequence[str], timeout: float = 300.0
                 ) -> Optional[ctypes.CDLL]:
    """Build ``src`` with g++ if its library is missing, then load it;
    None when g++ is missing or fails (the caller's numpy path serves)."""
    lib = library_path(src, flags)
    NATIVE_DIR.mkdir(parents=True, exist_ok=True)
    with open(NATIVE_DIR / f"_{src.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib.is_file():
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        ["g++", *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)],
                        check=True, capture_output=True, timeout=timeout)
                    os.replace(tmp, lib)
                except (subprocess.SubprocessError, OSError):
                    tmp.unlink(missing_ok=True)
                    return None
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    try:
        return ctypes.CDLL(str(lib))
    except OSError:
        return None
