"""Build ``csrc/*.cu`` into one shared library and load it with ctypes.

Route: ``nvcc`` straight to a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes), loaded with
``ctypes``; every pointer and the stream pass as ``c_void_p``. Each source
compiles to an object in its own nvcc process, all started together, and
one more nvcc links them, so the build takes as long as the slowest
source rather than the sum. The library
lands in ``build/cadence_rag_tpu_torch/libkernels.so`` beside the package
(``build/`` is git-ignored) and is rebuilt only when the hash of the
sources and flags changes. The build happens at first use — importing
this module touches nothing — so ``python3 chip_smoke.py`` alone builds
every kernel from the checkout.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``check`` raises on a nonzero code, since a refused launch never runs and a
later synchronize would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cadence_rag_tpu_torch"
LIB_PATH = BUILD_DIR / "libkernels.so"
STAMP_PATH = BUILD_DIR / "libkernels.sha256"
LOG_PATH = BUILD_DIR / "build.log"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build in this process took (0.0 when the cached
# library was current); chip_smoke.py reports it
last_build_seconds = 0.0


def nvcc_path() -> str:
    """$CUDA_HOME/bin/nvcc, else nvcc on PATH, else the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for path in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if path and Path(path).is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile if the sources changed since the last build; -> library path."""
    global last_build_seconds
    digest = source_digest()
    if (LIB_PATH.is_file() and STAMP_PATH.is_file()
            and STAMP_PATH.read_text().strip() == digest):
        last_build_seconds = 0.0
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = os.getpid()
    tmp = BUILD_DIR / f"libkernels.{tag}.tmp.so"
    objs, procs = [], []
    t0 = time.perf_counter()
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate(timeout=900)
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]}: exit code {proc.returncode}\n{err}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link: exit code {proc.returncode}\n{proc.stderr}")
    last_build_seconds = time.perf_counter() - t0
    LOG_PATH.write_text("\n".join(log), encoding="utf-8")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, LIB_PATH)
    STAMP_PATH.write_text(digest + "\n")
    return LIB_PATH


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ck_error_string.restype = ctypes.c_char_p
    lib.ck_error_string.argtypes = [i32]
    lib.ck_fused_scan.restype = i32
    lib.ck_fused_scan.argtypes = [
        p, p, p, i32, p,            # q_emb, q_lex pieces, emb, emb_is_int8, lex
        p, i64, p,                  # mask, mask row pitch, has_emb
        i64, i32, i32, i32, i32,    # n, batch, dim, lex_dim, do_dense
        p, p, p, p, i64,            # d_vals, d_idx, l_vals, l_idx, n_cand
        p,                          # stream
    ]
    lib.ck_dense_scan.restype = i32
    lib.ck_dense_scan.argtypes = [
        p, p, p, i64, i32, i32,     # q, rows, mask, n, batch, dim
        i32, p, p, i64,             # block_n, vals, idx, n_cand
        p,                          # stream
    ]
    lib.ck_tech_keys.restype = i32
    lib.ck_tech_keys.argtypes = [
        p, i32, p, i32, p, p,       # q, q_width, tech, slots, started, mask
        i64, i32, p,                # n, batch, keys
        p,                          # stream
    ]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().ck_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    """The current PyTorch stream of ``device`` as a raw ``cudaStream_t``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
