"""ctypes binding for the native HNSW graph index (``hnsw.cpp``).

Counterpart of ``cadence_rag_tpu/native/hnsw.py``: pgvector's HNSW (build
m / ef_construction, query ef_search) on the host, the recall gate's
``hnsw`` mode. Built with ``-march=native``: the library is built on the
machine that loads it (``native/build.py``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .build import load_library

_SRC = Path(__file__).with_name("hnsw.cpp")
_FLAGS = ("-O3", "-march=native")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = load_library(_SRC, _FLAGS)
        if lib is None:
            return None
        lib.hnsw_build.restype = ctypes.c_void_p
        lib.hnsw_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, ctypes.c_int32,
        ]
        lib.hnsw_search.restype = None
        lib.hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.hnsw_free.restype = None
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


class HnswIndex:
    """Build once over (N, dim) unit vectors; search with ef_search."""

    def __init__(self, vectors: np.ndarray, m: int = 16,
                 ef_construction: int = 64, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native hnsw unavailable (g++ missing or failed)")
        self._lib = lib
        # the graph borrows these rows: keep them alive with the index
        self._vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n, dim = self._vectors.shape
        self.n, self.dim = n, dim
        self._handle = lib.hnsw_build(
            self._vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, dim, m, ef_construction, seed, 0,
        )

    def search(self, query: np.ndarray, k: int = 10,
               ef_search: int = 80) -> Tuple[np.ndarray, np.ndarray]:
        """-> (similarities (Q, k) f32, rows (Q, k) int32; -1 / -1e30 past
        the hits found)."""
        q = np.ascontiguousarray(query, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        out_idx = np.full((q.shape[0], k), -1, dtype=np.int32)
        out_sim = np.full((q.shape[0], k), -np.inf, dtype=np.float32)
        for row in range(q.shape[0]):
            self._lib.hnsw_search(
                self._handle,
                q[row].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ef_search, k,
                out_idx[row].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_sim[row].ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        return out_sim, out_idx

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hnsw_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
