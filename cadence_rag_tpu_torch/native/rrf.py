"""ctypes binding for the native RRF group-merge core (``rrf.cpp``).

Counterpart of ``cadence_rag_tpu/native/rrf.py`` (its two merge entry
points). ``merge_groups`` and ``merge_rect_groups`` return the fused groups
with the semantics of the numpy path in ``ops/fusion._merge_flat`` (same
f64 accumulation order, same (plan, -score, first) order), or ``None`` when
the library cannot be built, so callers take the numpy path.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .build import load_library

_SRC = Path(__file__).with_name("rrf.cpp")
_FLAGS = ("-O3",)
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
        i8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.rrf_merge_groups.restype = ctypes.c_int64
        lib.rrf_merge_groups.argtypes = [
            i32p, i64p, f64p, i8p, ctypes.c_int64, ctypes.c_int32,
            i32p, i64p, f64p, i8p,
        ]
        lib.rrf_merge_rect_groups.restype = ctypes.c_int64
        lib.rrf_merge_rect_groups.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(i64p), ctypes.POINTER(i32p), i32p,
            ctypes.c_int32,
            i32p, i64p, f64p, i8p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def merge_groups(
    plan: np.ndarray, doc: np.ndarray, contrib: np.ndarray,
    bits: np.ndarray, n_plans: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """-> (plan, doc, score, mask) per fused group, plan-major then score
    desc then first occurrence asc; None if the library is missing or a
    plan value lies outside [0, n_plans)."""
    lib = _load()
    if lib is None:
        return None
    n = int(plan.shape[0])
    plan = np.ascontiguousarray(plan, dtype=np.int32)
    doc = np.ascontiguousarray(doc, dtype=np.int64)
    contrib = np.ascontiguousarray(contrib, dtype=np.float64)
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    out_plan = np.empty(n, dtype=np.int32)
    out_doc = np.empty(n, dtype=np.int64)
    out_score = np.empty(n, dtype=np.float64)
    out_mask = np.empty(n, dtype=np.uint8)
    m = int(lib.rrf_merge_groups(
        plan.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        doc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        contrib.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, int(n_plans),
        out_plan.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_doc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    ))
    if m < 0:
        return None
    return out_plan[:m], out_doc[:m], out_score[:m], out_mask[:m]


def merge_rect_groups(
    lanes, n_plans: int, rrf_k: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """``merge_groups`` over rectangular lane blocks: ``lanes`` =
    [(ids (B, k_l) int64, counts (B,) int32)] in lane-bit order. None if
    the library is missing."""
    lib = _load()
    if lib is None or not lanes:
        return None
    n_lanes = len(lanes)
    ids_arrs = []
    counts_arrs = []
    widths = np.empty(n_lanes, dtype=np.int32)
    total = 0
    for i, (ids2d, counts) in enumerate(lanes):
        ids2d = np.ascontiguousarray(ids2d, dtype=np.int64)
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        ids_arrs.append(ids2d)
        counts_arrs.append(counts)
        widths[i] = ids2d.shape[1]
        total += int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int32)
        return (z, np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.float64), np.zeros(0, dtype=np.uint8))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ids_ptrs = (i64p * n_lanes)(*[a.ctypes.data_as(i64p) for a in ids_arrs])
    counts_ptrs = (i32p * n_lanes)(*[c.ctypes.data_as(i32p) for c in counts_arrs])
    out_plan = np.empty(total, dtype=np.int32)
    out_doc = np.empty(total, dtype=np.int64)
    out_score = np.empty(total, dtype=np.float64)
    out_mask = np.empty(total, dtype=np.uint8)
    m = int(lib.rrf_merge_rect_groups(
        n_lanes, int(n_plans), ids_ptrs, counts_ptrs,
        widths.ctypes.data_as(i32p), int(rrf_k),
        out_plan.ctypes.data_as(i32p),
        out_doc.ctypes.data_as(i64p),
        out_score.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    ))
    return out_plan[:m], out_doc[:m], out_score[:m], out_mask[:m]
