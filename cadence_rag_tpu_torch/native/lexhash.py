"""ctypes binding for the native lexical featurizer (``lexhash.cpp``).

Counterpart of ``cadence_rag_tpu/native/lexhash.py``. Normalization stays in
Python (``ops/hashing.normalize_text``, the canonical definition);
tokenize + hash + weight + quantize run native, bit-identical to the
pure-Python featurizer of ``ops/hashing.py`` (tested). The library is built
with g++ at first use by ``native/build.load_library``; where it cannot be
built ``available()`` is False and every function raises ``RuntimeError``,
so ``ingest/featurize.py`` takes the pure-Python path.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.hashing import BM25_B, BM25_K1, LEX_QUANT_SCALE, normalize_text
from .build import load_library

_SRC = Path(__file__).with_name("lexhash.cpp")
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
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.lex_doc_signature.restype = ctypes.c_int64
        lib.lex_doc_signature.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int8), i32p, i64p,
        ]
        lib.lex_query_features.restype = ctypes.c_int64
        lib.lex_query_features.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, i64p, f32p, f32p,
        ]
        lib.lex_raw_features.restype = ctypes.c_int64
        lib.lex_raw_features.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, u64p, f32p,
        ]
        lib.lex_query_features_batch.restype = ctypes.c_int64
        lib.lex_query_features_batch.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, i64p, f32p, f32p, i64p,
        ]
        lib.lex_raw_features_batch.restype = ctypes.c_int64
        lib.lex_raw_features_batch.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_int64,
            u64p, f32p, i64p,
        ]
        lib.lex_tech_structures_batch.restype = ctypes.c_int64
        lib.lex_tech_structures_batch.argtypes = [
            ctypes.c_char_p, i64p, i32p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            i32p, i32p, i32p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def doc_signature(
    text: str, dim: int, avgdl: float,
    k1: float = BM25_K1, b: float = BM25_B,
) -> Tuple[np.ndarray, np.ndarray, int]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native lexhash unavailable")
    data = normalize_text(text).encode("utf-8")
    out_w = np.zeros(dim, dtype=np.int8)
    out_touched = np.zeros(dim, dtype=np.int32)
    out_dl = ctypes.c_int64(0)
    n_touched = lib.lex_doc_signature(
        data, len(data), dim, float(avgdl), float(k1), float(b),
        float(LEX_QUANT_SCALE),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        out_touched.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(out_dl),
    )
    if n_touched < 0:
        raise RuntimeError("lex_doc_signature failed")
    return out_w, out_touched[:n_touched].copy(), int(out_dl.value)


def query_features(
    text: str, dim: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(buckets int64, signs f32, tfs f32) in first-occurrence order —
    bit-identical to ops.hashing.query_feature_arrays (tested)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native lexhash unavailable")
    data = normalize_text(text).encode("utf-8")
    # unique features <= word runs + trigrams < 2 * len(data); a full
    # window (n == max_out) may still mean truncation — double and retry
    max_out = 2 * len(data) + 8
    while True:
        buckets = np.zeros(max_out, dtype=np.int64)
        signs = np.zeros(max_out, dtype=np.float32)
        tfs = np.zeros(max_out, dtype=np.float32)
        n = lib.lex_query_features(
            data, len(data), dim, max_out,
            buckets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            signs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if n < max_out:
            break
        max_out *= 2
    if n < 0:
        raise RuntimeError("lex_query_features failed")
    return buckets[:n].copy(), signs[:n].copy(), tfs[:n].copy()


def query_features_batch(
    texts, dim: int
):
    """Per-text (buckets, signs, tfs) for a whole request batch in ONE
    native call, saving the per-text ctypes crossings and scratch
    allocations. Bit-identical to query_features per text (tested)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native lexhash unavailable")
    blobs = [normalize_text(text).encode("utf-8") for text in texts]
    n = len(blobs)
    if n == 0:
        return []
    data = b"".join(blobs)
    ends = np.cumsum([len(blob) for blob in blobs], dtype=np.int64)
    cap = 2 * len(data) + 8 * n
    # -1 signals a possibly-truncated text (output window filled): double
    # the capacity and retry per the lexhash.cpp contract. The 2*len+8n
    # bound makes a retry unreachable in practice, but the contract is
    # implemented rather than assumed.
    for _ in range(4):
        buckets = np.zeros(cap, dtype=np.int64)
        signs = np.zeros(cap, dtype=np.float32)
        tfs = np.zeros(cap, dtype=np.float32)
        counts = np.zeros(n, dtype=np.int64)
        total = lib.lex_query_features_batch(
            data, ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            dim, cap,
            buckets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            signs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if total >= 0:
            break
        cap *= 2
    if total < 0:
        raise RuntimeError("lex_query_features_batch failed")
    out = []
    off = 0
    for count in counts:
        count = int(count)
        out.append((buckets[off:off + count].copy(),
                    signs[off:off + count].copy(),
                    tfs[off:off + count].copy()))
        off += count
    return out


def raw_features_batch(texts):
    """Per-text (hashes, tfs) for a batch in one native call (see
    query_features_batch)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native lexhash unavailable")
    blobs = [normalize_text(text).encode("utf-8") for text in texts]
    n = len(blobs)
    if n == 0:
        return []
    data = b"".join(blobs)
    ends = np.cumsum([len(blob) for blob in blobs], dtype=np.int64)
    cap = 2 * len(data) + 8 * n
    for _ in range(4):  # -1 = retry with doubled cap (see lexhash.cpp)
        hashes = np.zeros(cap, dtype=np.uint64)
        tfs = np.zeros(cap, dtype=np.float32)
        counts = np.zeros(n, dtype=np.int64)
        total = lib.lex_raw_features_batch(
            data, ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            cap,
            hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if total >= 0:
            break
        cap *= 2
    if total < 0:
        raise RuntimeError("lex_raw_features_batch failed")
    out = []
    off = 0
    for count in counts:
        count = int(count)
        out.append((hashes[off:off + count].copy(),
                    tfs[off:off + count].copy()))
        off += count
    return out


def raw_features(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """(fnv1a64 hashes uint64, unclipped tfs f32) in first-occurrence
    order — matches ops.hashing.lexical_features key/value order."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native lexhash unavailable")
    data = normalize_text(text).encode("utf-8")
    max_out = 2 * len(data) + 8
    while True:
        hashes = np.zeros(max_out, dtype=np.uint64)
        tfs = np.zeros(max_out, dtype=np.float32)
        n = lib.lex_raw_features(
            data, len(data), max_out,
            hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            tfs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if n < max_out:
            break
        max_out *= 2
    if n < 0:
        raise RuntimeError("lex_raw_features failed")
    return hashes[:n].copy(), tfs[:n].copy()


def tech_structures_batch(
    token_lists, slots: int, cap0: int, max_cap: int,
):
    """Per-query tech slot structures for a whole batch in one crossing,
    in place of the per-query Python placement loop
    (ops/hashing.tech_query_structure).

    ``token_lists`` holds RAW token lists; normalization (strip/lower,
    drop empties, first-occurrence dedupe) happens here in Python so
    Unicode lowering semantics stay Python's. Returns
    ``[(structure int32 (slots*cap_q,), dropped int), ...]`` — identical
    to tech_query_structure per query (parity-tested)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native lexhash unavailable")
    keys = []
    counts = np.zeros(len(token_lists), dtype=np.int32)
    for q, tokens in enumerate(token_lists):
        seen = set()
        n = 0
        for token in tokens:
            key = token.strip().lower()
            if not key or key in seen:
                continue
            seen.add(key)
            keys.append(key.encode("utf-8"))
            n += 1
        counts[q] = n
    if keys:
        ends = np.cumsum([len(k) for k in keys]).astype(np.int64)
        data = b"".join(keys)
    else:
        ends = np.zeros(0, dtype=np.int64)
        data = b""
    n_queries = len(token_lists)
    out = np.zeros((n_queries, slots * max_cap), dtype=np.int32)
    out_caps = np.zeros(n_queries, dtype=np.int32)
    out_dropped = np.zeros(n_queries, dtype=np.int32)
    rc = lib.lex_tech_structures_batch(
        data, ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_queries, slots, cap0, max_cap,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_caps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_dropped.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc < 0:
        raise RuntimeError("lex_tech_structures_batch failed")
    return [
        (out[q, : slots * int(out_caps[q])].copy(), int(out_dropped[q]))
        for q in range(n_queries)
    ]
