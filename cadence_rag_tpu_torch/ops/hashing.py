"""Feature hashing for the lexical and tech-token lanes.

Counterpart of ``cadence_rag_tpu/ops/hashing.py``, trimmed to what the port
calls: the lexical features (word tokens and char trigrams of the
normalized text, FNV-1a 64 hashed, signed into ``dim`` buckets, BM25 term
weights folded in at ingest and quantized to int8), the query vector with
bucket-granularity idf, the slot-addressed tech-token hashes, and the
vocab-head layout (``apply_vocab``: the learned head of ``core/vocab.py``
gets dedicated buckets, everything else hashes into the tail). Every
function here gives the JAX package's arrays bit for bit
(tests/test_torch_copies.py, tests/test_torch_vocab.py).
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1

_WORD_RE = re.compile(r"[a-z0-9_]+")
_WS_RE = re.compile(r"\s+")

BM25_K1 = 1.2
BM25_B = 0.75
# term weights tf*(k1+1)/(tf+k1*norm) are bounded by k1+1 = 2.2; bucket sums
# of colliding terms can exceed it, so quantize with headroom
LEX_QUANT_SCALE = 127.0 / 4.0


def fnv1a64(data: bytes) -> int:
    h = FNV_OFFSET
    for byte in data:
        h ^= byte
        h = (h * FNV_PRIME) & _MASK64
    return h


def normalize_text(text: str) -> str:
    return _WS_RE.sub(" ", text.lower()).strip()


def lexical_features(text: str) -> Dict[int, int]:
    """text -> {feature hash: term frequency}, in first-occurrence order:
    word tokens (prefix ``w:``), then char trigrams of the normalized text
    (prefix ``g:``)."""
    norm = normalize_text(text)
    counts: Dict[int, int] = {}
    for word in _WORD_RE.findall(norm):
        h = fnv1a64(b"w:" + word.encode("utf-8"))
        counts[h] = counts.get(h, 0) + 1
    data = norm.encode("utf-8")
    for i in range(len(data) - 2):
        h = fnv1a64(b"g:" + data[i : i + 3])
        counts[h] = counts.get(h, 0) + 1
    return counts


def raw_feature_arrays(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """(hashes uint64, tfs f32) in first-occurrence order."""
    counts = lexical_features(text)
    if not counts:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.float32))
    hashes = np.fromiter(counts.keys(), dtype=np.uint64, count=len(counts))
    tfs = np.fromiter(counts.values(), dtype=np.float32, count=len(counts))
    return hashes, tfs


def apply_vocab(
    hashes: np.ndarray, dim: int, vocab: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Feature hashes -> (bucket int64, sign f32) under an optional vocab
    head. ``vocab`` is a SORTED uint64 array, or None for the plain
    single-hash layout (bucket from the low hash bits, sign from a decoupled
    high bit). A hash found in the head takes its rank as a dedicated,
    collision-free bucket in [0, T) with sign +1; every other hash goes
    into the remaining [T, dim) tail."""
    hashes = np.asarray(hashes, dtype=np.uint64)
    hash_signs = np.where(
        (hashes >> np.uint64(33)) & np.uint64(1), 1.0, -1.0)
    if vocab is None or vocab.size == 0:
        buckets = (hashes % np.uint64(dim)).astype(np.int64)
        return buckets, hash_signs.astype(np.float32)
    head = int(vocab.size)
    tail = dim - head
    if tail < 1:
        raise ValueError(f"vocab head {head} leaves no tail buckets of {dim}")
    idx_c = np.minimum(np.searchsorted(vocab, hashes), head - 1)
    in_head = vocab[idx_c] == hashes
    buckets = np.where(
        in_head,
        idx_c.astype(np.int64),
        np.int64(head) + (hashes % np.uint64(tail)).astype(np.int64),
    )
    signs = np.where(in_head, np.float32(1.0), hash_signs).astype(np.float32)
    return buckets, signs


def doc_signature_from_raw(
    hashes: np.ndarray, tfs: np.ndarray, dim: int, avgdl: float,
    vocab: Optional[np.ndarray] = None,
    k1: float = BM25_K1, b: float = BM25_B,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """One document's quantized BM25 signature from its raw features, placed
    under an optional vocab head -> (int8 weights (dim,), touched buckets
    int32, doc length)."""
    dl = int(tfs.sum())
    norm = 1.0 - b + b * (dl / max(avgdl, 1.0))
    acc = np.zeros(dim, dtype=np.float32)
    if hashes.size:
        buckets, signs = apply_vocab(hashes, dim, vocab)
        tfs = tfs.astype(np.float64)
        w = (signs.astype(np.float64)
             * (tfs * (k1 + 1.0)) / (tfs + k1 * norm)).astype(np.float32)
        np.add.at(acc, buckets, w)
    quant = np.clip(np.rint(acc * LEX_QUANT_SCALE), -127, 127).astype(np.int8)
    touched = np.flatnonzero(acc).astype(np.int32)
    return quant, touched, dl


def query_feature_arrays_from_raw(
    hashes: np.ndarray, tfs: np.ndarray, dim: int,
    vocab: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(buckets, signs, clipped tfs) from a query's raw features under an
    optional vocab head."""
    if hashes.size == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.astype(np.float32), empty.astype(np.float32)
    buckets, signs = apply_vocab(hashes, dim, vocab)
    return buckets, signs, np.minimum(tfs.astype(np.float32), 3.0)


def query_feature_arrays(text: str, dim: int):
    """A query hashed once -> (buckets, signs, clipped tfs) in the plain
    layout; each corpus applies its own idf."""
    return query_feature_arrays_from_raw(*raw_feature_arrays(text), dim)


def query_vector_from_features(
    buckets: np.ndarray, signs: np.ndarray, tfs: np.ndarray,
    dim: int, doc_freq: np.ndarray, n_docs: int,
) -> np.ndarray:
    """The idf-weighted signed query vector (f32 (dim,))."""
    q = np.zeros(dim, dtype=np.float32)
    if buckets.size == 0 or n_docs <= 0:
        return q
    df = doc_freq[buckets].astype(np.float32)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    np.add.at(q, buckets, signs * idf * tfs)
    return q / LEX_QUANT_SCALE


# the tech slots' addressing scheme; a checkpoint of another layout is refused
TECH_LAYOUT_VERSION = 2


@functools.lru_cache(maxsize=65536)
def _tech_hash(key: str) -> int:
    return (fnv1a64(b"t:" + key.encode("utf-8")) % 0x7FFFFFFE) + 1


def tech_slot_choices(h: int, slots: int) -> Tuple[int, int]:
    """The two candidate slots of a token hash (2-choice placement)."""
    return h % slots, (h >> 8) % slots


def tech_token_hashes(tokens: Sequence[str], slots: int) -> np.ndarray:
    """A document's tech tokens -> (slots,) positive int32 hashes, 0 empty:
    token h lives at slot h % S, or (h >> 8) % S if that is taken (both
    taken: dropped). Case-insensitive."""
    out = np.zeros(slots, dtype=np.int32)
    seen = set()
    for token in tokens:
        key = token.strip().lower()
        if not key or key in seen:
            continue
        seen.add(key)
        h = _tech_hash(key)
        s1, s2 = tech_slot_choices(h, slots)
        if out[s1] == 0:
            out[s1] = np.int32(h)
        elif out[s2] == 0:
            out[s2] = np.int32(h)
    return out


def tech_query_structure(
    tokens: Sequence[str], slots: int, capacity: int,
    max_capacity: int = 0,
) -> Tuple[np.ndarray, int]:
    """A query's tech tokens -> ((slots*capacity,) int32 structure, dropped
    count): block c, column s holds the c-th query hash that could live in
    doc slot s, and a token occupies both its choice columns. If tokens
    drop, the capacity doubles while ``max_capacity`` allows."""
    if max_capacity <= 0:
        max_capacity = capacity * 2
    seen = set()
    entries = []  # (h, s1, s2)
    for token in tokens:
        key = token.strip().lower()
        if not key or key in seen:
            continue
        seen.add(key)
        h = _tech_hash(key)
        s1, s2 = tech_slot_choices(h, slots)
        entries.append((h, s1, s2))
    while True:
        out = [0] * (slots * capacity)
        dropped = 0
        for h, s1, s2 in entries:
            fully_placed = True
            for s in ((s1,) if s1 == s2 else (s1, s2)):
                ok = False
                for c in range(capacity):
                    pos = c * slots + s
                    v = out[pos]
                    if v == 0 or v == h:
                        out[pos] = h
                        ok = True
                        break
                fully_placed = fully_placed and ok
            if not fully_placed:
                dropped += 1
        if dropped == 0 or capacity * 2 > max_capacity:
            return np.array(out, dtype=np.int32), dropped
        capacity *= 2
