"""Deterministic hash embedder.

Counterpart of ``cadence_rag_tpu/embed/stub.py`` (``HashEmbeddingProvider``):
each lexical feature hashes to a deterministic gaussian direction, and a
text embeds to the L2-normalized, log(1 + tf)-weighted sum of its features'
directions, so texts that share vocabulary are cosine-similar. Unit-norm,
``settings.embeddings_dim`` wide. Directions are cached in one contiguous
bank (hash -> row); features come from ``ops/hashing.raw_feature_arrays``.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence

import numpy as np

from ..config import settings
from ..ops.hashing import raw_feature_arrays
from .provider import EmbeddingResult

_MODEL_ID = "hash-embedder-v1"
_BANK_MAX_ROWS = 200_000


def _direction(h: int, dim: int) -> np.ndarray:
    """One gaussian row seeded by the masked 64-bit feature hash."""
    rng = np.random.default_rng(h & 0x7FFFFFFFFFFFFFFF)
    return rng.standard_normal(dim).astype(np.float32)


class _DirectionBank:
    def __init__(self, dim: int):
        self.dim = dim
        self.rows = np.zeros((256, dim), dtype=np.float32)
        self.row_of: Dict[int, int] = {}
        self.n = 0
        # sorted snapshot of row_of: an all-hit lookup is one searchsorted
        self._skeys = np.zeros(0, dtype=np.uint64)
        self._srows = np.zeros(0, dtype=np.int64)
        self.lock = threading.Lock()

    def _lookup(self, hashes: np.ndarray) -> np.ndarray:
        """Row index per hash, -1 for misses."""
        if self._skeys.size == 0:
            return np.full(hashes.shape, -1, dtype=np.int64)
        pos = np.searchsorted(self._skeys, hashes)
        pos_c = np.minimum(pos, self._skeys.size - 1)
        return np.where(self._skeys[pos_c] == hashes, self._srows[pos_c], -1)

    def _rebuild_sorted(self) -> None:
        keys = np.fromiter(self.row_of.keys(), dtype=np.uint64,
                           count=len(self.row_of))
        vals = np.fromiter(self.row_of.values(), dtype=np.int64,
                           count=len(self.row_of))
        order = np.argsort(keys)
        self._skeys = keys[order]
        self._srows = vals[order]

    def directions(self, hashes: np.ndarray) -> np.ndarray:
        """(F, dim) direction matrix for the given feature hashes."""
        with self.lock:
            rows = self._lookup(hashes)
            if rows.size == 0 or rows.min() >= 0:
                return self.rows[rows]
            out = np.empty((len(hashes), self.dim), dtype=np.float32)
            hit = rows >= 0
            out[hit] = self.rows[rows[hit]]
            inserted = False
            for i in np.flatnonzero(~hit):
                h = int(hashes[i])
                row = self.row_of.get(h)  # a repeated miss within this call
                if row is not None:
                    out[i] = self.rows[row]
                    continue
                vec = _direction(h, self.dim)
                out[i] = vec
                if self.n < _BANK_MAX_ROWS:
                    if self.n >= self.rows.shape[0]:
                        grown = np.zeros((self.rows.shape[0] * 2, self.dim),
                                         dtype=np.float32)
                        grown[: self.n] = self.rows[: self.n]
                        self.rows = grown
                    self.rows[self.n] = vec
                    self.row_of[h] = self.n
                    self.n += 1
                    inserted = True
            if inserted:
                self._rebuild_sorted()
            return out


_banks: Dict[int, _DirectionBank] = {}
_banks_lock = threading.Lock()


def _bank(dim: int) -> _DirectionBank:
    with _banks_lock:
        bank = _banks.get(dim)
        if bank is None:
            bank = _DirectionBank(dim)
            _banks[dim] = bank
        return bank


class HashEmbeddingProvider:
    model_id = _MODEL_ID

    def embed(self, texts: Sequence[str]) -> EmbeddingResult:
        """All texts' features in one bank lookup (deduplicated), then one
        weighted sum per text; a text without features embeds to e0."""
        dim = int(settings.embeddings_dim)
        out = np.zeros((len(texts), dim), dtype=np.float32)
        if not texts:
            return EmbeddingResult(vectors=out, model=self.model_id)
        feats = [raw_feature_arrays(text) for text in texts]
        all_hashes = np.concatenate([h for h, _ in feats])
        if all_hashes.size == 0:
            out[:, 0] = 1.0
            return EmbeddingResult(vectors=out, model=self.model_id)
        uniq, inv = np.unique(all_hashes, return_inverse=True)
        dirs = _bank(dim).directions(uniq)
        off = 0
        for i, (hashes, tfs) in enumerate(feats):
            size = int(hashes.size)
            if size == 0:
                out[i, 0] = 1.0
                continue
            out[i] = np.log1p(tfs) @ dirs[inv[off:off + size]]
            off += size
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.divide(out, norms, out=out, where=norms > 0)
        return EmbeddingResult(vectors=out, model=self.model_id)
