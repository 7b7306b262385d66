"""Document and query featurization: text -> index row features.

Counterpart of ``cadence_rag_tpu/ingest/featurize.py``. The batch entry
points dispatch to the native C++ featurizer (``native/lexhash``) when it is
built and fall back to the pure-Python featurizer of ``ops/hashing.py``,
the plain reference; both give the same bits (tested). With a vocab head
active (``set_active_vocab``; learned by ``core/vocab.py``) the native
library supplies the raw features only and numpy places them
(``ops/hashing.apply_vocab``), so both featurizers agree with a vocab as
without. Widths come from the port's ``settings``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import settings
from ..ops import hashing
from ..utils.locks import RWLock

# Vocab-layout gate: ingest/delete paths hold the READ side across
# featurize -> store write -> device insert; an online vocab rebuild
# (core/vocab.build_and_apply) holds the WRITE side for the activate +
# re-featurize window, so no document can land half in the old layout
# and half unscanned by the re-featurize pass.
vocab_gate = RWLock()

# Active lexical vocab head: the T most document-frequent features get
# dedicated collision-free buckets [0, T). Learned per store by
# ``python -m cadence_rag_tpu_torch.scripts.build_lex_vocab`` and activated
# at startup/restore; None = plain single-hash layout (the default). Every
# featurizer in the process must agree with the layout the device
# signatures were built with, hence one module-level registry.
_ACTIVE_VOCAB: Optional[np.ndarray] = None
_ACTIVE_VOCAB_VERSION: int = 0


def _native():
    """The native featurizer module, or None where it cannot be built."""
    from ..native import lexhash

    return lexhash if lexhash.available() else None


def native_available() -> bool:
    """True when the batch entry points run the native featurizer."""
    return _native() is not None


def set_active_vocab(vocab: Optional[np.ndarray], version: int) -> None:
    """Install a vocab head (a sorted uint64 hash array, as the JAX package
    keeps it; unsorted input is sorted and deduplicated) or clear it."""
    global _ACTIVE_VOCAB, _ACTIVE_VOCAB_VERSION
    if vocab is not None:
        vocab = np.asarray(vocab, dtype=np.uint64)
        if vocab.size > 1 and not np.all(vocab[1:] > vocab[:-1]):
            vocab = np.unique(vocab)
        if vocab.size >= int(settings.lexical_dim):
            raise ValueError(
                f"lex vocab head {vocab.size} must be smaller than "
                f"lexical_dim {settings.lexical_dim}"
            )
    _ACTIVE_VOCAB = vocab if (vocab is not None and vocab.size) else None
    _ACTIVE_VOCAB_VERSION = int(version) if _ACTIVE_VOCAB is not None else 0


def active_vocab() -> Tuple[Optional[np.ndarray], int]:
    """(vocab head or None, version; 0 = the plain layout)."""
    return _ACTIVE_VOCAB, _ACTIVE_VOCAB_VERSION


def lexical_signature(
    text: str, avgdl: float
) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (int8 signature (lexical_dim,), touched buckets, doc length)."""
    return lexical_signatures_batch([text], avgdl)[0]


def lexical_signatures_batch(texts: Sequence[str], avgdl: float):
    """Per text (int8 signature (lexical_dim,), touched buckets, doc
    length), under the active vocab."""
    dim = int(settings.lexical_dim)
    return [hashing.doc_signature_from_raw(h, t, dim, avgdl, _ACTIVE_VOCAB)
            for h, t in raw_lexical_features_batch(texts)]


def raw_lexical_features_batch(texts: Sequence[str]):
    """Per text (uint64 hashes, f32 tfs) raw features: one native call for
    the batch when the native featurizer is built."""
    native = _native()
    if native is not None:
        return native.raw_features_batch(list(texts))
    return [hashing.raw_feature_arrays(t) for t in texts]


def query_lexical_vector(
    text: str, doc_freq: np.ndarray, n_docs: int
) -> np.ndarray:
    """One query's idf-weighted signed vector (f32 (lexical_dim,))."""
    buckets, signs, tfs = query_lexical_features(text)
    return hashing.query_vector_from_features(
        buckets, signs, tfs, int(settings.lexical_dim), doc_freq, n_docs)


def query_lexical_features(text: str):
    """(buckets, signs, clipped tfs) of one query; the index turns them
    into a query vector with each corpus's idf."""
    return query_lexical_features_batch([text])[0]


def query_lexical_features_batch(texts: Sequence[str]):
    """``query_lexical_features`` per text: one native call for the batch
    when the native featurizer is built. The native library computes the
    plain layout's buckets itself; under a vocab it gives raw features and
    numpy places them."""
    dim = int(settings.lexical_dim)
    if _ACTIVE_VOCAB is not None:
        return [
            hashing.query_feature_arrays_from_raw(h, t, dim, _ACTIVE_VOCAB)
            for h, t in raw_lexical_features_batch(texts)
        ]
    native = _native()
    if native is not None:
        return native.query_features_batch(list(texts), dim)
    return [hashing.query_feature_arrays(text, dim) for text in texts]


def tech_slots(tokens: Sequence[str]) -> np.ndarray:
    """A document's (tech_hash_slots,) int32 slot-addressed token hashes."""
    return hashing.tech_token_hashes(tokens, int(settings.tech_hash_slots))


def query_tech_structure(tokens: Sequence[str]) -> tuple:
    """(structure (S*C,) int32, dropped count); the capacity C starts at
    ``tech_slot_capacity`` and doubles up to max(8, 4x) while tokens
    drop."""
    cap = int(settings.tech_slot_capacity)
    return hashing.tech_query_structure(
        tokens, int(settings.tech_hash_slots), cap, max_capacity=max(8, 4 * cap))


def query_tech_structures_batch(token_lists: Sequence[Sequence[str]]):
    """``query_tech_structure`` per query: one native call for the batch
    when the native featurizer is built."""
    native = _native()
    if native is not None:
        cap = int(settings.tech_slot_capacity)
        return native.tech_structures_batch(
            token_lists, int(settings.tech_hash_slots), cap, max(8, 4 * cap))
    return [query_tech_structure(t) for t in token_lists]
