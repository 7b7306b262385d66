"""Document and query featurization: text -> index row features.

Counterpart of ``cadence_rag_tpu/ingest/featurize.py``. The batch entry
points dispatch to the native C++ featurizer (``native/lexhash``) when it is
built and fall back to the pure-Python featurizer of ``ops/hashing.py``,
the plain reference; both give the same bits (tested). Only the plain
single-hash lexical layout is served: the learned vocab head
(``core/vocab.py``) is not ported, so ``set_active_vocab`` refuses a vocab
and the stand-ins below refuse a store that has one. Widths come from the
port's ``settings``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import settings
from ..ops import hashing
from ..utils.locks import RWLock

# Vocab-layout gate: ingest paths hold the READ side across featurize ->
# store write -> device insert, as in the JAX package, where an online
# vocab rebuild holds the WRITE side. The port has no rebuild yet, so only
# readers take it.
vocab_gate = RWLock()

VOCAB_NOT_PORTED = (
    "the learned lexical vocab head (core/vocab.py) is not ported yet "
    "(ROADMAP Queue 1 item 4): the port serves the plain single-hash layout"
)


def refuse_applied_vocab(store) -> None:
    """Raise when ``store`` has an applied lexical vocab: its signatures
    follow a layout this package cannot featurize."""
    with store.read() as conn:
        row = conn.execute(
            "SELECT MAX(version) AS v FROM lex_vocab WHERE applied=1"
        ).fetchone()
    if row["v"] is not None:
        raise RuntimeError(
            f"the store's lexical vocab v{row['v']}: {VOCAB_NOT_PORTED}")


def adopt_store_layout(store, index) -> None:
    """Stand-in for ``core/vocab.adopt_store_layout`` until the vocab head
    is ported: a store without an applied vocab needs nothing adopted; one
    with an applied vocab (another process built it) raises."""
    refuse_applied_vocab(store)


def auto_rebuild_if_needed(store, index) -> None:
    """Stand-in for ``core/vocab.auto_rebuild_if_needed``: nothing to do
    unless ``LEX_VOCAB_AUTO_REBUILD`` is on, which startup refuses."""
    if settings.lex_vocab_auto_rebuild:
        raise NotImplementedError(
            f"LEX_VOCAB_AUTO_REBUILD: {VOCAB_NOT_PORTED}")


def _native():
    """The native featurizer module, or None where it cannot be built."""
    from ..native import lexhash

    return lexhash if lexhash.available() else None


def native_available() -> bool:
    """True when the batch entry points run the native featurizer."""
    return _native() is not None


def set_active_vocab(vocab: Optional[np.ndarray], version: int) -> None:
    """Only ``None`` (the plain layout) is accepted."""
    if vocab is not None and np.asarray(vocab).size:
        raise NotImplementedError(VOCAB_NOT_PORTED)


def active_vocab() -> Tuple[Optional[np.ndarray], int]:
    """(vocab head, version): always the plain layout, (None, 0)."""
    return None, 0


def lexical_signature(
    text: str, avgdl: float
) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (int8 signature (lexical_dim,), touched buckets, doc length)."""
    return lexical_signatures_batch([text], avgdl)[0]


def lexical_signatures_batch(texts: Sequence[str], avgdl: float):
    """Per text (int8 signature (lexical_dim,), touched buckets, doc
    length)."""
    dim = int(settings.lexical_dim)
    return [hashing.doc_signature_from_raw(h, t, dim, avgdl)
            for h, t in raw_lexical_features_batch(texts)]


def raw_lexical_features_batch(texts: Sequence[str]):
    """Per text (uint64 hashes, f32 tfs) raw features: one native call for
    the batch when the native featurizer is built."""
    native = _native()
    if native is not None:
        return native.raw_features_batch(list(texts))
    return [hashing.raw_feature_arrays(t) for t in texts]


def query_lexical_features(text: str):
    """(buckets, signs, clipped tfs) of one query; the index turns them
    into a query vector with each corpus's idf."""
    return hashing.query_feature_arrays(text, int(settings.lexical_dim))


def query_lexical_features_batch(texts: Sequence[str]):
    """``query_lexical_features`` per text: one native call for the batch
    when the native featurizer is built."""
    dim = int(settings.lexical_dim)
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
