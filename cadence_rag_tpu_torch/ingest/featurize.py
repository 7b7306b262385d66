"""Document and query featurization: text -> index row features.

Counterpart of ``cadence_rag_tpu/ingest/featurize.py``, with the pure-Python
featurizer of ``ops/hashing.py`` only (the JAX package's C++ featurizer,
``native/lexhash``, gives the same bits and is not copied) and the plain
single-hash lexical layout only: the learned vocab head (``core/vocab.py``)
is not ported, so ``set_active_vocab`` refuses a vocab. Widths come from the
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
    return [hashing.doc_signature_from_raw(*hashing.raw_feature_arrays(t), dim, avgdl)
            for t in texts]


def query_lexical_features(text: str):
    """(buckets, signs, clipped tfs) of one query; the index turns them
    into a query vector with each corpus's idf."""
    return hashing.query_feature_arrays(text, int(settings.lexical_dim))


def query_lexical_features_batch(texts: Sequence[str]):
    """``query_lexical_features`` per text."""
    dim = int(settings.lexical_dim)
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
    """``query_tech_structure`` per query."""
    return [query_tech_structure(t) for t in token_lists]
