"""Document and query featurization: text -> index row features.

Counterpart of ``cadence_rag_tpu/ingest/featurize.py``, trimmed to the
batch entry points the port calls and to the pure-Python featurizer of
``ops/hashing.py`` (the JAX package's C++ featurizer gives the same bits,
so it is not copied), with the plain single-hash lexical layout (no vocab
head). Widths come from the port's ``settings``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import settings
from ..ops import hashing


def lexical_signatures_batch(texts: Sequence[str], avgdl: float):
    """Per text (int8 signature (lexical_dim,), touched buckets, doc
    length)."""
    dim = int(settings.lexical_dim)
    return [hashing.doc_signature_from_raw(*hashing.raw_feature_arrays(t), dim, avgdl)
            for t in texts]


def query_lexical_features_batch(texts: Sequence[str]):
    """Per text the (buckets, signs, clipped tfs) the index turns into a
    query vector with each corpus's idf."""
    dim = int(settings.lexical_dim)
    return [hashing.query_feature_arrays(text, dim) for text in texts]


def tech_slots(tokens: Sequence[str]) -> np.ndarray:
    """A document's (tech_hash_slots,) int32 slot-addressed token hashes."""
    return hashing.tech_token_hashes(tokens, int(settings.tech_hash_slots))


def query_tech_structures_batch(token_lists: Sequence[Sequence[str]]):
    """Per query (structure (S*C,) int32, dropped count); the capacity C
    starts at ``tech_slot_capacity`` and doubles up to max(8, 4x) while
    tokens drop."""
    slots = int(settings.tech_hash_slots)
    cap = int(settings.tech_slot_capacity)
    return [hashing.tech_query_structure(t, slots, cap, max_capacity=max(8, 4 * cap))
            for t in token_lists]
