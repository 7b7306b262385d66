"""Synthetic corpus installer for scale runs.

Counterpart of ``cadence_rag_tpu/evals/synth.py``
(``install_synthetic_corpus``): the document tensors are generated directly
on the corpus's device at its padded capacity — same shapes and value
ranges as the JAX installer — and installed into a live ``CorpusIndex``
with its host mirrors synced, so the index serves the production path.
Values come from a ``torch.Generator`` on that device seeded by ``seed``;
they differ from ``jax.random``'s, which is expected.

``insert_text_rows`` and ``plan_text_queries`` add real rows and plan real
queries on top: texts featurized by ``ingest.featurize`` and embedded by the
deterministic stub embedder, the host work ingest and the engine do before
the device path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.index import (
    INT32_MAX, INT32_MIN, CorpusIndex, DeviceIndexManager, DocRow, _next_pow2,
)
from ..embed.stub import HashEmbeddingProvider
from ..engine.planner import choose_dense_mode
from ..ingest import featurize

# rows per generation slab: bounds the f32 staging of the embeddings
# (131072 x 1024 x 4 B = 512 MB)
GEN_ROWS = 131072


def install_synthetic_corpus(
    corpus: CorpusIndex,
    n: int,
    n_calls: int,
    seed: int = 0,
) -> None:
    """Fill ``corpus`` with n synthetic rows (doc ids 1..n) on its device.
    Padding rows beyond n get ``started = INT32_MIN`` and ``has_emb =
    False``, so every lane's mask excludes them."""
    cap = max(corpus.capacity, _next_pow2(max(n, 8)))
    dev = corpus.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with corpus.lock:
        corpus.capacity = cap
        corpus.emb = torch.empty((cap, corpus.dim), dtype=corpus.emb_dtype,
                                 device=dev)
        for r0 in range(0, cap, GEN_ROWS):
            r1 = min(cap, r0 + GEN_ROWS)
            x = torch.randn((r1 - r0, corpus.dim), generator=gen, device=dev)
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
            if corpus.emb_dtype == torch.int8:
                # quantize like CorpusIndex._encode_emb
                x = torch.clamp(torch.round(x * 127.0), -127, 127)
            corpus.emb[r0:r1] = x.to(corpus.emb_dtype)
        corpus.lex = torch.empty((cap, corpus.lex_dim), dtype=torch.int8,
                                 device=dev)
        for r0 in range(0, cap, GEN_ROWS):
            r1 = min(cap, r0 + GEN_ROWS)
            corpus.lex[r0:r1] = torch.randint(
                -4, 5, (r1 - r0, corpus.lex_dim), generator=gen, device=dev,
                dtype=torch.int8)
        corpus.tech = torch.randint(1, 5000, (cap, corpus.tech_slots),
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
        corpus.call_idx = torch.randint(0, n_calls, (cap,), generator=gen,
                                        device=dev, dtype=torch.int32)
        rows = torch.arange(cap, device=dev)
        started = torch.randint(1_600_000_000, 1_750_000_000, (cap,),
                                generator=gen, device=dev, dtype=torch.int32)
        corpus.started = torch.where(
            rows < n, started, torch.full_like(started, INT32_MIN))
        corpus.has_emb = rows < n

        corpus.h_ids = np.zeros(cap, dtype=np.int64)
        corpus.h_ids[:n] = np.arange(1, n + 1)
        corpus.h_call = corpus.call_idx.cpu().numpy().copy()
        corpus.h_started = corpus.started.cpu().numpy().copy()
        corpus.h_has_emb = np.zeros(cap, dtype=bool)
        corpus.h_has_emb[:n] = True
        corpus._id_to_pos = {i + 1: i for i in range(n)}
        rng = np.random.default_rng(seed)
        corpus.doc_freq = rng.integers(
            1, max(n // 4, 2), size=corpus.lex_dim
        ).astype(np.int64)
        corpus.dl_sum = 12 * n
        corpus.emb_rows = n
        corpus.tombstones = 0
        corpus.count = n


def insert_text_rows(
    corpus: CorpusIndex,
    texts: Sequence[str],
    tokens: Sequence[Sequence[str]],
    *,
    doc_id0: int,
    call_seq: int,
    started0: int,
) -> None:
    """Insert one row per text (doc ids ``doc_id0 + i``, start second
    ``started0 + i``, all in call ``call_seq``): lexical signature and tech
    slots from ``featurize``, embedding from the stub embedder."""
    sigs = featurize.lexical_signatures_batch(list(texts), corpus.avgdl)
    vecs = HashEmbeddingProvider().embed(list(texts)).vectors
    corpus.insert([
        DocRow(doc_id=doc_id0 + i, call_seq=call_seq, started_sec=started0 + i,
               lex_sig=sigs[i][0], lex_dl=sigs[i][2], lex_touched=sigs[i][1],
               tech=featurize.tech_slots(list(tokens[i])),
               embedding=np.asarray(vecs[i], dtype=np.float32))
        for i in range(len(texts))
    ])


def plan_text_queries(
    index: DeviceIndexManager,
    texts: Sequence[str],
    tokens: Sequence[Sequence[str]],
    allowed: np.ndarray,                  # (B, call_capacity) bool
    *,
    scoped: bool,
) -> Tuple[tuple, Tuple[str, str]]:
    """One query per text, unbounded dates -> (positional args of
    ``query_both_packed_async``, (chunk mode, artifact mode)). The modes
    come from the port's planner over each corpus's candidate estimate for
    the first query's scope; an IVF index counts for the chunks corpus
    only, as the JAX engine plans (engine/retrieve.py:244-254)."""
    batch = len(texts)
    q_emb = np.asarray(HashEmbeddingProvider().embed(list(texts)).vectors,
                       dtype=np.float32)
    feats = featurize.query_lexical_features_batch(list(texts))
    structures = featurize.query_tech_structures_batch([list(t) for t in tokens])
    width = max(s.shape[0] for s, _ in structures)
    q_tech = np.zeros((batch, width), dtype=np.int32)
    for row, (s, _dropped) in enumerate(structures):
        q_tech[row, : s.shape[0]] = s
    dmin = np.full(batch, INT32_MIN + 1, dtype=np.int32)
    dmax = np.full(batch, INT32_MAX, dtype=np.int32)
    modes = tuple(
        choose_dense_mode(corpus.estimate_candidates(
            allowed[0] if scoped else None, int(dmin[0]), int(dmax[0]),
            unfiltered=not scoped), scoped,
            ivf_available=corpus is index.chunks and corpus.ivf_usable())
        for corpus in (index.chunks, index.artifacts))
    return (q_emb, feats, q_tech, allowed, dmin, dmax), modes
