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
the device path. ``bulk_store_rows`` writes matching metadata rows into the
SQLite store, so evidence-pack serving reads real rows.
``append_synthetic_rows`` fills the room a corpus's capacity has left;
``install_synthetic_cold`` fills a capped corpus's host cold tier, and
``install_capped_copy`` rebuilds one corpus's rows, in their order, in a
corpus capped at ``INDEX_MAX_DEVICE_ROWS``: the first rows hot, the rest in
the cold tier, so a capped index can be held to the uncapped one.
``install_sharded_copy`` gives a row-sharded corpus (``MESH_SHAPE``) the rows
of an unsharded one, each in the shard that owns its position, so a sharded
index can be held to the unsharded one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


def append_synthetic_rows(
    corpus: CorpusIndex, n: int, n_calls: int, seed: int = 3,
) -> np.ndarray:
    """Append n synthetic rows (doc ids continuing after the corpus's
    highest) INTO THE ROOM THE CAPACITY HAS, generated on the device in
    slabs and written through the index's own slab write, so a running
    growth migration journals them. No growth, no trigger: a scale run fills
    a corpus to just under its capacity with this and then crosses it
    through ``insert``. -> the new doc ids."""
    dev = corpus.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with corpus.lock:
        start = corpus.count
        if start + n > corpus.capacity:
            raise ValueError(
                f"{corpus.name}: {n} more rows do not fit capacity "
                f"{corpus.capacity} at {start} rows")
        first_id = int(corpus.h_ids[:start].max(initial=0)) + 1
        for b0 in range(0, n, GEN_ROWS):
            b = min(GEN_ROWS, n - b0)
            x = torch.randn((b, corpus.dim), generator=gen, device=dev)
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
            if corpus.emb_dtype == torch.int8:
                x = torch.clamp(torch.round(x * 127.0), -127, 127)
            call = torch.randint(0, n_calls, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)
            started = torch.randint(1_600_000_000, 1_750_000_000, (b,),
                                    generator=gen, device=dev, dtype=torch.int32)
            corpus._write("write_slabs", (
                start + b0,
                x.to(corpus.emb_dtype),
                torch.randint(-4, 5, (b, corpus.lex_dim), generator=gen,
                              device=dev, dtype=torch.int8),
                torch.randint(1, 5000, (b, corpus.tech_slots), generator=gen,
                              device=dev, dtype=torch.int32),
                call, started,
                torch.ones(b, dtype=torch.bool, device=dev),
            ))
            sl = slice(start + b0, start + b0 + b)
            corpus.h_call[sl] = call.cpu().numpy()
            corpus.h_started[sl] = started.cpu().numpy()
        ids = np.arange(first_id, first_id + n, dtype=np.int64)
        corpus.h_ids[start:start + n] = ids
        corpus.h_has_emb[start:start + n] = True
        corpus._id_to_pos.update(
            (int(d), start + i) for i, d in enumerate(ids))
        corpus.dl_sum += 12 * n
        corpus.emb_rows += n
        corpus.count += n
        if corpus.ivf is not None:
            corpus._ivf_append_overflow(
                np.arange(start, start + n, dtype=np.int32))
    return ids


def _cold_room(corpus: CorpusIndex, n: int):
    """The corpus's cold tier with room for ``n`` more rows."""
    tier = corpus._cold_tier()
    if tier.count + n > tier.capacity:
        tier._alloc(_next_pow2(tier.count + n, lo=1024))
    return tier


def install_synthetic_cold(
    corpus: CorpusIndex, n: int, n_calls: int, seed: int = 2,
) -> None:
    """Fill ``corpus``'s HOST cold tier with n synthetic rows (doc ids
    continue after both tiers'), generated on the corpus's device in slabs
    and copied into the tier's arrays — the DocRow insert path takes
    minutes at millions of rows. Updates the tier's counters and its
    id map; the synthetic lexical stats of ``install_synthetic_corpus``
    stand for both tiers."""
    dev = corpus.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with corpus.lock:
        tier = _cold_room(corpus, n)
        start = tier.count
        first_id = int(corpus.h_ids[: corpus.count].max(initial=0)) + 1
        if tier.count:
            first_id = max(first_id, int(tier.ids[: tier.count].max()) + 1)
        for b0 in range(0, n, GEN_ROWS):
            b = min(GEN_ROWS, n - b0)
            sl = slice(start + b0, start + b0 + b)
            x = torch.randn((b, corpus.dim), generator=gen, device=dev)
            x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
            if corpus.emb_dtype == torch.int8:
                x = torch.clamp(torch.round(x * 127.0), -127, 127)
            tier.emb[sl] = x.to(corpus.emb_dtype).cpu()
            tier.lex[sl] = torch.randint(
                -4, 5, (b, corpus.lex_dim), generator=gen, device=dev,
                dtype=torch.int8).cpu()
            tier.tech[sl] = torch.randint(
                1, 5000, (b, corpus.tech_slots), generator=gen, device=dev,
                dtype=torch.int32).cpu()
            tier.call_idx[sl] = torch.randint(
                0, n_calls, (b,), generator=gen, device=dev,
                dtype=torch.int32).cpu()
            tier.started[sl] = torch.randint(
                1_600_000_000, 1_750_000_000, (b,), generator=gen, device=dev,
                dtype=torch.int32).cpu()
            tier.has_emb[sl] = True
        ids = np.arange(first_id, first_id + n, dtype=np.int64)
        tier.ids[start:start + n] = ids
        tier._id_to_pos.update((int(d), start + i) for i, d in enumerate(ids))
        tier.emb_rows += n
        tier.count += n


def install_capped_copy(src: CorpusIndex, dst: CorpusIndex) -> None:
    """Give ``dst`` (empty, capped at ``dst.max_device_rows``, same widths
    and device as ``src``) the rows of ``src`` in their order: the first
    ``max_device_rows`` in its device arrays, the rest in its host cold
    tier, with the ids, host mirrors and corpus-wide lexical stats of
    ``src``. Tombstoned rows of ``src`` come along as tombstones."""
    cap_rows = int(dst.max_device_rows)
    if not cap_rows or dst.count or dst.cold_rows:
        raise ValueError("install_capped_copy: dst must be empty and capped")
    with src.lock, dst.lock:
        n = src.count
        hot = min(n, cap_rows)
        cap = max(dst.capacity, _next_pow2(max(hot, 8)))
        dst.capacity = cap
        dst._alloc_device(cap)
        for new, old in zip(dst.device_arrays(), src.device_arrays()):
            new[:hot].copy_(old[:hot])
        for attr in ("h_ids", "h_call", "h_started", "h_has_emb"):
            old = getattr(src, attr)
            mirror = np.zeros(cap, dtype=old.dtype)
            if attr == "h_started":
                mirror[:] = INT32_MIN
            mirror[:hot] = old[:hot]
            setattr(dst, attr, mirror)
        live = dst.h_started[:hot] != INT32_MIN
        dst._id_to_pos = {
            int(d): p for p, d in enumerate(dst.h_ids[:hot]) if live[p]}
        dst.emb_rows = int(dst.h_has_emb[:hot].sum())
        dst.tombstones = int((~live).sum())
        dst.count = hot
        dst.doc_freq = src.doc_freq.copy()
        dst.dl_sum = src.dl_sum
        m = n - hot
        if m:
            tier = _cold_room(dst, m)
            for cold, old in zip(tier.row_arrays(), src.device_arrays()):
                cold[:m].copy_(old[hot:n])
            tier.ids[:m] = src.h_ids[hot:n]
            started = src.h_started[hot:n]
            tier._id_to_pos = {
                int(d): p for p, d in enumerate(tier.ids[:m])
                if started[p] != INT32_MIN}
            tier.emb_rows = int(src.h_has_emb[hot:n].sum())
            tier.tombstones = int((started == INT32_MIN).sum())
            tier.count = m


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


_WORDS = [
    "object", "store", "tiering", "latency", "rollback", "gateway",
    "cluster", "retry", "budget", "bake-off", "lenovo", "azure",
]


def synth_text(i: int) -> str:
    return (
        f"chunk {i} discussing {_WORDS[i % len(_WORDS)]} and "
        f"{_WORDS[(i * 7) % len(_WORDS)]} with ECONNRESET v2.{i % 9}.1"
    )


def bulk_store_rows(
    store,
    n_chunks: int,
    n_artifacts: int,
    n_calls: int,
    call_ids: Optional[List[str]] = None,
    chunk_text=None,
    artifact_text=None,
) -> List[str]:
    """Matching metadata rows (chunk_id/artifact_chunk_id = 1..n) via
    executemany — seconds at 1M rows instead of minutes row-at-a-time.
    ``chunk_text(i)`` / ``artifact_text(i)`` give row i's text (default: the
    synthetic sentences)."""
    chunk_text = chunk_text or synth_text
    artifact_text = artifact_text or (lambda i: f"artifact {i} about the rollout")
    from ..utils.timeutil import now_utc, to_iso

    now = to_iso(now_utc())
    with store.read() as conn:
        # a page cache that holds the bulk rows' transaction: pages are
        # written once at commit, not spilled to the log as it fills (at
        # 1M rows minutes become seconds); the store's own size after it
        cache_size = conn.execute("PRAGMA cache_size").fetchone()[0]
        conn.execute("PRAGMA cache_size = -1048576")
    try:
        return _bulk_rows(store, n_chunks, n_artifacts, n_calls, call_ids,
                          chunk_text, artifact_text, now)
    finally:
        with store.read() as conn:
            conn.execute(f"PRAGMA cache_size = {int(cache_size)}")


def _bulk_rows(store, n_chunks, n_artifacts, n_calls, call_ids, chunk_text,
               artifact_text, now) -> List[str]:
    if call_ids is None:
        call_ids = [f"00000000-0000-4000-8000-{s:012d}" for s in range(n_calls)]
        with store.tx() as conn:
            conn.executemany(
                "INSERT INTO calls (call_id, call_seq, started_at, title) "
                "VALUES (?,?,?,?)",
                [(call_ids[s], s, now, f"bench call {s}")
                 for s in range(n_calls)],
            )
    with store.tx() as conn:
        conn.executemany(
            "INSERT INTO chunks (chunk_id, call_id, call_started_at, speaker,"
            " start_ts_ms, end_ts_ms, token_count, text, tech_tokens, lex_dl)"
            " VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                (i + 1, call_ids[i % n_calls], now, "A", 0, 1000, 12,
                 chunk_text(i), "[]", 10)
                for i in range(n_chunks)
            ),
        )
        conn.executemany(
            "INSERT INTO analysis_artifacts (artifact_id, call_id, "
            "call_started_at, kind, content, token_count, tech_tokens) "
            "VALUES (?,?,?,?,?,?,?)",
            (
                (i + 1, call_ids[i % n_calls], now, "summary",
                 artifact_text(i), 6, "[]")
                for i in range(n_artifacts)
            ),
        )
        conn.executemany(
            "INSERT INTO artifact_chunks (artifact_chunk_id, artifact_id, "
            "call_id, call_started_at, kind, ordinal, content, token_count, "
            "tech_tokens, lex_dl) VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                (i + 1, i + 1, call_ids[i % n_calls], now, "summary", 0,
                 artifact_text(i), 6, "[]", 6)
                for i in range(n_artifacts)
            ),
        )
    return call_ids


def install_sharded_copy(src: CorpusIndex, dst: CorpusIndex) -> None:
    """Give ``dst`` (empty, row-sharded) the rows of ``src`` (unsharded,
    same widths) in their order at ``src``'s capacity (rounded to a layout
    the mesh shards), through the sharded slab write: each row lands in the
    shard that owns its position. Ids, host mirrors, lexical stats and
    counters are ``src``'s; tombstoned rows come along as tombstones."""
    if dst.mesh is None or dst.count:
        raise ValueError("install_sharded_copy: dst must be empty and sharded")
    with src.lock, dst.lock:
        n = src.count
        cap = dst._shard_cap(max(dst.capacity, src.capacity))
        dst.capacity = cap
        dst._alloc_device(cap)
        if n:
            dst._write("write_slabs", (0, *(a[:n] for a in src.device_arrays())))
        for attr in ("h_ids", "h_call", "h_started", "h_has_emb"):
            old = getattr(src, attr)
            mirror = np.zeros(cap, dtype=old.dtype)
            if attr == "h_started":
                mirror[:] = INT32_MIN
            mirror[:n] = old[:n]
            setattr(dst, attr, mirror)
        dst._id_to_pos = dict(src._id_to_pos)
        dst.doc_freq = src.doc_freq.copy()
        dst.dl_sum = src.dl_sum
        dst.emb_rows = src.emb_rows
        dst.tombstones = src.tombstones
        dst.count = n
