#!/usr/bin/env python3
"""Drive the PyTorch port's /retrieve path once on one CUDA card.

    python3 chip_smoke.py [--details PATH] [--phase model_axis|probes]

Phases, each printing a line or a few; any failure exits nonzero without the
final result line:

1. device  — require CUDA; print the card and ``nvidia-smi``'s name and
             power limit.
2. build   — build the kernels from ``cadence_rag_tpu_torch/csrc`` with nvcc.
3. K1      — ``fused_scan`` against its plain PyTorch version at the main
             path's shapes (batch 128, 1,048,576 rows, 1024-d bf16, 4096-wide
             int8, a real filter mask, rows without embeddings) and at a
             ragged row count with int8 embeddings.
4. K3      — the tech lane (``tech_keys.range_topk`` and its final topk)
             against its plain version at batch 128 x 1M rows, 16 slots:
             three match densities x k 1/10/50/64, a ragged row count,
             batch 1 and 200; per-range keys and the lane's values and rows
             identical, ties included. CUDA-event times at widths 16 and 32.
5. main    — a port ``DeviceIndexManager`` with 1M synthetic chunks and 100k
             artifacts plus known rows; 128 planned queries naming them go
             through ``query_both_packed_async`` -> ``collect_packed`` with
             device RRF, unscoped (chunks served "ann") and scoped ("exact").
             Each known row must come first; K1 and K3 must have launched.
6. serve   — the /retrieve request path: 1M chunks + 100k artifacts in the
             process-wide index, matching rows in a temporary SQLite store,
             16 known rows ingested and embedded through the ingest path,
             and the port's aiohttp server on a localhost port, its client
             in a process of its own. 128 concurrent requests a round:
             (a) unique ids_only /retrieve, 2 cold then 10 warm rounds,
             (b) evidence packs, (c) packs scoped to the known rows' call,
             (d) /retrieve/batch of 128, (e) the known rows' queries. Fails on any response but 200, on (a),
             (b) not planning ann or (c) not exact, on a batcher that never
             coalesced, on a known row not first, on K1 or K3 launching no
             time or missing from a torch.profiler window over one round of
             (a). Prints p50/p99 latency and QPS per traffic, the engine's
             timings, its host stages (the engine's own ``retrieve.<stage>``
             spans), serial and pipelined engine QPS; then runs the real
             gate (evals/real_gate.py) on the card against its floors, and
             holds K1 and K3 against their plain versions at the shapes this
             phase launched them with (from its dispatch log: per corpus,
             K1 with and without the dense lane and each query tile, K3 at
             each query width, at the smallest and largest batch served).
             The engine's host stages are read twice, with the native C++
             featurizer (which must have loaded) and with the pure-Python
             one.
6b. writes — on the serve phase's index and store, after a second
             ``startup`` with ``STORE_SYNC_INTERVAL_S`` 0.2 (it reconciles
             the populated index with the store and starts the syncer) and
             the server up again: (1) the port's scanner and worker scripts
             run store-only in child processes over an inbox of 16 bundles,
             one new known row each; the server's syncer brings them onto
             the card; every new known row must come first over HTTP; the
             lag from each job's end to the first answer that holds its row
             is printed. (2) ``DELETE /calls/{id}`` for four of those calls
             and for the eight synthetic calls whose rows the probe queries
             returned most; after each, ids_only and pack answers hold no
             deleted id and ``/index/stats`` counts the tombstones; a second
             DELETE answers 404. K1 and K3 are then held to their plain
             versions on the index's own tensors, tombstones and all.
             (3) under rounds of 128 concurrent /retrieve from the client
             process: ``delete_ids`` tombstones rows up to just under the
             25% threshold of both corpora, then one more DELETE crosses it
             and ``maybe_compact`` compacts both corpora inside that
             request. Prints each compaction's time and peak device memory
             and the longest request latency across it beside the p50.
             Afterwards: tombstones 0, count = live rows, every surviving
             known row first, no deleted id in any answer, 404 for a deleted
             call. (4) K1 and K3 against their plain versions on the
             compacted tensors and at the compacted (ragged) row counts for
             the shapes this phase dispatched; both must have launched.
6d. lifecycle — restart, spill and grow. On the served index, store and
             server, after the writes phase: (1) rounds of evidence packs
             with ``RERANK_ENABLED`` (lexical provider) beside unreranked
             rounds, every reranked answer reporting ``reranked_from``; the
             real gate with ``rerank_provider="lexical"`` against its
             floors. (3) ``save_index`` of the served index, blocking and
             ``block=False``, each under 128 concurrent /retrieve (seconds
             the corpus locks were held, seconds to disk, bytes, the longest
             request); a fresh ``DeviceIndexManager`` restored from it must
             equal the served index array by array, put every known row
             first, and hold K1 and K3 to their plain versions on its
             tensors. (5) the chunks are filled to just under their capacity,
             an insert past ``PREWARM_FILL_FRACTION`` starts the background
             migration toward the planner's capacity, and inserts under
             traffic cross the capacity: the growth must be
             ``index.growth_swap``; afterwards every known row first and K1
             and K3 held on the doubled tensors. On their own stores and
             indexes: (2) ``build_and_apply`` of a 2048-wide vocab head over
             110,000 documents of real text (windows of the checkout's
             sources that no PR of the port edits), every known document
             first, K1 on the re-scattered
             ``lex`` tensor, a restart from a checkpoint through startup's
             digest check with the rows bit-equal, and one through the
             rebuild from the store. (4) an index capped at
             ``INDEX_MAX_DEVICE_ROWS=524288`` takes the index-API phase's
             chunks in their order (the rest in pinned host memory) and
             serves its two batches: every lane must carry the uncapped
             index's ids (a position may differ only where the scores agree
             within 1e-5), every known row first through the index API and
             the engine, a delete and a backfill in the cold tier, the
             host-to-device rate beside a bare pinned copy's, K1 and K3 on a
             block's own staged tensors. Last of all, (5) again with
             ``GROWTH_MIGRATION_ENABLED=0`` on the index-API phase's index
             under a thread that serves its batch: ``index.grow`` and its
             steps timed one by one.
6e. training — on stores of their own, after the models phase: (1) the
             embedder's and the cross-encoder's card-path gradients (bf16
             GEMMs, ``models/embedder.F32Product``) against their plain
             path's on one batch of each gate's recipe; (2) the paraphrase
             gate (``evals/paraphrase_gate.py``) trains on the card at
             ``PARAPHRASE_GATE_KW``, its ms a step beside the step's bound
             (its products at the bf16 peak, AdamW's bytes at the HBM rate),
             the tuned MRR against the stub's and its floors, and the first
             steps' losses beside the same steps on the CPU; (3) the rerank
             gate's training branch (two-register, ``RERANK_GATE_KW``), its
             saved artifact reloaded into
             ``NeuralReranker`` on the card scoring the fixture pairs as the
             trained model did; (4) ``scripts/train_embedder.train`` at its
             CLI defaults over the gate's pairs; (5) the geometry gate at
             1,000,000 rows of the committed embedder's vectors: encode
             texts/s, the ann (K1's dense lane over bf16 rows), int8 and ivf
             recalls, and K1 against its plain version at the shape the gate
             launched it with (64 queries x 1,000,000 rows, dense-only). The
             kernels line's K1 launches include the gate's.
6c. int8    — an index with ``INDEX_EMBEDDING_DTYPE=int8`` (300,037 chunks,
             30,011 artifacts, known rows) serves one batch of 128 through
             the engine: planned ann, every known row first.
             The kernels line's K1 and K3 launches are the serve, the
             writes and the lifecycle phases' together.
7. K2      — ``dense_scan`` against its plain version at batch 128 x 1M rows
             (a contiguous and a random 5% mask) and at a ragged 100,000
             rows, batch 64, with CUDA-event times beside the plain version
             and ``torch.matmul`` of the bf16 product; then every block
             size at 1M rows and ragged / aligned row counts at batch 1-300.
8. recall  — the port's ANN recall gate in-process: modes ann, pallas (K2)
             and ivf at 1M rows, 64 queries, k 10, densities 1.0 and 0.003
             contiguous and 0.05 random; hnsw at 8,192 rows unfiltered (the
             host's graph build; cut from 16,384 to keep the script inside
             its time limit with the harness phase);
             recall under 0.95 fails (ivf under a filter is printed, not
             held); the ann lane's recalls must not fall below the
             port's table (engine/planner.MEASURED_ANN_RECALL, which
             ``notes.retrieval.ann_expected_recall`` answers from) by more
             than one neighbour of a case's 640. Then the
             filtered-recall sweep at 1M rows. K2 must have launched.
9. ivf     — ``build_ivf`` on phase 5's chunks, then one unscoped batch of
             128 planned with ``dense_ivf_enabled``: the planner must choose
             ivf, IVF must serve the chunks' dense lane, and every known
             row must come first (host RRF, as device RRF is off).
10. parallel — row sharding (``parallel/``), on the card. (a) One process,
             ``MESH_SHAPE`` data:2 over ``[cuda:0, cuda:0]``: phase 5's rows
             copied into a sharded index (shards of 524,288 chunk and
             65,536 artifact rows), its batches served through the index
             API with the fused output and every K1/K3 lane bit-identical to
             the unsharded index's for ``ann``, and for ``exact`` the
             lexical and tech lanes bit-identical and the dense lane within
             1e-5, near-ties counted; every known row first, and through
             the engine (ids_only, ann and ivf) the unsharded index's
             answers with every known row first; the batch and
             its halves (shard lanes, gather + merge + RRF) timed beside the
             unsharded program; ivf from phase 9's state with identical ids,
             the sharded build's recall@10 beside the unsharded one's; a
             growth of the artifacts past capacity (rows move between the
             shards) and a v2 save restored into a fresh sharded index,
             answers unchanged. (b) A two-process gang on the one card over
             gloo: this process is the leader (``serve.api.startup`` with
             the ``DIST_*`` settings, ``serve.http``'s app), the follower
             ``python -m cadence_rag_tpu_torch.serve.http`` in a child; 1M +
             100k rows loaded through the leader's index over the op-log
             (seconds and GB/s), the store's rows and the known rows
             ingested; over HTTP ids_only and packs, a DELETE, then a
             compaction of both corpora and ids_only again; a v3 gang save
             restored into one process answers alike (p50/p99/QPS of both);
             the follower exits 0. (c) ``evals/dist_check --device cuda
             --processes 2``. Then K1 and K3 against their plain versions at
             every shard shape the phase launched and timed there; the
             kernels line counts their launches per shard.
10b. model_axis — the ``model`` mesh axis (``parallel/tensor.py``), after
             the earlier phases freed the card, in a child process of its
             own: (1) the Qwen3 4b preset born sharded over data:1,model:2 on
             ``[cuda:0, cuda:0]`` (bytes a position, init seconds), gathered
             equal to the unsharded ``init_params`` bit for bit, a 128 x
             16-token batch tensor-parallel against unsharded on the card
             path (|err| and min cosine within ``QWEN_TP_ATOL`` /
             ``QWEN_TP_MIN_COS``) and both timed at all 36 layers in turns
             beside the bound; (2) the committed embedder dp+tp over
             data:2,model:2 on ``[cuda:0] * 4``, 20 InfoNCE steps of 32 x 48
             tokens beside the unsharded ``train_step`` (each loss, the
             gathered parameters, ms a step); (3)
             ``graft.dryrun_multichip(8)``; (4) 131,072 chunks + 16,384
             artifacts under data:2,model:2 and under data:2: a batch of 128
             in ``ann`` and in ``exact`` with every known row first, K1 and K3
             launched once per data shard a dispatch (not per position), the
             outputs the data:2 index's bit for bit, the engine's ids_only
             answers alike; K1 and K3 against their plain versions at the
             shapes it launched. The kernels line counts its launches as
             ``model_axis``.
11. harness — the measurement and deployment entry points on the card, last
             (after the parallel phase and the synchronous growth), in a
             child process of their own: (1)
             ``evals/serve_bench`` at 1,000,000 chunks, batch 128, ids_only
             with the writer at 500 rows/s and beside it one ``GET /trace``
             of the trace listener (``serve/profiler.py``, as
             ``PROFILER_PORT`` starts it), which must name K1's and K3's
             CUDA kernels, then evidence packs on 2 threads; (2)
             ``evals/host_profile`` at its defaults, 10 iterations, its top
             15 by tottime printed; (3) ``evals/fullstack_profile --trials 2
             --iters 10`` at 1,000,000 rows (iterations cut); (4)
             ``evals/ingest_bench`` at its defaults; (5) ``evals/soak`` for 2.5
             minutes at 60,000 chunks, window 15 s (cut from 10 minutes and
             240,000 chunks), which must grow, compact, rebuild its vocab and
             hold its decay floor and RSS bound; (6) ``scripts/serve_all
             --device cuda`` as a child over a store of its own: /health, a
             dropped bundle answered first, /diagnostics on cuda, a trace of
             the api child's listener naming K1 and K3, SIGTERM, every child
             gone. Then K1 and K3 against their plain versions at every
             shape the phase launched them with, per corpora shape; the
             kernels line counts their launches as ``harness``.
12. probes — the on-card probes (``evals/rtt_probe2``, ``rtt_probe``,
             ``h2d_probe``, ``h2d_probe2``, ``rtt_probe3``, ``cta_ab``,
             ``coldtier_probe``, ``growth_probe``, ``prewarm_probe``,
             ``lane_probe`` and ``lane_probe --probe plane``) at the JAX
             probes' defaults but two cuts (``PROBE_CUTS``), in a child
             process of their own, each one's
             lines printed under a ``probes`` prefix with the card's name
             and power limit. A probe's own check fails the run: the answers
             with ``READBACK_PREFETCH_ENABLED`` off and on differ
             (rtt_probe3), the cold sentinel is not dense top-1
             (coldtier_probe), a row is lost across a growth (growth_probe,
             prewarm_probe), a lane variant's answer disagrees with the
             served lane's, K1's or K3's (lane_probe, at 1,000,000 rows and
             batch 128). Then K1 and K3 against their plain versions at every
             shape the probes dispatched through the index; the kernels line
             counts their launches as ``probes``. ``--phase probes`` runs it
             alone, after the build.

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``. ``--details PATH`` also writes every
measurement (and ptxas's register report) as JSON. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import collections
import contextlib
import json
import logging
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

INT32_MIN = -2147483648
INT32_MAX = 2147483647
N_CALLS = 1024
CHUNK_KS = (50, 50, 50)          # (dense, lexical, tech), engine/retrieve.py
ARTIFACT_KS = (10, 10, 50)
KNOWN_CALL = 7
N_KNOWN = 16
# the writes phase: bundles the worker ingests, calls of those deleted over
# HTTP, synthetic calls deleted over HTTP, and the served syncer's interval
N_BUNDLES = 16
WORKER_DELETES = 4
SYNTHETIC_DELETES = 8
SYNC_INTERVAL_S = 0.2
KNOWN_ID0 = 50_000_000
KNOWN_STARTED = 1_760_000_000    # after every synthetic row: newest call
# K1 tolerances: f32 sums of exact products taken in another order
DENSE_ATOL = 1e-4                # 1024-term sums of |score| <= 1
LEX_ATOL = 1e-3                  # 4096-term sums, |score| up to ~1e2
# published H100 SXM peaks (dense bf16 tensor rate, HBM3 bandwidth)
BF16_PEAK_TFLOPS = 989.0
HBM_PEAK_GBS = 3350.0


def log(msg: str) -> None:
    print(msg, flush=True)


class Details(dict):
    """The run's measurements. ``set_at_s`` keeps the seconds since the
    run began at which each entry was stored: their differences are the
    phases' wall times."""

    def __init__(self, **entries):
        super().__init__(entries, set_at_s={})
        self.t0 = time.perf_counter()

    def __setitem__(self, key, value):
        self["set_at_s"][key] = time.perf_counter() - self.t0
        super().__setitem__(key, value)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- K1 -----------------------------------------------------------------------
def lexical_and_filter_queries(g, device, batch, lex_dim, n_calls):
    """The query side that K1's and K3's checks share: sparse idf-weighted
    lexical queries, as ops/pack._densify rebuilds them, and a real filter
    (half the calls allowed, a date window on odd queries).
    -> (q_lex, allowed, date_min, date_max)"""
    q_lex = torch.zeros((batch, lex_dim), device=device)
    q_lex.scatter_add_(
        1, torch.randint(0, lex_dim, (batch, 64), generator=g, device=device),
        torch.randn((batch, 64), generator=g, device=device) * 0.5)
    allowed = torch.rand((batch, n_calls), generator=g, device=device) < 0.5
    dmin = torch.full((batch,), INT32_MIN + 1, dtype=torch.int32, device=device)
    dmin[1::2] = 1_650_000_000
    dmax = torch.full((batch,), INT32_MAX, dtype=torch.int32, device=device)
    return q_lex, allowed, dmin, dmax


def served_lexical_queries(g, device, batch, lex_dim, feats=46):
    """The served kind of lexical query: ``feats`` signed f16 weights a
    query (the mean feature count of the msmarco-8m cell's questions)
    scatter-added in f32 into lex_dim buckets, as ops/pack._densify
    rebuilds the main path's queries. About a quarter of the queries share
    a bucket, whose sum may need residual pieces: K1's fp16 route, with m
    and l issued in those slabs only."""
    buckets = torch.randint(0, lex_dim, (batch, feats), generator=g, device=device)
    values = torch.exp(torch.randn((batch, feats), generator=g, device=device) - 1.0)
    signs = torch.randint(0, 2, (batch, feats), generator=g, device=device) * 2 - 1
    q = torch.zeros((batch, lex_dim), device=device)
    q.scatter_add_(1, buckets, (values * signs).half().float())
    return q


def k1_inputs(device, n, batch, dim, lex_dim, emb_dtype, seed, lex="f32"):
    """K1's inputs at one shape; ``lex`` "f32" takes the f32 lexical query
    of ``lexical_and_filter_queries`` (off fp16's grid: K1's bf16 route),
    "served" the served kind (``served_lexical_queries``: the fp16 route)."""
    from cadence_rag_tpu_torch.ops.masks import filter_mask

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device=device)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    if emb_dtype == torch.int8:
        emb = torch.clamp(torch.round(x * 127.0), -127, 127).to(torch.int8)
    else:
        emb = x.to(torch.bfloat16)
    rows = torch.randint(0, n, (batch,), generator=g, device=device)
    q_emb = x[rows] + 0.05 * torch.randn((batch, dim), generator=g, device=device)
    q_emb = q_emb / torch.linalg.vector_norm(q_emb, dim=1, keepdim=True)
    del x
    lex_rows = torch.randint(-4, 5, (n, lex_dim), generator=g, device=device,
                             dtype=torch.int8)
    # a real filter: half the calls, a date window on odd queries, 1% of
    # rows invalid, 2% of rows without embeddings
    call_idx = torch.randint(0, N_CALLS, (n,), generator=g, device=device,
                             dtype=torch.int32)
    started = torch.randint(1_600_000_000, 1_750_000_000, (n,), generator=g,
                            device=device, dtype=torch.int32)
    started[torch.rand((n,), generator=g, device=device) < 0.01] = INT32_MIN
    q_lex, allowed, dmin, dmax = lexical_and_filter_queries(
        g, device, batch, lex_dim, N_CALLS)
    if lex == "served":
        q_lex = served_lexical_queries(g, device, batch, lex_dim)
    mask = filter_mask(call_idx, started, allowed, dmin, dmax)
    has_emb = torch.rand((n,), generator=g, device=device) > 0.02
    return q_emb, q_lex, emb, lex_rows, mask, has_emb


def row_scores(q, table, scale, b_idx, rows, slab=8192):
    """f32 score of query ``b_idx[i]`` against table row ``rows[i]``,
    recomputed directly from the inputs (the query already in the kernel's
    precision)."""
    out = torch.empty(b_idx.shape, dtype=torch.float32, device=q.device)
    for s0 in range(0, b_idx.numel(), slab):
        s1 = min(b_idx.numel(), s0 + slab)
        out[s0:s1] = (q[b_idx[s0:s1]] * table[rows[s0:s1]].float()).sum(1) * scale
    return out


def k1_in_group(rows, cand):
    """K1's partition: candidate c holds rows ``(c // 128)*1024 + w*128 +
    c % 128``."""
    from cadence_rag_tpu_torch.ops.fused_scan import BLOCK_ROWS, GROUPS

    return (rows // BLOCK_ROWS == cand // GROUPS) & (rows % GROUPS == cand % GROUPS)


def k1_top50(vals, rows):
    from cadence_rag_tpu_torch.ops.fused_scan import candidate_topk

    return candidate_topk(vals, rows, 50)


def check_lane(kv, ki, pv, pi, lane, atol, threshold=None, *,
               in_group=k1_in_group, top=k1_top50, name="K1"):
    """Kernel vs plain candidates of one lane; every kernel candidate is
    proven, not only counted:

    - values agree within ``atol`` where both are finite; a lexical
      candidate may flip between -inf and a score at the match threshold
      (the f32 sum landing on the other side of 1e-3);
    - each finite kernel candidate's row lies in its own group
      (``in_group``; K1's by default) and passes the lane's mask; a
      candidate that is -inf in both names the same row (its group's
      first);
    - where the kernel's row differs from the plain version's (or only the
      kernel found one), that row's score is recomputed from the inputs:
      it must equal the kernel's value and lie within ``atol`` of the plain
      winner, so the swap is a true near-tie;
    - the lane's final top-k (``top``: K1's top-50 by default) is rescored
      from the inputs the same way.

    ``lane`` = (q, table, scale, keep (B, N) bool, n)."""
    q, table, scale, keep, n = lane
    batch, nc = kv.shape
    finite_k, finite_p = torch.isfinite(kv), torch.isfinite(pv)
    both = finite_k & finite_p
    err = (kv[both] - pv[both]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if max_err > atol:
        raise RuntimeError(f"candidate values differ by {max_err} > {atol}")
    flips = finite_k ^ finite_p
    n_flips = int(flips.sum())
    if n_flips:
        edge = torch.where(finite_k, kv, pv)[flips]
        if threshold is None or float(edge.max()) > threshold + atol:
            raise RuntimeError(f"{n_flips} candidates masked differently")
    rows = ki.long()
    cand = torch.arange(nc, device=kv.device)[None, :]
    inside = (rows >= 0) & (rows < n) & in_group(rows, cand)
    if not bool((inside | ~finite_k).all()):
        raise RuntimeError(f"{int((~inside & finite_k).sum())} kernel "
                           "candidates name a row outside their group")
    empty_moved = int((~finite_k & ~finite_p & (ki != pi)).sum())
    if empty_moved:
        raise RuntimeError(f"{empty_moved} all-masked groups name another row "
                           "than the plain version's")
    passes = keep.gather(1, rows.clamp(0, n - 1))
    if not bool((passes | ~finite_k).all()):
        raise RuntimeError(f"{int((~passes & finite_k).sum())} kernel "
                           "candidates name a row the lane's mask excludes")
    differ = finite_k & ((ki != pi) | ~finite_p)
    n_differ = int(differ.sum())
    if n_differ > batch * nc // 100:
        raise RuntimeError(f"{n_differ} candidate rows differ from the plain "
                           "version: too many to be near-ties")
    rescore_err = 0.0
    if n_differ:
        b_idx, c_idx = differ.nonzero(as_tuple=True)
        got = row_scores(q, table, scale, b_idx, rows[b_idx, c_idx])
        rescore_err = float((got - kv[b_idx, c_idx]).abs().max())
        plain_at = pv[b_idx, c_idx]
        fin = torch.isfinite(plain_at)
        gap = float((got[fin] - plain_at[fin]).abs().max()) if bool(fin.any()) else 0.0
        if rescore_err > atol or gap > atol:
            raise RuntimeError(
                f"kernel rows that differ from the plain version score "
                f"{rescore_err} from the kernel's value, {gap} from the "
                f"plain winner (tol {atol}): not near-ties")
    # the lane's final top-k, as its caller takes it
    k_vals, k_pos = top(kv, ki)
    p_vals, p_pos = top(pv, pi)
    fin = torch.isfinite(p_vals)
    if not torch.equal(fin, torch.isfinite(k_vals)) or float(
            (k_vals[fin] - p_vals[fin]).abs().max()) > atol:
        raise RuntimeError(f"{name} top-k values disagree with the plain version")
    b_idx, j_idx = torch.isfinite(k_vals).nonzero(as_tuple=True)
    top_rows = k_pos[b_idx, j_idx]
    top_err = float((row_scores(q, table, scale, b_idx, top_rows)
                     - k_vals[b_idx, j_idx]).abs().max())
    if top_err > atol or not bool(keep[b_idx, top_rows].all()):
        raise RuntimeError(f"{name} top-k rows rescore {top_err} from their "
                           f"values (tol {atol}) or fail the lane's mask")
    return {"max_abs_err": max_err, "rescore_err": max(rescore_err, top_err),
            "near_tie_rows": n_differ, "threshold_flips": n_flips,
            "top_id_diffs": int((k_pos != p_pos).sum())}


def k1_route(device, fn):
    """Run ``fn`` (one K1 launch) -> (its result, {"route", "pieces"}: the
    route and the lexical pieces a K slab K1 counted on the card for it)."""
    from cadence_rag_tpu_torch.ops.fused_scan import route_counts

    before = route_counts(device)
    out = fn()
    delta = {k: v - before[k] for k, v in route_counts(device).items()}
    if delta["bf16"] + delta["fp16"] != 1:
        raise RuntimeError(f"K1 counted {delta} for one launch")
    return out, {"route": "fp16" if delta["fp16"] else "bf16",
                 "pieces": delta["pieces"] / delta["slabs"]}


def check_k1(device, n, batch, dim, lex_dim, emb_dtype, seed, reps, dense=True,
             lex="f32"):
    """``fused_scan`` against ``fused_scan_plain`` at one shape, both lanes
    (or the lexical lane alone, ``dense`` False, as ``exact`` mode runs
    it), for the lexical query kind ``lex`` (``k1_inputs``: "f32" takes
    K1's bf16 route, "served" its fp16 route); with ``reps`` > 0 (dense
    only) also timed. The route and the pieces a K slab K1 counted for the
    checked launch are returned beside the check."""
    from cadence_rag_tpu_torch.ops.fused_scan import (
        fused_scan, fused_scan_plain, n_candidates,
    )
    from cadence_rag_tpu_torch.ops.lexical import LEX_MATCH_THRESHOLD

    args = k1_inputs(device, n, batch, dim, lex_dim, emb_dtype, seed, lex)
    q_emb, q_lex, emb, lex_rows, mask, has_emb = args
    got, issued = k1_route(device, lambda: fused_scan(*args, dense=dense))
    want_route = "fp16" if lex == "served" else "bf16"
    if issued["route"] != want_route:
        raise RuntimeError(f"K1 took the {issued['route']} route for the {lex} "
                           f"lexical query, not {want_route}")
    torch.cuda.synchronize()
    want = fused_scan_plain(*args, dense=dense)
    nc = n_candidates(n)
    if got[2].shape != (batch, nc) or want[2].shape != (batch, nc):
        raise RuntimeError(f"candidate shape {tuple(got[2].shape)} != {(batch, nc)}")
    lexical = check_lane(
        got[2], got[3], want[2], want[3], (q_lex.float(), lex_rows, 1.0, mask, n),
        LEX_ATOL, LEX_MATCH_THRESHOLD)
    if not dense:
        del got, want, args
        torch.cuda.empty_cache()
        return {"n": n, "batch": batch, "emb_dtype": str(emb_dtype), "dense": None,
                "lex_query": lex, **issued,
                "lex": lexical, "max_abs_err": lexical["max_abs_err"]}
    scale = 1.0 / 127.0 if emb_dtype == torch.int8 else 1.0
    dense = check_lane(
        got[0], got[1], want[0], want[1],
        (q_emb.to(torch.bfloat16).float(), emb, scale,
         mask & has_emb[None, :], n), DENSE_ATOL)
    del got, want
    if not reps:
        del args
        torch.cuda.empty_cache()
        return {"n": n, "batch": batch, "emb_dtype": str(emb_dtype), "dense": dense,
                "lex_query": lex, **issued, "lex": lexical,
                "max_abs_err": max(dense["max_abs_err"], lexical["max_abs_err"])}
    ms = cuda_ms(lambda: fused_scan(*args, dense=True), reps)
    plain_ms = cuda_ms(lambda: fused_scan_plain(*args, dense=True), 1)
    lex_only_ms = cuda_ms(lambda: fused_scan(*args, dense=False), reps)
    # useful work; the tensor work with the lexical pieces K1 issued
    # counted; the bytes the call must read from device memory
    gflop = 2.0 * batch * n * (dim + lex_dim) / 1e9
    tensor_gflop = 2.0 * batch * n * (dim + issued["pieces"] * lex_dim) / 1e9
    gbytes = (n * (dim * emb.element_size() + lex_dim + 1) + batch * n) / 1e9
    result = {
        "n": n, "batch": batch, "dim": dim, "lex_dim": lex_dim,
        "emb_dtype": str(emb_dtype), "lex_query": lex, **issued,
        "dense": dense, "lex": lexical,
        "max_abs_err": max(dense["max_abs_err"], lexical["max_abs_err"]),
        "ms": ms, "plain_ms": plain_ms, "lex_only_ms": lex_only_ms,
        "tflops": gflop / ms, "tensor_tflops": tensor_gflop / ms,
        "tensor_share": tensor_gflop / ms / BF16_PEAK_TFLOPS,
        "gbs": gbytes / ms * 1e3, "hbm_share": gbytes / ms * 1e3 / HBM_PEAK_GBS,
        # the least time: the bytes once at the HBM rate, or the useful
        # products at the bf16 tensor rate, whichever is larger
        "bound_ms": max(gbytes / HBM_PEAK_GBS * 1e3, gflop / BF16_PEAK_TFLOPS),
        "bound_by": ("bytes" if gbytes / HBM_PEAK_GBS * 1e3 >= gflop / BF16_PEAK_TFLOPS
                     else "operations"),
    }
    log(f"K1 fused_scan n={n} batch={batch} {emb_dtype}, {lex} lexical query "
        f"({issued['route']} route, {issued['pieces']:.3f} lexical pieces a K slab): "
        f"kernel {ms:.3f} ms (bound {result['bound_ms']:.3f} ms by {result['bound_by']}; "
        f"{gflop / ms:.2f} TFLOP/s useful; {tensor_gflop / ms:.2f} TFLOP/s of "
        f"tensor work with the pieces issued, {result['tensor_share']:.1%} "
        f"of {BF16_PEAK_TFLOPS:.0f}; {result['gbs']:.0f} GB/s, "
        f"{result['hbm_share']:.1%} of {HBM_PEAK_GBS:.0f}), lexical-only "
        f"{lex_only_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; max |err| dense {dense['max_abs_err']:.3g} "
        f"(tol {DENSE_ATOL}) lex {lexical['max_abs_err']:.3g} (tol {LEX_ATOL}); "
        f"rows rescored from the inputs within {max(dense['rescore_err'], lexical['rescore_err']):.3g}; "
        f"near-tie rows {dense['near_tie_rows']}/{lexical['near_tie_rows']} "
        f"of {batch * nc}, threshold flips {lexical['threshold_flips']}, "
        f"top-50 id diffs {dense['top_id_diffs']}/{lexical['top_id_diffs']}")
    del args
    torch.cuda.empty_cache()
    return result


def ptxas_report(text):
    """ptxas's verbose output -> one record per compiled kernel: its
    registers per thread at entry and its spill bytes."""
    report, name, spills = [], None, (0, 0)
    for ln in text.splitlines():
        found = re.search(r"Function properties for \S*?([a-z_]+_kernel)(\w*)", ln)
        if found:
            name = found.group(1)
            args = re.match(r"ILi(\d+)E(?:(13__nv_bfloat16|a)E)?", found.group(2))
            if args and args.group(2):
                name += f"<{args.group(1)}, {'bf16' if args.group(2) != 'a' else 'int8'}>"
            elif args:
                name += f"<{args.group(1)}>"
            spills = (0, 0)
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if found:
            spills = (int(found.group(1)), int(found.group(2)))
            continue
        found = re.search(r"Used (\d+) registers", ln)
        if found and name:
            report.append({"kernel": name, "registers": int(found.group(1)),
                           "spill_stores": spills[0], "spill_loads": spills[1]})
            name = None
    return report


# -- K3 -----------------------------------------------------------------------
K3_DENSITIES = ("none", "smoke", "dense")
K3_KS = (1, 10, 50)              # and ops/tech_keys.MAX_K
# H100 SXM int32 rate: 64 int32 lanes per SM per clock x 132 SMs x 1.98 GHz
INT32_PEAK_TOPS = 16.7


def k3_inputs(device, n, batch, slots, density, seed, capacity=1):
    """Tech slots, start seconds (every row of a call shares one: ties are
    the normal case), ``capacity`` query structures per query, each copied
    from a random row with half its columns empty, and a 90% mask.
    ``density``: "none" — the queries' tokens are held by no row; "smoke" —
    a few matches per 1024 rows; "dense" — the first 30% of rows hold a
    token half the queries ask for, so those ranges hold more than k
    matches, and a few start seconds read as -inf or as a NaN below it.
    -> (q, tech, started, mask)"""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tech = torch.randint(1, 5000, (n, slots), generator=g, device=device,
                         dtype=torch.int32)
    call_start = torch.randint(1_600_000_000, 1_750_000_000, (N_CALLS,),
                               generator=g, device=device, dtype=torch.int32)
    started = call_start[torch.randint(0, N_CALLS, (n,), generator=g,
                                       device=device)]
    started[torch.rand((n,), generator=g, device=device) < 0.01] = INT32_MIN
    src = torch.randint(0, n, (batch, capacity), generator=g, device=device)
    q = tech[src].reshape(batch, capacity * slots).contiguous()
    q[torch.rand(q.shape, generator=g, device=device) < 0.5] = 0
    if density == "none":
        q[q != 0] += 5000
    elif density == "dense":
        tech[: int(0.3 * n), 0] = 7
        q[::2, 0] = 7
        odd = torch.rand((n,), generator=g, device=device)
        started[odd < 0.001] = -8388608      # the bits of -inf
        started[odd > 0.999] = -5            # a NaN below -inf
    mask = (torch.rand((batch, n), generator=g, device=device) < 0.9) & (
        started != INT32_MIN)[None, :]
    return q, tech, started, mask


def check_k3_case(q, tech, started, mask, k):
    """The kernel's per-range top-ks against ``range_topk_plain`` (the same
    k keys per range), and the lane against ``tech_topk_plain``: values (as
    bits) and rows identical, in order. -> finite entries of the lane"""
    from cadence_rag_tpu_torch.ops.tech_keys import (
        range_topk, range_topk_plain, tech_topk_keys, tech_topk_plain,
    )

    got = range_topk(q, tech, started, mask, k)
    want = range_topk_plain(q, tech, started, mask, k)
    batch = q.shape[0]
    if got.shape != want.shape or not torch.equal(
            got.view(batch, -1, k).sort(-1).values,
            want.view(batch, -1, k).sort(-1).values):
        raise RuntimeError(f"K3 per-range top-{k} keys differ from the plain "
                           f"version ({q.shape[0]} x {tech.shape[0]})")
    del got, want
    g_vals, g_rows = tech_topk_keys(tech, started, q, mask, k)
    p_vals, p_rows = tech_topk_plain(tech, started, q, mask, k)
    if not (torch.equal(g_rows, p_rows) and torch.equal(
            g_vals.view(torch.int32), p_vals.view(torch.int32))):
        raise RuntimeError(f"K3 lane (k {k}) differs from the plain version")
    return int(torch.isfinite(p_vals).sum())


def k3_timing(device, n, batch, slots, capacity, seed, reps):
    """K3's CUDA-event times at chip_smoke's traffic ("smoke"), k 50, with
    ``capacity`` structures a query, beside its plain version and its bound."""
    from cadence_rag_tpu_torch.ops.tech_keys import (
        n_candidates, range_topk, range_topk_plain, tech_topk_keys,
    )
    from cadence_rag_tpu_torch.ops.techlane import tech_match
    from cadence_rag_tpu_torch.ops.topk import topk_from_keys

    nc = n_candidates(n, 50)
    q, tech, started, mask = k3_inputs(device, n, batch, slots, "smoke", seed,
                                       capacity=capacity)
    cand = range_topk(q, tech, started, mask, 50)
    matches = int((tech_match(tech, q) & mask).sum())
    # the bytes the kernel must move: slots and start seconds once, the
    # mask bytes of the matching pairs, the query structures, the
    # candidates; the operations: one compare per row and nonzero query
    # column (a zero column matches nothing and needs none)
    gbytes = (n * slots * 4 + n * 4 + matches + q.numel() * 4 + batch * nc * 8) / 1e9
    compares = n * int((q != 0).sum())
    bytes_ms = gbytes / HBM_PEAK_GBS * 1e3
    ops_ms = compares / (INT32_PEAK_TOPS * 1e12) * 1e3
    out = {
        "n": n, "batch": batch, "width": capacity * slots,
        "ms": cuda_ms(lambda: range_topk(q, tech, started, mask, 50), reps),
        "lane_ms": cuda_ms(lambda: tech_topk_keys(tech, started, q, mask, 50), reps),
        "final_topk_ms": cuda_ms(lambda: topk_from_keys(cand, 50), reps),
        "plain_ms": cuda_ms(lambda: range_topk_plain(q, tech, started, mask, 50), 1),
        "matches": matches, "compares": compares,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
    }
    del q, tech, started, mask, cand
    torch.cuda.empty_cache()
    return out


def check_k3(device, n, batch, slots, seed, reps):
    """Every density x k at batch x n, then a ragged n, batch 1, batch 200
    and two structures per query; then times at chip_smoke's traffic
    ("smoke"), k 50, with one structure per query (16 wide) and two (32
    wide, the main path's chunk queries). The kernels line reports the
    32-wide times."""
    from cadence_rag_tpu_torch.ops.tech_keys import MAX_K

    cases = []
    for density in K3_DENSITIES:
        args = k3_inputs(device, n, batch, slots, density, seed)
        for k in (*K3_KS, MAX_K):
            cases.append({"n": n, "batch": batch, "density": density, "k": k,
                          "capacity": 1, "finite": check_k3_case(*args, k)})
        del args
    for nn, bb, cap in ((n - 12_345, batch, 1), (n, 1, 1), (n, 200, 1), (n, batch, 2)):
        args = k3_inputs(device, nn, bb, slots, "smoke", seed + 1, capacity=cap)
        cases.append({"n": nn, "batch": bb, "density": "smoke", "k": 50,
                      "capacity": cap, "finite": check_k3_case(*args, 50)})
        del args
    torch.cuda.empty_cache()
    timing = {cap * slots: k3_timing(device, n, batch, slots, cap, seed, reps)
              for cap in (1, 2)}
    t16, t32 = timing[slots], timing[2 * slots]
    log(f"K3 tech lane n={n} batch={batch} slots={slots}: {len(cases)} cases "
        "(densities none/smoke/dense x k 1/10/50/64, ragged n, batch 1 and 200, "
        f"two structures a query) bit-identical to the plain lane (finite entries "
        f"{[c['finite'] for c in cases]}); at chip_smoke traffic, k 50, width 16 "
        f"({t16['matches']} matching pairs): kernel {t16['ms']:.3f} ms (bound "
        f"{t16['bound_ms']:.3f} ms by {t16['bound_by']}), final topk "
        f"{t16['final_topk_ms']:.3f} ms, lane {t16['lane_ms']:.3f} ms, plain "
        f"{t16['plain_ms']:.3f} ms; width 32, the main path's ({t32['matches']} "
        f"pairs): kernel {t32['ms']:.3f} ms (bound {t32['bound_ms']:.3f} ms by "
        f"{t32['bound_by']}), final topk {t32['final_topk_ms']:.3f} ms, lane "
        f"{t32['lane_ms']:.3f} ms, plain {t32['plain_ms']:.3f} ms")
    return {"n": n, "batch": batch, "slots": slots, "cases": cases,
            "timing": timing, "ms": t32["ms"], "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "max_abs_err": 0.0}


# -- K1 and K3 at the served path's shapes ------------------------------------
def k1_tile(batch):
    """The queries a K1 CTA holds, which picks its compiled instantiation
    (csrc/fused_scan.cu ``launch_for_batch``)."""
    return 64 if batch <= 64 else 128 if batch <= 128 else 256


def served_cases(dispatched):
    """The kernel shapes the served path launched, from the serve phase's
    dispatch log: per corpus, K1's dense flag and query tile, and K3's
    query width and K1's tile, each with the smallest and the largest
    batch served. -> (K1 cases [(corpus, dense, batch)], K3 cases
    [(corpus, width, batch)])"""
    k1, k3 = {}, {}
    for chunk_mode, artifact_mode, batch, dense_on, width in dispatched:
        for corpus, mode in (("chunks", chunk_mode), ("artifacts", artifact_mode)):
            k1.setdefault((corpus, dense_on and mode == "ann", k1_tile(batch)),
                          set()).add(batch)
            k3.setdefault((corpus, width, k1_tile(batch)), set()).add(batch)
    return tuple(sorted({(key[0], key[1], b) for key, sizes in cases.items()
                         for b in (min(sizes), max(sizes))})
                 for cases in (k1, k3))


def check_served_shapes(device, dispatched, corpora, seed):
    """K1 (both lanes in ``ann``, the lexical lane alone in ``exact``) and
    K3 against their plain versions at every served case of
    ``served_cases``, on inputs of each corpus's device shape
    (``corpora``: {corpus: rows, dim, lex_dim, slots, emb_dtype}); K1 for
    the served kind of lexical query (its fp16 route) and an f32 one (its
    bf16 route)."""
    k1_cases, k3_cases = served_cases(dispatched)
    k1, k3 = [], []
    for i, (corpus, dense, batch) in enumerate(k1_cases):
        c = corpora[corpus]
        for lex in ("served", "f32"):
            got = check_k1(device, c["rows"], batch, c["dim"], c["lex_dim"],
                           c["emb_dtype"], seed=seed + i, reps=0, dense=dense, lex=lex)
            k1.append({"corpus": corpus, "dense_lane": dense, **got})
    for i, (corpus, width, batch) in enumerate(k3_cases):
        c = corpora[corpus]
        args = k3_inputs(device, c["rows"], batch, c["slots"], "smoke",
                         seed + 100 + i, capacity=width // c["slots"])
        k3.append({"corpus": corpus, "width": width, "batch": batch, "n": c["rows"],
                   "finite": check_k3_case(*args, min(50, c["rows"]))})
        del args
    torch.cuda.empty_cache()
    log("served shapes: K1 against its plain version at "
        + ", ".join(f"{r['corpus']} {r['n']} rows batch {r['batch']} "
                    f"{'dense+lexical' if r['dense_lane'] else 'lexical only'} "
                    f"{r['lex_query']} query ({r['route']}, {r['pieces']:.3f} pieces) "
                    f"(|err| {r['max_abs_err']:.3g})" for r in k1)
        + "; K3 bit-identical at "
        + ", ".join(f"{r['corpus']} {r['n']} rows batch {r['batch']} width "
                    f"{r['width']}" for r in k3))
    return {"k1": k1, "k3": k3,
            "k1_max_abs_err": max((r["max_abs_err"] for r in k1), default=0.0)}


# -- K2 -----------------------------------------------------------------------
def k2_inputs(device, n, batch, dim, mask_kind, seed):
    """Unit bf16 rows, queries near random rows, and a 5% mask: one
    contiguous window per query (a date or call filter) or random rows."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device=device)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    rows = x.to(torch.bfloat16)
    src = torch.randint(0, n, (batch,), generator=g, device=device)
    q = x[src] + 0.05 * torch.randn((batch, dim), generator=g, device=device)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    del x
    m = int(0.05 * n)
    if mask_kind == "contiguous":
        start = torch.randint(0, n - m + 1, (batch, 1), generator=g, device=device)
        cols = torch.arange(n, device=device)[None, :]
        mask = (cols >= start) & (cols < start + m)
    else:
        mask = torch.rand((batch, n), generator=g, device=device) < 0.05
    return q, rows, mask


def check_k2(device, n, batch, dim, mask_kind, seed, reps, block_n=None,
             timed=True):
    from cadence_rag_tpu_torch.ops.dense_scan import (
        DEFAULT_BLOCK_N, LANE, candidate_topk, dense_scan, dense_scan_plain,
        n_candidates,
    )

    block_n = block_n or DEFAULT_BLOCK_N
    width = block_n // LANE
    args = k2_inputs(device, n, batch, dim, mask_kind, seed)
    q, rows, mask = args
    got = dense_scan(*args, block_n=block_n)
    torch.cuda.synchronize()
    want = dense_scan_plain(*args, block_n=block_n)
    nc = n_candidates(n, block_n)
    if got[0].shape != (batch, nc) or want[0].shape != (batch, nc):
        raise RuntimeError(f"K2 candidate shape {tuple(got[0].shape)} != {(batch, nc)}")
    stats = check_lane(
        got[0], got[1], want[0], want[1],
        (q.to(torch.bfloat16).float(), rows, 1.0, mask, n), DENSE_ATOL,
        in_group=lambda r, c: ((r // block_n == c // LANE)
                               & ((r % block_n) // width == c % LANE)),
        top=lambda v, i: candidate_topk(v, i, 10), name="K2")
    del got, want
    result = {"n": n, "batch": batch, "dim": dim, "mask": mask_kind,
              "block_n": block_n, **stats}
    if timed:
        ms = cuda_ms(lambda: dense_scan(*args, block_n=block_n), reps)
        plain_ms = cuda_ms(lambda: dense_scan_plain(*args, block_n=block_n), 2)
        # the library call that computes K2's arithmetic (the bf16 product),
        # not its masked group max
        q16 = q.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: torch.matmul(q16, rows.T), reps)
        gflop = 2.0 * batch * n * dim / 1e9
        gbytes = (n * dim * 2 + batch * n + batch * dim * 2 + batch * nc * 8) / 1e9
        bytes_ms = gbytes / HBM_PEAK_GBS * 1e3
        ops_ms = gflop / BF16_PEAK_TFLOPS
        result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      tflops=gflop / ms, gbs=gbytes / ms * 1e3,
                      bound_ms=max(bytes_ms, ops_ms),
                      bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        log(f"K2 dense_scan n={n} batch={batch} mask={mask_kind} 5% block_n={block_n}: "
            f"kernel {ms:.3f} ms ({gflop / ms:.2f} TFLOP/s, {result['gbs']:.0f} GB/s; "
            f"bound {result['bound_ms']:.3f} ms by {result['bound_by']}), plain "
            f"{plain_ms:.3f} ms, torch.matmul of the bf16 product alone "
            f"{library_ms:.3f} ms (CUDA events); max |err| {stats['max_abs_err']:.3g} "
            f"(tol {DENSE_ATOL}); rows rescored from the inputs within "
            f"{stats['rescore_err']:.3g}; near-tie rows {stats['near_tie_rows']} of "
            f"{batch * nc}; top-10 id diffs {stats['top_id_diffs']}")
    del args
    torch.cuda.empty_cache()
    return result


def check_k2_shapes(device, dim, seed):
    """K2 at every block size (widths 2..16) at 1M rows and batch 128, then
    ragged and grid-aligned row counts at batch 1, 64, 128 and 300, each
    held to the plain version as ``check_k2`` holds it."""
    from cadence_rag_tpu_torch.ops.dense_scan import MAX_BLOCK_N, MIN_BLOCK_N

    cases = []
    for block_n in range(MIN_BLOCK_N, MAX_BLOCK_N + 1, 128):
        cases.append(check_k2(device, 1_048_576, 128, dim, "random", seed + block_n,
                              0, block_n=block_n, timed=False))
    for n, batch, block_n in ((100_003, 1, 384), (65_536, 64, 1024),
                              (99_999, 128, 1280), (131_072, 300, 2048),
                              (70_001, 300, 1920)):
        cases.append(check_k2(device, n, batch, dim, "contiguous", seed + n,
                              0, block_n=block_n, timed=False))
    log(f"K2 shapes: every block_n 256..2048 at 1M rows, batch 128, and "
        f"{len(cases) - 15} ragged / aligned shapes at batch 1-300 match the plain "
        f"version (max |err| {max(c['max_abs_err'] for c in cases):.3g}, tol "
        f"{DENSE_ATOL}; near-tie rows {sum(c['near_tie_rows'] for c in cases)}, "
        f"top-10 id diffs {sum(c['top_id_diffs'] for c in cases)})")
    return cases


# -- the recall gate and the filtered sweep -----------------------------------
GATE_CASES = ((1.0, "contiguous"), (0.003, "contiguous"), (0.05, "random"))
HNSW_N = 8_192
MIN_RECALL = 0.95


def run_recall(device, n, n_queries, k, hnsw_n, sweep_n, sweep_rounds,
               cases=GATE_CASES):
    """The port's recall gate in-process: modes ann, pallas and ivf at n
    rows for each (density, mask shape) case, hnsw at hnsw_n rows
    unfiltered, then the
    filtered-recall sweep at sweep_n rows. A recall under MIN_RECALL fails,
    as the gate's CLI exits 1 — except ivf under a filter, whose probes
    ignore the mask: that recall is printed, not held."""
    import contextlib
    import io

    from cadence_rag_tpu_torch.evals.ann_recall_gate import (
        gen_docs, make_queries, mode_topk, recall_from_arrays,
    )
    from cadence_rag_tpu_torch.evals.filtered_recall_sweep import run_sweep

    docs = gen_docs(n, n_centers=max(64, n // 64), seed=0, device=device)
    inputs = {case: make_queries(docs, n_queries, seed=0, density=case[0],
                                 mask_shape=case[1]) for case in cases}
    rows, misses = [], []
    for mode in ("ann", "pallas", "ivf"):
        t0 = time.perf_counter()
        fn = mode_topk(mode, docs, k=k)
        if device.type == "cuda":
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for (density, shape), (queries, mask_row) in inputs.items():
            got = recall_from_arrays(docs, queries, mask_row, mode, k=k,
                                     batch=n_queries, topk_fn=fn)
            held = not (mode == "ivf" and density < 1.0)
            rows.append({"mode": mode, "n": n, "density": density,
                         "mask": shape, "recall_at_k": got["recall_at_k"],
                         "held": held, "ms": got["mode_ms"],
                         "build_s": build_s, "hits": n_queries * k})
            if held and got["recall_at_k"] < MIN_RECALL:
                misses.append(rows[-1])
    del docs, fn
    hnsw_docs = gen_docs(hnsw_n, n_centers=max(64, hnsw_n // 64), seed=0,
                         device=device)
    queries, mask_row = make_queries(hnsw_docs, n_queries, seed=0,
                                     density=1.0, mask_shape="contiguous")
    t0 = time.perf_counter()
    fn = mode_topk("hnsw", hnsw_docs, k=k)
    build_s = time.perf_counter() - t0
    got = recall_from_arrays(hnsw_docs, queries, mask_row, "hnsw", k=k,
                             batch=n_queries, topk_fn=fn)
    rows.append({"mode": "hnsw", "n": hnsw_n, "density": 1.0,
                 "mask": "contiguous", "recall_at_k": got["recall_at_k"],
                 "held": True, "ms": got["mode_ms"], "build_s": build_s})
    if got["recall_at_k"] < MIN_RECALL:
        misses.append(rows[-1])
    del hnsw_docs, fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log("recall@%d (%d queries): " % (k, n_queries) + "; ".join(
        f"{r['mode']} n={r['n']} {r['mask']} {r['density']}: "
        f"{r['recall_at_k']:.4f}{'' if r['held'] else ' (not held)'} "
        f"in {r['ms']:.1f} ms" for r in rows))
    if misses:
        raise RuntimeError(f"recall under {MIN_RECALL}: {misses}")
    with contextlib.redirect_stdout(io.StringIO()):
        sweep = run_sweep(n=sweep_n, batch=32, k=k,
                          densities=[0.003, 0.01, 0.05, 0.25, 1.0],
                          targets=[0.95], mask_shapes=["contiguous", "random"],
                          rounds=sweep_rounds, device=device)
    log(f"sweep n={sweep_n} batch 32, {sweep_rounds} rounds (ann lane vs "
        "masked exact): " + "; ".join(
            f"{r['mask']} {r['density']}: {r['recall_at_k']:.4f} "
            f"({r['approx_ms']:.2f} vs {r['exact_ms']:.2f} ms)" for r in sweep))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"gate": rows, "sweep": sweep}


def check_recall_table(gate_rows, card):
    """The ann lane's recalls of this run against the port's committed table
    (engine/planner.MEASURED_ANN_RECALL, which ``ann_expected_recall``
    answers from): the table must not promise more than the card delivers.
    One neighbour of the case's queries x k may differ (a tie taken in
    another order); the gate itself holds the 0.95 floor."""
    from cadence_rag_tpu_torch.engine.planner import (
        MEASURED_ANN_RECALL, expected_recall_for_ef_search,
    )

    ann = [r for r in gate_rows if r["mode"] == "ann"]
    measured = {(r["density"], r["mask"]): r["recall_at_k"] for r in ann}
    one_hit = 1.0 / ann[0]["hits"]
    low = [(case, measured.get(case), promised)
           for case, promised in MEASURED_ANN_RECALL
           if measured.get(case) is None or measured[case] < promised - one_hit - 1e-9]
    if low:
        raise RuntimeError(f"the ann lane's recall fell below the port's table "
                           f"(case, measured, table): {low}")
    log(f"ann recall table ({card}): measured "
        + ", ".join(f"{case} {measured[case]:.4f} (table {promised:.4f})"
                    for case, promised in MEASURED_ANN_RECALL)
        + f"; ann_expected_recall answers {expected_recall_for_ef_search(80):.4f} "
        "for every ef_search")
    return {"measured": {str(k): v for k, v in measured.items()},
            "expected": expected_recall_for_ef_search(80)}


# -- main path ----------------------------------------------------------------
KNOWN_TEXT = ("incident {i}: kafka consumer lag on broker-{i} after the "
              "gateway upgrade to v3.{i}.7 caused ECONNRESET storms")


def known_rows(n_known):
    """The known rows' texts and tech tokens -> (texts, tokens)."""
    texts = [KNOWN_TEXT.format(i=i) for i in range(n_known)]
    tokens = [[f"broker-{i}", f"v3.{i}.7"] for i in range(n_known)]
    return texts, tokens


def build_index(device, n_chunks, n_artifacts, n_known):
    """A port index with synthetic corpora plus ``n_known`` real chunk rows
    (featurized and embedded the way ingest does). -> (index, texts, tokens)"""
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager
    from cadence_rag_tpu_torch.evals.synth import (
        insert_text_rows, install_synthetic_corpus,
    )

    index = DeviceIndexManager(device)
    index.ensure_call_capacity(N_CALLS)
    install_synthetic_corpus(index.chunks, n_chunks, N_CALLS, seed=0)
    install_synthetic_corpus(index.artifacts, n_artifacts, N_CALLS, seed=1)
    texts, tokens = known_rows(n_known)
    insert_text_rows(index.chunks, texts, tokens, doc_id0=KNOWN_ID0,
                     call_seq=KNOWN_CALL, started0=KNOWN_STARTED)
    return index, texts, tokens


def plan_batch(index, texts, tokens, batch, scoped):
    """``batch`` queries naming the known rows, planned by the port; a
    scoped batch allows only the known rows' call.
    -> (positional args, modes, expected ids)"""
    from cadence_rag_tpu_torch.evals.synth import plan_text_queries

    which = [j % len(texts) for j in range(batch)]
    allowed = np.ones((batch, index.call_capacity), dtype=bool)
    if scoped:
        allowed[:] = False
        allowed[:, KNOWN_CALL] = True
    args, modes = plan_text_queries(
        index, [texts[i] for i in which], [tokens[i] for i in which], allowed,
        scoped=scoped)
    expected = np.array([KNOWN_ID0 + i for i in which], dtype=np.int64)
    return args, modes, expected


def serve_batch(index, args, modes):
    disp = index.query_both_packed_async(
        *args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS,
        chunk_mode=modes[0], artifact_mode=modes[1], recall_target=0.95,
        fuse_rrf=True)
    return index.collect_packed(disp)


def check_first(out, expected, what):
    ids, scores, masks, counts = out[0]["__rrf__"]
    if ids.shape[0] != expected.shape[0] or not (counts > 0).all():
        raise RuntimeError(f"{what}: empty fused chunk rows")
    if not np.isfinite(scores[:, 0]).all():
        raise RuntimeError(f"{what}: non-finite fused scores")
    wrong = np.flatnonzero(ids[:, 0] != expected)
    if wrong.size:
        raise RuntimeError(
            f"{what}: known row not first for {wrong.size} queries, e.g. "
            f"query {wrong[0]} got {ids[wrong[0], :3]} want {expected[wrong[0]]}")
    a_ids, _a_scores, _a_masks, a_counts = out[1]["__rrf__"]
    if a_ids.shape[0] != expected.shape[0]:
        raise RuntimeError(f"{what}: artifact rows missing")
    return float(scores[:, 0].mean()), int(masks[0, 0])


def check_first_lanes(out, expected, what):
    """Per-lane output (device RRF off): the host RRF merge of the chunks'
    lanes, and the dense lane itself, must put each known row first."""
    from cadence_rag_tpu_torch.ops.fusion import rrf_merge_rect

    chunks = out[0]
    merged = rrf_merge_rect({"bm25": chunks["lex"], "tech_tokens": chunks["tech"],
                             "dense": chunks["dense"]})
    first = np.array([ids[0] if ids.size else -1 for ids, *_ in merged])
    dense_first = np.where(chunks["dense"][2] > 0, chunks["dense"][0][:, 0], -1)
    for got, lane in ((first, "fused"), (dense_first, "dense")):
        wrong = np.flatnonzero(got != expected)
        if wrong.size:
            raise RuntimeError(
                f"{what}: known row not first in the {lane} list for "
                f"{wrong.size} queries, e.g. query {wrong[0]} got "
                f"{got[wrong[0]]} want {expected[wrong[0]]}")


def run_ivf_batch(index, texts, tokens, batch):
    """Build the chunks' IVF index, plan one unscoped batch with
    ``dense_ivf_enabled`` set (the planner must choose ivf) and serve it:
    the chunks' dense lane must be served by IVF and every known row must
    come first. -> (planned modes, args, summary)"""
    from cadence_rag_tpu_torch.config import settings

    t0 = time.perf_counter()
    state = index.chunks.build_ivf()
    if index.device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    enabled = settings.dense_ivf_enabled
    settings.dense_ivf_enabled = True
    try:
        args, modes, expected = plan_batch(index, texts, tokens, batch, False)
    finally:
        settings.dense_ivf_enabled = enabled
    if modes[0] != "ivf":
        raise RuntimeError(f"planner chose {modes[0]!r} for the chunks, not ivf")
    disp = index.query_both_packed_async(
        *args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS, chunk_mode=modes[0],
        artifact_mode=modes[1], recall_target=0.95, fuse_rrf=True)
    out = index.collect_packed(disp)
    if disp.served_chunk_mode != "ivf":
        raise RuntimeError(f"chunks served {disp.served_chunk_mode!r}, not ivf")
    check_first_lanes(out, expected, "ivf")
    return modes, args, {
        "build_s": build_s, "n_clusters": state.n_clusters,
        "nprobe": state.nprobe, "built_count": state.built_count,
        "overflow_count": state.overflow_count,
        "bucket_cap": int(state.buckets.shape[1]), "modes": modes,
    }


def run_main_path(device, n_chunks, n_artifacts, batch, n_known):
    """Build, plan, and serve one unscoped and one scoped batch.
    -> (index, batches [(name, args, modes, expected)], summary)"""
    t0 = time.perf_counter()
    index, texts, tokens = build_index(device, n_chunks, n_artifacts, n_known)
    setup_s = time.perf_counter() - t0
    batches = []
    summary = {"setup_s": setup_s}
    for name, scoped in (("unscoped", False), ("scoped", True)):
        args, modes, expected = plan_batch(index, texts, tokens, batch, scoped)
        out = serve_batch(index, args, modes)
        top_score, top_lanes = check_first(out, expected, name)
        summary[name] = {"modes": modes, "top_fused_mean": top_score,
                         "top_lane_mask": top_lanes}
        batches.append((name, args, modes, expected))
    return index, batches, summary


# -- serve: the /retrieve request path over HTTP ------------------------------
# the bench's request shapes (bench.py:170-175), one query text per request
SERVE_TEMPLATES = (
    "ECONNRESET rollback on the object store gateway build {}",
    "tiering latency cluster retry budget shard {}",
    "lenovo bake-off azure rollout phase {}",
    "v2.3.{} gateway retry",
)
# known rows for the served path: each has tech tokens of its own (v3.i.7,
# OPS-41xx), so its query's tech lane matches it alone
SERVE_KNOWN_TEXT = ("incident {i}: kafka consumer lag on the gateway after the "
                    "upgrade to v3.{i}.7, tracked in OPS-{t}")
KERNEL_NAMES = {"fused_scan": "fused_scan_kernel", "tech_topk": "tech_topk_kernel"}
GATE_FLOORS = {"mrr": 0.60, "recall@20": 0.80, "ndcg@10": 0.70}


def unique_queries(n, salt):
    """n query texts in the bench's shapes, unique across rounds (``salt``),
    so no request coalesces with another."""
    return [SERVE_TEMPLATES[i % 4].format(salt * 100_000 + i // 4) for i in range(n)]


class DispatchLog:
    """Records (chunk mode, artifact mode, batch, dense lane on, tech query
    width) of every dispatch the engine makes through
    ``index.query_both_packed_async``."""

    def __init__(self, index):
        self.calls = []
        inner = index.query_both_packed_async

        def recording(*args, **kw):
            self.calls.append((kw["chunk_mode"], kw["artifact_mode"], args[2].shape[0],
                               args[0] is not None, args[2].shape[1]))
            return inner(*args, **kw)

        index.query_both_packed_async = recording

    def take(self):
        calls, self.calls = self.calls, []
        return calls


class BatchSizes(logging.Handler):
    """The batcher's ``retrieve.batched size=N`` records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.sizes = []

    def emit(self, record):
        if record.msg.startswith("retrieve.batched"):
            self.sizes.append(int(record.args[0]))


def start_server():
    """The port's aiohttp app on a free localhost port, served from a
    thread of its own. -> (port, stop)"""
    from aiohttp import web

    from cadence_rag_tpu_torch.serve.http import make_app

    loop = asyncio.new_event_loop()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    runner = web.AppRunner(make_app(), access_log=None)
    ready = threading.Event()
    failed = []

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(runner.setup())
            loop.run_until_complete(web.SockSite(runner, sock).start())
        except Exception as exc:  # reported by the caller
            failed.append(exc)
            ready.set()
            return
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    thread = threading.Thread(target=run, name="serve", daemon=True)
    thread.start()
    if not ready.wait(60) or failed:
        raise RuntimeError(f"the server did not start: {failed}")

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        sock.close()
        if thread.is_alive():
            raise RuntimeError("the server thread did not stop")

    return sock.getsockname()[1], stop


# the HTTP client, run in a process of its own so that it does not share the
# server's interpreter lock: argv = port, path, requests file, results file;
# the requests file holds one list of bodies per round
HTTP_CLIENT = r"""
import asyncio, json, sys, time
import aiohttp

port, path, src, dst = sys.argv[1:5]
url = f"http://127.0.0.1:{port}{path}"
with open(src) as f:
    rounds = json.load(f)

async def one(session, body):
    t0 = time.perf_counter()
    async with session.post(url, json=body) as resp:
        data = await resp.json()
        return resp.status, time.perf_counter() - t0, data

async def go():
    out = []
    async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=0)) as session:
        for bodies in rounds:
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(session, b) for b in bodies))
            out.append((time.perf_counter() - t0, res))
    return out

with open(dst, "w") as f:
    json.dump(asyncio.run(go()), f)
"""


def http_rounds(port, path, bodies_of_round, rounds, workdir):
    """Send each round's bodies concurrently from a client process over one
    session. -> [(round wall s, [(status, latency s, response)])]"""
    src, dst = workdir / "requests.json", workdir / "responses.json"
    src.write_text(json.dumps([bodies_of_round(r) for r in range(rounds)]))
    proc = subprocess.run([sys.executable, "-c", HTTP_CLIENT, str(port), path,
                           str(src), str(dst)], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"HTTP client failed: {proc.stderr[-2000:]}")
    out = json.loads(dst.read_text())
    bad = [(s, d) for _w, res in out for s, _l, d in res if s != 200]
    if bad:
        raise RuntimeError(f"{path}: {len(bad)} responses not 200, e.g. {bad[0]}")
    return out


def round_stats(rounds, per_call=1):
    """Latency percentiles of every request and QPS over the rounds
    (``per_call`` requests answered by each call)."""
    lat = np.array([l for _w, res in rounds for _s, l, _d in res]) * 1e3
    wall = sum(w for w, _res in rounds)
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "qps": per_call * lat.size / wall, "requests": per_call * int(lat.size)}


def ingest_known_rows(n_known):
    """One call whose transcript holds the known texts, one chunk each,
    through the ingest path, plus an analysis artifact; then the backfill
    embeds that call's rows. -> (call_id, texts, chunk ids)"""
    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu_torch.ingest.ingest import ingest_analysis, ingest_transcript
    from cadence_rag_tpu_torch.schemas import (
        AnalysisArtifactIn, CallRef, ChunkingOptions, UtteranceIn,
    )
    from cadence_rag_tpu_torch.store.db import get_store

    texts = [SERVE_KNOWN_TEXT.format(i=i, t=4100 + i) for i in range(n_known)]
    call_id, _n_utt, n_chunks = ingest_transcript(
        CallRef(external_id="smoke-known", title="known rows"),
        [UtteranceIn(speaker="Ana", start_ts_ms=i * 1000, end_ts_ms=i * 1000 + 900,
                     text=t) for i, t in enumerate(texts)],
        ChunkingOptions(target_tokens=8, max_tokens=400, overlap_tokens=0))
    if n_chunks != n_known:
        raise RuntimeError(f"known rows: {n_chunks} chunks for {n_known} texts")
    ingest_analysis(CallRef(call_id=call_id), [AnalysisArtifactIn(
        kind="summary", content="Known rows for the served path's checks.")])
    run_embedding_backfill(batch_size=64, call_id=call_id, source="chip_smoke")
    with get_store().read() as conn:
        ids = [int(r["chunk_id"]) for r in conn.execute(
            "SELECT chunk_id FROM chunks WHERE call_id = ? ORDER BY chunk_id",
            (call_id,)).fetchall()]
    return call_id, texts, ids


def engine_split(payloads_of_rep, reps):
    """The engine's own ``retrieve.<stage>`` spans (engine/retrieve.py, in
    the event ring) over ``reps`` calls of ``retrieve_evidence_batch``
    after a warm one. -> {stage: mean ms}"""
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.utils import events

    retrieve_evidence_batch(payloads_of_rep(0))
    events.enable()
    try:
        for rep in range(1, reps + 1):
            retrieve_evidence_batch(payloads_of_rep(rep))
        spans = events.drain()
    finally:
        events.disable()
    stages = {}
    for ev in spans:
        if ev["tag"].startswith("retrieve.") and "s" in ev:
            stages.setdefault(ev["tag"][len("retrieve."):], []).append(ev["s"] * 1e3)
    return {name: float(np.mean(ms)) for name, ms in stages.items()}


def engine_qps(payloads_of_rep, iters, depth=None):
    """``retrieve_evidence_batch`` serially, or ``retrieve_evidence_pipelined``
    at ``depth``, as bench.py:205-266 measures -> QPS."""
    from cadence_rag_tpu_torch.engine.retrieve import (
        retrieve_evidence_batch, retrieve_evidence_pipelined,
    )

    batches = [payloads_of_rep(r) for r in range(iters)]
    retrieve_evidence_batch(batches[0])
    t0 = time.perf_counter()
    if depth is None:
        n = sum(len(retrieve_evidence_batch(b)) for b in batches)
    else:
        n = sum(len(out) for out in retrieve_evidence_pipelined(batches, depth=depth))
    return n / (time.perf_counter() - t0)


def kernel_device_ms(prof):
    """{kernel key: device ms} of every kernel row of a profile."""
    rows = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0 and not e.key.startswith(("aten::", "cuda")):
            rows[e.key] = rows.get(e.key, 0.0) + dt / 1e3
    return rows


def run_serve(device, n_chunks, n_artifacts, concurrency=128, cold_rounds=2,
              warm_rounds=20, bench_iters=10, profile=True, window_ms=5,
              write_rounds=40, lifecycle_rounds=10, models_preset="4b"):
    """The port's /retrieve request path: an index of ``n_chunks`` +
    ``n_artifacts`` synthetic rows on ``device`` with matching rows in a
    temporary SQLite store, the known rows ingested and embedded through
    the ingest path, and the port's aiohttp server in this process, the
    client in a process of its own. Traffic:
    (a) ``concurrency`` concurrent unique ids_only POST /retrieve, cold then
    warm rounds; (b) the same as evidence packs; (c) evidence packs scoped
    to the known rows' call; (d) POST /retrieve/batch of ``concurrency``;
    (e) the known rows' own queries. Checks: no response but 200; (a), (b)
    plan ann and (c) exact; the batcher coalesced; every known row first;
    with ``profile``, K1 and K3 in a torch.profiler window over one round
    of (a). Then the engine's host split, serial and pipelined QPS, and
    the real gate on ``device``, after the ``writes`` phase
    (``run_writes``), the lifecycle steps (``run_lifecycle_served``) and the
    models phase's served steps (``run_models_served``, the Qwen3 encoder
    at ``models_preset``) on the same index and store. -> summary"""
    import tempfile

    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.evals.synth import (
        bulk_store_rows, install_synthetic_corpus,
    )
    from cadence_rag_tpu_torch.ingest import featurize
    from cadence_rag_tpu_torch.ingest.sync import reset_syncer
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk
    from cadence_rag_tpu_torch.schemas import RetrieveRequest
    from cadence_rag_tpu_torch.serve.api import startup
    from cadence_rag_tpu_torch.store.db import get_store, reset_store

    device = torch.device(device)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    overrides = {"store_path": str(workdir / "serve.db"),
                 "embeddings_provider": "stub", "embeddings_base_url": "",
                 "retrieve_batch_window_ms": window_ms, "store_sync_interval_s": 0.0,
                 "ingest_root_dir": str(workdir / "ingest"),
                 "ingest_single_file_min_age_s": 0, "log_level": "WARNING"}
    saved = {key: getattr(settings, key) for key in overrides}
    for key, value in overrides.items():
        setattr(settings, key, value)
    batcher_log = logging.getLogger("cadence_rag_tpu_torch.serve.batcher")
    sizes = BatchSizes()
    batcher_log.addHandler(sizes)
    batcher_log.setLevel(logging.INFO)
    batcher_log.propagate = False
    stop = None
    summary = {}
    try:
        setup = {}
        t0 = time.perf_counter()
        reset_store()
        core_index.reset_index()
        reset_syncer()
        if not featurize.native_available():
            raise RuntimeError("the native featurizer (native/lexhash.cpp) did "
                               "not build or load: g++ is needed")
        index = core_index.get_index(device)
        index.ensure_call_capacity(N_CALLS)
        install_synthetic_corpus(index.chunks, n_chunks, N_CALLS, seed=0)
        install_synthetic_corpus(index.artifacts, n_artifacts, N_CALLS, seed=1)
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup["index"] = time.perf_counter() - t0
        with get_store().read() as conn:
            # a page cache that holds the bulk rows' transaction: pages are
            # written once at commit, not spilled to the log as it fills
            conn.execute("PRAGMA cache_size = -1048576")
        bulk_store_rows(get_store(), n_chunks, n_artifacts, N_CALLS)
        setup["store rows"] = time.perf_counter() - t0 - sum(setup.values())
        known_call, known_texts, known_ids = ingest_known_rows(N_KNOWN)
        setup["known rows"] = time.perf_counter() - t0 - sum(setup.values())
        startup(device)
        dispatches = DispatchLog(index)
        port, stop = start_server()
        setup["startup + server"] = time.perf_counter() - t0 - sum(setup.values())
        summary["setup_s"] = time.perf_counter() - t0
        summary["setup_split_s"] = setup

        fused_scan.launches = 0
        range_topk.launches = 0
        ids_only = lambda r: [{"query": q, "return_style": "ids_only"}
                              for q in unique_queries(concurrency, r)]
        packs = lambda r: [{"query": q} for q in unique_queries(concurrency, r)]
        scoped = lambda r: [{"query": f"{known_texts[i % N_KNOWN]} round {r} q{i}",
                             "filters": {"call_ids": [known_call]}}
                            for i in range(concurrency)]
        phases = {}
        salt = 0

        def traffic(name, path, make, rounds, per_call=1):
            nonlocal salt
            base = salt
            salt += rounds
            dispatches.take()
            del sizes.sizes[:]
            out = http_rounds(port, path, lambda r: make(base + r), rounds, workdir)
            phases[name] = {"dispatches": dispatches.take(),
                            "batched": list(sizes.sizes)}
            return out

        traffic("a_cold", "/retrieve", ids_only, cold_rounds)
        a = traffic("a", "/retrieve", ids_only, warm_rounds)
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                round_s = traffic("a_profiled", "/retrieve", ids_only, 1)[0][0]
                torch.cuda.synchronize()
            kernels = kernel_device_ms(prof)
            seen = {name: sum(ms for key, ms in kernels.items() if needle in key)
                    for name, needle in KERNEL_NAMES.items()}
            # the server is idle outside the round: its kernels over its wall
            summary["profiled_round"] = {
                "wall_ms": round_s * 1e3, "kernel_ms": sum(kernels.values()),
                "busy_share": sum(kernels.values()) / (round_s * 1e3),
                "k1_ms": seen["fused_scan"], "k3_ms": seen["tech_topk"],
                "top": sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}
            if min(seen.values()) <= 0:
                raise RuntimeError(f"the profiled round shows no K1 or K3: {seen}")
        traffic("b_cold", "/retrieve", packs, 1)
        b = traffic("b", "/retrieve", packs, warm_rounds)
        c = traffic("c", "/retrieve", scoped, warm_rounds)
        d = traffic("d", "/retrieve/batch", lambda r: [ids_only(r)], warm_rounds)
        e = traffic("e", "/retrieve", lambda r: [
            {"query": t, "return_style": "ids_only"} for t in known_texts], 1)
        # launches of the kernels on the served path (the CPU runs their
        # plain versions and counts none)
        launches = {"fused_scan": fused_scan.launches, "tech_topk": range_topk.launches}
        stop()
        stop = None

        # checks
        want = [f"chunk:{i}" for i in known_ids]
        got = [res[2]["retrieved_ids"][:1] for res in e[0][1]]
        wrong = [(w, g) for w, g in zip(want, got) if g != [w]]
        if wrong:
            raise RuntimeError(f"known rows not first: {len(wrong)}, e.g. {wrong[0]}")
        for _w, res in c:
            for i, (_s, _l, data) in enumerate(res):
                top = data["quotes"][0]["chunk_id"] if data["quotes"] else None
                if top != known_ids[i % N_KNOWN]:
                    raise RuntimeError(f"scoped: known row not first: {top}")
        planned = {"a": {"ann"}, "b": {"ann"}, "c": {"exact"}, "d": {"ann"},
                   "e": {"ann"}}
        for name, modes in planned.items():
            got_modes = {m for cm, am, *_ in phases[name]["dispatches"] for m in (cm, am)}
            if got_modes != modes:
                raise RuntimeError(f"({name}) dispatched {got_modes}, not {modes}")
        for name, rounds, mode in (("b", b, "ann"), ("c", c, "exact")):
            notes = {tuple(d_["notes"]["retrieval"]["dense_modes"].values())
                     for _w, res in rounds for _s, _l, d_ in res}
            if notes != {(mode, mode)}:
                raise RuntimeError(f"({name}) notes.dense_modes {notes}")
        empty = sum(not d_["quotes"] for _w, res in b for _s, _l, d_ in res)
        if empty:
            raise RuntimeError(f"(b) {empty} evidence packs without quotes")
        coalesced = max((size for name in "abcde" for size in phases[name]["batched"]),
                        default=0)
        if coalesced <= 1:
            raise RuntimeError("the batcher never coalesced requests")
        timings = [d_["notes"]["retrieval"]["timings_ms"]
                   for _w, res in b for _s, _l, d_ in res]
        summary.update(
            launches=launches, known_first=len(want),
            a=round_stats(a), b=round_stats(b), c=round_stats(c),
            d=round_stats(d, per_call=concurrency),
            batch_sizes={name: sorted(set(b_ for _cm, _am, b_, *_ in ph["dispatches"]))
                         for name, ph in phases.items()},
            dispatched=sorted({d_ for ph in phases.values() for d_ in ph["dispatches"]}),
            corpora={name: {"rows": corpus.capacity, "dim": corpus.dim,
                            "lex_dim": corpus.lex_dim, "slots": corpus.tech.shape[1],
                            "emb_dtype": corpus.emb_dtype}
                     for name, corpus in (("chunks", index.chunks),
                                          ("artifacts", index.artifacts))},
            batched_max=coalesced,
            engine_timings_ms={key: float(np.mean([t[key] for t in timings]))
                               for key in ("embed_ms", "device_ms", "pack_ms",
                                           "device_batch")})

        # the engine in-process: host split, serial and pipelined QPS
        reqs = lambda style: (lambda r: [
            RetrieveRequest(query=q, return_style=style)
            for q in unique_queries(concurrency, 10_000 + r)])
        summary["split_ids_only"] = engine_split(reqs("ids_only"), 5)
        # the same stages with the pure-Python featurizer (ops/hashing.py)
        native, featurize._native = featurize._native, lambda: None
        try:
            summary["split_ids_only_python"] = engine_split(reqs("ids_only"), 5)
        finally:
            featurize._native = native
        summary["split_packs"] = engine_split(reqs("evidence_pack_json"), 5)
        summary["split_scoped"] = engine_split(lambda r: [
            RetrieveRequest.model_validate(body) for body in scoped(10_000 + r)], 5)
        summary["engine_qps"] = {
            f"{style} {'serial' if depth is None else f'depth {depth}'}":
                engine_qps(reqs(style), bench_iters, depth)
            for style in ("ids_only", "evidence_pack_json")
            for depth in (None, 2, 3)}
        summary["writes"] = run_writes(
            device, index, workdir, dispatches, known_texts, known_ids,
            n_chunks, n_artifacts, concurrency=concurrency,
            traffic_rounds=write_rounds)
        summary["lifecycle"] = run_lifecycle_served(
            device, index, workdir, dispatches,
            summary["writes"]["compaction"]["survivors"], concurrency=concurrency,
            rounds=lifecycle_rounds, traffic_rounds=max(write_rounds // 3, 5))
        summary["models"] = run_models_served(
            device, index, workdir, dispatches, preset=models_preset,
            concurrency=concurrency, rounds=lifecycle_rounds)
    finally:
        if stop is not None:
            stop()
        reset_syncer()
        batcher_log.removeHandler(sizes)
        batcher_log.propagate = True
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        core_index.reset_index()
        shutil.rmtree(workdir, ignore_errors=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    from cadence_rag_tpu_torch.evals.real_gate import run_gate

    for key, kwargs in (("gate", {}), ("gate_reranked", {"rerank_provider": "lexical"})):
        outcome = run_gate(device=device, **kwargs)
        summary[key] = outcome["metrics"]
        low = {k: outcome["metrics"][k] for k, floor in GATE_FLOORS.items()
               if outcome["metrics"][k] < floor}
        if low or outcome["failures"]:
            raise RuntimeError(
                f"real {key} under its floors: {low} {outcome['failures']}")
    return summary


# -- writes: worker -> syncer -> served, deletes, compaction under traffic -------
WRITE_KNOWN_TEXT = ("postmortem {i}: the billing ledger replica fell behind after "
                    "the failover to v4.{i}.9, tracked in OPS-{t}")
# a child process of the port's scripts: no jax and no JAX package either
CHILD = r"""
import runpy, sys
for name in ("jax", "jaxlib", "cadence_rag_tpu"):
    sys.modules[name] = None
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__")
"""
CHILD_SETTINGS = ("store_path", "ingest_root_dir", "ingest_single_file_min_age_s",
                  "embeddings_provider", "embeddings_base_url", "embeddings_dim",
                  "lexical_dim", "tech_hash_slots", "tech_slot_capacity",
                  "index_initial_capacity", "log_level")


def child_env():
    """The environment of a child running one of the port's scripts: this
    process's settings for the store, the inbox and the widths."""
    from cadence_rag_tpu_torch.config import settings

    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for name in CHILD_SETTINGS:
        env[name.upper()] = str(getattr(settings, name))
    return env


def http_json(port, method, path, body=None, timeout=120):
    """One request from this process -> (status, JSON body)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        None if body is None else json.dumps(body).encode(),
        {"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"null")


def wait_for(check, what, timeout=120.0, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = check()
        if got:
            return got
        time.sleep(every)
    raise RuntimeError(f"timed out after {timeout:.0f} s waiting for {what}")


def answer_ids(data):
    """(chunk ids, artifact chunk ids) a /retrieve answer names, ids_only
    or evidence pack."""
    chunks, artifacts = set(), set()
    for evidence in data.get("retrieved_ids", []):
        kind, _, num = evidence.partition(":")
        (chunks if kind == "chunk" else artifacts).add(int(num))
    chunks.update(q["chunk_id"] for q in data.get("quotes", []))
    artifacts.update(a["artifact_chunk_id"] for a in data.get("artifacts", []))
    return chunks, artifacts


def run_under_traffic(port, workdir, dispatches, name, action, bodies_of_round,
                      rounds):
    """Run ``action`` while the client process sends rounds of concurrent
    /retrieve requests: batches of ``rounds`` rounds, one after another,
    until the action has ended. -> (rounds, action's result, its start and
    end in seconds after the traffic's start)"""
    box = {"rounds": []}
    done = threading.Event()

    def send():
        try:
            sent = 0
            while True:
                box["rounds"] += http_rounds(
                    port, "/retrieve", lambda r: bodies_of_round(sent + r), rounds,
                    workdir)
                sent += rounds
                if done.is_set():
                    return
        except Exception as exc:
            box["error"] = exc

    sender = threading.Thread(target=send, name=name)
    served = len(dispatches.calls)
    box["t0"] = time.time()
    sender.start()
    try:
        # the client is up and its second round has been dispatched
        wait_for(lambda: "error" in box or len(dispatches.calls) > served + 1,
                 "the client's traffic")
        began = time.time()
        result = action()
        ended = time.time()
    finally:
        done.set()
        sender.join(900)
    box["t1"] = time.time()
    if "error" in box:
        raise box["error"]
    if not (box["t0"] < began and ended < box["t1"]):
        raise RuntimeError(f"{name}: the traffic ended before the write did")
    return box["rounds"], result, (began - box["t0"], ended - box["t0"])


def traffic_latency(rounds):
    lat = np.array([l for _w, res_ in rounds for _s, l, _d in res_]) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()), "requests": int(lat.size),
            "longest_round_ms": max(w for w, _r in rounds) * 1e3}


class CompactLog:
    """Times every ``CorpusIndex.compact`` (host clock around the device's
    work, synchronised) and reads the peak device memory across it."""

    def __init__(self, index_module):
        self.records = []
        self.cls = index_module.CorpusIndex
        self.inner = inner = self.cls.compact
        log = self

        def compact(corpus):
            cuda = corpus.device.type == "cuda"
            rows = corpus.count
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            inner(corpus)
            if cuda:
                torch.cuda.synchronize()
            log.records.append({
                "corpus": corpus.name, "at": time.time(),
                "seconds": time.perf_counter() - t0, "rows_before": rows,
                "rows_after": corpus.count, "capacity": corpus.capacity,
                "held_bytes": held if cuda else None,
                "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None})

        self.cls.compact = compact

    def close(self):
        self.cls.compact = self.inner


def check_kernels_on_corpus(corpus, n_calls, batch, seed):
    """K1 (both lanes) and K3 against their plain versions on the corpus's
    own device tensors as they stand (tombstoned rows, a compacted ragged
    count under the capacity), for ``batch`` seeded queries under a real
    filter; K1 for an f32 lexical query (its bf16 route) and the served kind
    (``served_lexical_queries``, its fp16 route). check_lane also proves
    that no candidate names a row the mask excludes, so no tombstoned row
    is ever a candidate."""
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan, fused_scan_plain
    from cadence_rag_tpu_torch.ops.lexical import LEX_MATCH_THRESHOLD
    from cadence_rag_tpu_torch.ops.masks import filter_mask

    dev = corpus.device
    with corpus.lock:
        emb, lex, tech, call_idx, started, has_emb = corpus.device_arrays()
        count = corpus.count
    n = emb.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    scale = 1.0 / 127.0 if emb.dtype == torch.int8 else 1.0
    src = torch.randint(0, max(count, 1), (batch,), generator=g, device=dev)
    q_emb = emb[src].float() * scale + 0.05 * torch.randn(
        (batch, emb.shape[1]), generator=g, device=dev)
    q_emb = q_emb / torch.linalg.vector_norm(q_emb, dim=1, keepdim=True)
    q_lex, allowed, dmin, dmax = lexical_and_filter_queries(
        g, dev, batch, lex.shape[1], n_calls)
    mask = filter_mask(call_idx, started, allowed, dmin, dmax)
    errs, routes = [], {}
    for kind, q in (("f32", q_lex),
                    ("served", served_lexical_queries(g, dev, batch, lex.shape[1]))):
        args = (q_emb, q, emb, lex, mask, has_emb)
        if dev.type == "cuda":
            got, routes[kind] = k1_route(dev, lambda: fused_scan(*args, dense=True))
        else:
            got = fused_scan(*args, dense=True)
        want = fused_scan_plain(*args, dense=True)
        lexical = check_lane(got[2], got[3], want[2], want[3],
                             (q, lex, 1.0, mask, n), LEX_ATOL, LEX_MATCH_THRESHOLD)
        dense = check_lane(got[0], got[1], want[0], want[1],
                           (q_emb.to(torch.bfloat16).float(), emb, scale,
                            mask & has_emb[None, :], n), DENSE_ATOL)
        errs += [dense["max_abs_err"], lexical["max_abs_err"]]
        del got, want, args
    if routes and (routes["f32"]["route"], routes["served"]["route"]) != ("bf16", "fp16"):
        raise RuntimeError(f"K1's routes for the f32 and the served query: {routes}")
    q_tech = tech[src].clone()
    q_tech[torch.rand(q_tech.shape, generator=g, device=dev) < 0.5] = 0
    finite = check_k3_case(q_tech, tech, started, mask, min(50, n))
    live = int((started[:count] != INT32_MIN).sum())
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"corpus": corpus.name, "rows": n, "count": count, "live": live,
            "batch": batch, "k3_finite": finite, "k1_routes": routes,
            "max_abs_err": max(errs)}


def run_writes(device, index, workdir, dispatches, known_texts, known_ids,
               n_chunks, n_artifacts, concurrency=128, traffic_rounds=40):
    """The write side on the serve phase's index and store (see the module
    docstring, phase 6b). -> summary"""
    from collections import Counter
    from datetime import datetime

    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk
    from cadence_rag_tpu_torch.serve.api import startup
    from cadence_rag_tpu_torch.store.db import get_store

    out = {}
    launches = Counter()

    def take_launches():
        launches.update(fused_scan=fused_scan.launches, tech_topk=range_topk.launches)
        fused_scan.launches = 0
        range_topk.launches = 0

    def stats():
        status, data = http_json(port, "GET", "/index/stats")
        if status != 200:
            raise RuntimeError(f"/index/stats answered {status}")
        return data

    settings.store_sync_interval_s = SYNC_INTERVAL_S
    t0 = time.perf_counter()
    startup(device)               # reconciles the populated index, starts the syncer
    out["startup_s"] = time.perf_counter() - t0
    port, stop = start_server()
    compactions = CompactLog(core_index)
    worker = None
    dispatches.take()
    fused_scan.launches = 0
    range_topk.launches = 0
    try:
        rows0 = stats()
        # 1. a worker's writes reach the served index through the syncer
        inbox = Path(settings.ingest_root_dir) / "inbox"
        texts = [WRITE_KNOWN_TEXT.format(i=i, t=5200 + i) for i in range(N_BUNDLES)]
        for i, text in enumerate(texts):
            bundle = inbox / f"smoke-bundle-{i:02d}"
            bundle.mkdir(parents=True)
            (bundle / "transcript.json").write_text(json.dumps([
                {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 900, "text": text}]))
            (bundle / "_READY").touch()
        env = child_env()
        scan = subprocess.run(
            [sys.executable, "-c", CHILD,
             "cadence_rag_tpu_torch.scripts.ingest_scanner", "--once"],
            env=env, capture_output=True, text=True, timeout=300)
        if scan.returncode != 0:
            raise RuntimeError(f"the scanner failed: {scan.stderr[-2000:]}")
        seen, poll_errors = [], []
        polling = threading.Event()
        new_queries = [{"query": t, "return_style": "ids_only"} for t in texts]

        def poll():
            while not polling.is_set():
                status, data = http_json(port, "POST", "/retrieve/batch", new_queries)
                if status != 200:
                    poll_errors.append((status, data))
                    return
                seen.append((time.time(), [r["retrieved_ids"][:1]
                                           for r in data["results"]]))
                polling.wait(0.02)

        poller = threading.Thread(target=poll, name="poll", daemon=True)
        poller.start()
        t_worker = time.perf_counter()
        worker = subprocess.Popen(
            [sys.executable, "-c", CHILD,
             "cadence_rag_tpu_torch.scripts.ingest_worker", "--idle-sleep", "0.05"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

        def jobs_done():
            if worker.poll() is not None:
                raise RuntimeError(f"the worker died: {worker.stderr.read()[-2000:]}")
            _s, data = http_json(port, "GET", "/ingest/jobs?limit=200")
            bad = [j for j in data["items"] if j["status"] in ("failed", "invalid")]
            if bad:
                raise RuntimeError(f"ingest job failed: {bad[0]}")
            done = [j for j in data["items"] if j["status"] == "succeeded"]
            return done if len(done) == N_BUNDLES else None

        jobs = wait_for(jobs_done, "the worker's jobs", timeout=300)
        out["worker_s"] = time.perf_counter() - t_worker
        worker.terminate()
        worker.wait(timeout=60)
        worker = None
        with get_store().read() as conn:
            new_ids = {r["call_id"]: int(r["chunk_id"]) for r in conn.execute(
                "SELECT call_id, chunk_id FROM chunks WHERE call_id IN (%s)"
                % ",".join("?" * len(jobs)), [j["call_id"] for j in jobs])}
        by_bundle = {j["bundle_id"]: j for j in jobs}
        new_rows = []                 # per bundle: (call id, chunk id, job end s)
        for i in range(N_BUNDLES):
            job = by_bundle[f"smoke-bundle-{i:02d}"]
            new_rows.append((job["call_id"], new_ids[job["call_id"]],
                             datetime.fromisoformat(job["finished_at"]).timestamp(),
                             datetime.fromisoformat(job["started_at"]).timestamp()))

        def synced():
            data = stats()
            sync = data["sync"]
            return data if (sync["applied_seq"] >= sync["store_seq"]
                            and data["chunks"]["count"]
                            == rows0["chunks"]["count"] + N_BUNDLES) else None

        rows1 = wait_for(synced, "the syncer to reach the store's sequence")
        want_first = [[f"chunk:{row[1]}"] for row in new_rows]
        wait_for(lambda: poll_errors or (seen and seen[-1][1] == want_first),
                 "every synced row to come first")
        polling.set()
        poller.join(60)
        if poll_errors:
            raise RuntimeError(f"/retrieve/batch answered {poll_errors[0]}")
        first_seen = [min(t for t, firsts in seen if firsts[i] == want_first[i])
                      for i in range(N_BUNDLES)]
        lag_end = [first_seen[i] - new_rows[i][2] for i in range(N_BUNDLES)]
        lag_start = [first_seen[i] - new_rows[i][3] for i in range(N_BUNDLES)]
        res = http_rounds(port, "/retrieve", lambda r: new_queries, 1, workdir)
        got = [d["retrieved_ids"][:1] for _s, _l, d in res[0][1]]
        if got != want_first:
            raise RuntimeError(f"synced rows not first over HTTP: {got} != {want_first}")
        out["sync"] = {
            "bundles": N_BUNDLES, "applied_seq": rows1["sync"]["applied_seq"],
            "interval_s": SYNC_INTERVAL_S, "polls": len(seen),
            "lag_from_job_end_s": {"min": min(lag_end), "p50": float(np.median(lag_end)),
                                   "max": max(lag_end)},
            "lag_from_job_start_s": {"p50": float(np.median(lag_start)),
                                     "max": max(lag_start)}}

        # 2. DELETE over HTTP: some of the worker's calls, and the synthetic
        # calls whose rows the probe queries return most
        probes = [{"query": q, "return_style": "ids_only"}
                  for q in unique_queries(64, 777)]
        packs = [{"query": b["query"]} for b in probes[:16]]
        _s, data = http_json(port, "POST", "/retrieve/batch", probes)
        returned = Counter((c - 1) % N_CALLS for r in data["results"]
                           for c in answer_ids(r)[0] if c <= n_chunks)
        synthetic = [s_ for s_, _n in returned.most_common(SYNTHETIC_DELETES)]
        if len(synthetic) < SYNTHETIC_DELETES:
            raise RuntimeError("the probe queries returned too few synthetic calls")
        call_uuid = lambda s_: f"00000000-0000-4000-8000-{s_:012d}"
        call_rows = lambda s_: (set(range(s_ + 1, n_chunks + 1, N_CALLS)),
                                set(range(s_ + 1, n_artifacts + 1, N_CALLS)))
        targets = [(row[0], {row[1]}, set()) for row in new_rows[:WORKER_DELETES]]
        targets += [(call_uuid(s_), *call_rows(s_)) for s_ in synthetic]
        gone_chunks, gone_artifacts, delete_ms = set(), set(), []

        def assert_none_deleted(results, what):
            for r in results:
                chunks, artifacts = answer_ids(r)
                if chunks & gone_chunks or artifacts & gone_artifacts:
                    raise RuntimeError(
                        f"{what}: an answer holds a deleted id: "
                        f"{sorted(chunks & gone_chunks)[:3]} "
                        f"{sorted(artifacts & gone_artifacts)[:3]}")

        for call_id, chunks, artifacts in targets:
            t = time.perf_counter()
            status, body = http_json(port, "DELETE", f"/calls/{call_id}")
            delete_ms.append((time.perf_counter() - t) * 1e3)
            if (status != 200 or body["chunks_deleted"] != len(chunks)
                    or body["artifact_chunks_deleted"] != len(artifacts)
                    or body["compacted"]):
                raise RuntimeError(f"DELETE /calls/{call_id}: {status} {body}")
            gone_chunks |= chunks
            gone_artifacts |= artifacts
            status, data = http_json(port, "POST", "/retrieve/batch",
                                     probes + packs + new_queries)
            if status != 200:
                raise RuntimeError(f"/retrieve/batch answered {status}")
            assert_none_deleted(data["results"], f"after DELETE {call_id}")
            now = stats()
            if (now["chunks"]["tombstones"] != len(gone_chunks)
                    or now["artifact_chunks"]["tombstones"] != len(gone_artifacts)):
                raise RuntimeError(f"/index/stats tombstones {now} != "
                                   f"{len(gone_chunks)}, {len(gone_artifacts)}")
        for path in (f"/calls/{targets[0][0]}", f"/calls/{targets[-1][0]}"):
            for method in ("DELETE", "GET"):
                status, _body = http_json(port, method, path)
                if status != 404:
                    raise RuntimeError(f"{method} {path} of a deleted call: {status}")
        out["delete"] = {
            "calls": len(targets), "chunks": len(gone_chunks),
            "artifact_chunks": len(gone_artifacts),
            "p50_ms": float(np.median(delete_ms)),
            "one_chunk_call_p50_ms": float(np.median(delete_ms[:WORKER_DELETES])),
            "synthetic_call_p50_ms": float(np.median(delete_ms[WORKER_DELETES:])),
            "max_ms": max(delete_ms)}
        take_launches()
        out["kernels_tombstoned"] = [
            check_kernels_on_corpus(corpus, index.call_capacity, concurrency, 40 + i)
            for i, corpus in enumerate((index.chunks, index.artifacts))]
        fused_scan.launches = 0
        range_topk.launches = 0

        # 3. compaction under traffic: delete_ids up to just under the 25%
        # threshold of both corpora, then the DELETE that crosses both
        final = next(s_ for s_ in range(N_CALLS) if s_ not in synthetic)
        final_chunks, final_artifacts = call_rows(final)
        bulk = {}
        for corpus, n_rows, gone, last in (
                (index.chunks, n_chunks, gone_chunks, final_chunks),
                (index.artifacts, n_artifacts, gone_artifacts, final_artifacts)):
            threshold = max(int(corpus.count * 0.25), 64)
            need = threshold - corpus.tombstones - len(last) // 2
            ids = np.arange(1, n_rows + 1)
            free = ids[~np.isin((ids - 1) % N_CALLS, synthetic + [final])]
            if need <= 0 or need > free.size or not last:
                raise RuntimeError(f"{corpus.name}: cannot reach the compaction "
                                   f"threshold {threshold} from {corpus.tombstones}")
            bulk[corpus.name] = free[:need]
        ids_only = lambda r: [{"query": q, "return_style": "ids_only"}
                              for q in unique_queries(concurrency, 5000 + r)]

        def under_traffic(name, action):
            return run_under_traffic(port, workdir, dispatches, name, action,
                                     ids_only, traffic_rounds)

        def tombstone_bulk():
            t = time.perf_counter()
            index.chunks.delete_ids(bulk["chunks"].tolist())
            mid = time.perf_counter()
            index.artifacts.delete_ids(bulk["artifact_chunks"].tolist())
            return mid - t, time.perf_counter() - mid

        bulk_rounds, bulk_s, _window = under_traffic("bulk tombstones", tombstone_bulk)
        gone_chunks |= set(bulk["chunks"].tolist())
        gone_artifacts |= set(bulk["artifact_chunks"].tolist())
        now = stats()
        if (now["chunks"]["tombstones"] != len(gone_chunks)
                or now["artifact_chunks"]["tombstones"] != len(gone_artifacts)):
            raise RuntimeError(f"tombstones after the bulk delete: {now}")

        def crossing_delete():
            t = time.perf_counter()
            status, body = http_json(port, "DELETE", f"/calls/{call_uuid(final)}",
                                     timeout=600)
            return status, body, (time.perf_counter() - t) * 1e3

        compact_rounds, (status, body, crossing_ms), window = under_traffic(
            "compaction", crossing_delete)
        if status != 200 or not body["compacted"]:
            raise RuntimeError(f"the crossing DELETE did not compact: {status} {body}")
        gone_chunks |= final_chunks
        gone_artifacts |= final_artifacts
        if sorted(r["corpus"] for r in compactions.records) != [
                "artifact_chunks", "chunks"]:
            raise RuntimeError(f"compactions: {compactions.records}")
        after = stats()
        live = {"chunks": rows1["chunks"]["count"] - len(gone_chunks),
                "artifact_chunks": rows1["artifact_chunks"]["count"] - len(gone_artifacts)}
        for name, want in live.items():
            if after[name]["tombstones"] != 0 or after[name]["count"] != want:
                raise RuntimeError(f"after the compaction {name}: {after[name]}, "
                                   f"want count {want}, tombstones 0")
        if (index.chunks.count, index.artifacts.count) != (
                live["chunks"], live["artifact_chunks"]):
            raise RuntimeError("the index's counts differ from /index/stats")
        # every surviving known row first, no deleted id in any answer
        survivors = ([(t, i) for t, i in zip(known_texts, known_ids)]
                     + [(texts[i], new_rows[i][1])
                        for i in range(WORKER_DELETES, N_BUNDLES)])
        final_bodies = ([{"query": t, "return_style": "ids_only"} for t, _i in survivors]
                        + probes + packs + new_queries[:WORKER_DELETES])
        res = http_rounds(port, "/retrieve", lambda r: final_bodies, 2, workdir)
        for _w, round_ in res:
            answers = [d for _s, _l, d in round_]
            assert_none_deleted(answers, "after the compaction")
            firsts = [d["retrieved_ids"][:1] for d in answers[:len(survivors)]]
            want = [[f"chunk:{i}"] for _t, i in survivors]
            if firsts != want:
                wrong = [(w, g) for w, g in zip(want, firsts) if w != g]
                raise RuntimeError(f"after the compaction {len(wrong)} known rows "
                                   f"are not first, e.g. {wrong[0]}")
        status, _body = http_json(port, "GET", f"/calls/{call_uuid(final)}")
        if status != 404:
            raise RuntimeError(f"GET of the deleted call answered {status}")

        out["bulk_tombstones"] = {
            "chunks": int(bulk["chunks"].size),
            "artifact_chunks": int(bulk["artifact_chunks"].size),
            "chunks_s": bulk_s[0], "artifact_chunks_s": bulk_s[1],
            "traffic": traffic_latency(bulk_rounds)}
        out["compaction"] = {
            "crossing_delete_ms": crossing_ms, "window_s": window,
            "records": compactions.records, "traffic": traffic_latency(compact_rounds),
            "count_after": live, "known_first": len(survivors),
            "survivors": survivors,
            "deleted_chunks": len(gone_chunks),
            "deleted_artifact_chunks": len(gone_artifacts)}
        take_launches()
        out["launches"] = dict(launches)
        out["dispatched"] = sorted(set(dispatches.take()))
        out["corpora"] = {
            name: {"rows": corpus.count, "dim": corpus.dim, "lex_dim": corpus.lex_dim,
                   "slots": corpus.tech.shape[1], "emb_dtype": corpus.emb_dtype}
            for name, corpus in (("chunks", index.chunks),
                                 ("artifacts", index.artifacts))}
        # 4. K1 and K3 on the compacted tensors
        out["kernels_compacted"] = [
            check_kernels_on_corpus(corpus, index.call_capacity, concurrency, 50 + i)
            for i, corpus in enumerate((index.chunks, index.artifacts))]
    finally:
        compactions.close()
        if worker is not None:
            worker.kill()
            worker.wait(timeout=60)
        stop()
    return out


def run_int8_served(device, n_chunks, n_artifacts, batch, n_known):
    """An index that stores int8 embeddings (``INDEX_EMBEDDING_DTYPE=int8``)
    serves one batch through the engine: synthetic corpora plus known rows,
    ``batch`` ids_only requests naming them; the chunks must be planned ann
    with the dense lane on, and every known row must come first."""
    import tempfile

    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.evals.synth import (
        insert_text_rows, install_synthetic_corpus,
    )
    from cadence_rag_tpu_torch.ingest.sync import reset_syncer
    from cadence_rag_tpu_torch.schemas import RetrieveRequest
    from cadence_rag_tpu_torch.store.db import reset_store

    device = torch.device(device)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_int8_"))
    overrides = {"store_path": str(workdir / "int8.db"), "embeddings_provider": "stub",
                 "embeddings_base_url": "", "index_embedding_dtype": "int8"}
    saved = {key: getattr(settings, key) for key in overrides}
    for key, value in overrides.items():
        setattr(settings, key, value)
    try:
        reset_store()
        core_index.reset_index()
        reset_syncer()
        index = core_index.get_index(device)
        if index.chunks.emb.dtype != torch.int8:
            raise RuntimeError(f"the index stores {index.chunks.emb.dtype}, not int8")
        index.ensure_call_capacity(N_CALLS)
        install_synthetic_corpus(index.chunks, n_chunks, N_CALLS, seed=0)
        install_synthetic_corpus(index.artifacts, n_artifacts, N_CALLS, seed=1)
        texts, tokens = known_rows(n_known)
        insert_text_rows(index.chunks, texts, tokens, doc_id0=KNOWN_ID0,
                         call_seq=KNOWN_CALL, started0=KNOWN_STARTED)
        dispatches = DispatchLog(index)
        t0 = time.perf_counter()
        answers = retrieve_evidence_batch([
            RetrieveRequest(query=texts[j % n_known], return_style="ids_only")
            for j in range(batch)])
        batch_ms = (time.perf_counter() - t0) * 1e3
        modes = {(cm, dense_on) for cm, _am, _b, dense_on, _w in dispatches.take()}
        if modes != {("ann", True)}:
            raise RuntimeError(f"the int8 batch dispatched {modes}, not ann with "
                               "the dense lane on")
        got = [a["retrieved_ids"][:1] for a in answers]
        want = [[f"chunk:{KNOWN_ID0 + j % n_known}"] for j in range(batch)]
        if got != want:
            wrong = [(w, g) for w, g in zip(want, got) if w != g]
            raise RuntimeError(f"int8: {len(wrong)} known rows not first, e.g. {wrong[0]}")
        return {"rows": index.chunks.count, "capacity": index.chunks.capacity,
                "artifact_rows": index.artifacts.count, "batch": batch,
                "first_batch_ms": batch_ms, "known_first": len(want)}
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        core_index.reset_index()
        shutil.rmtree(workdir, ignore_errors=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()


# -- lifecycle: rerank, vocab, checkpoint, cold tier, growth -------------------
GROW_KNOWN_TEXT = ("rollout {i}: the shard map moved to coordinator-{i} during the "
                   "capacity doubling to v7.{i}.3, tracked in CAP-{t}")
GROW_ID0 = 60_000_000
GROW_HEADROOM = 700              # rows left free before the crossing inserts
COLD_HOT_ROWS = 524_288
VOCAB_DOCS = (100_000, 10_000)   # chunks, artifact chunks of the vocab step's store
VOCAB_HEAD = 2048


def spans_by_tag(spans):
    """{tag: [seconds]} of the event ring's timed spans."""
    out = {}
    for ev in spans:
        if "s" in ev:
            out.setdefault(ev["tag"], []).append(ev["s"])
    return out


def synthetic_doc_rows(n, first_id, seed, dim, lex_dim, slots):
    """n host-made DocRows (unit embeddings, random signatures and slots),
    doc ids from ``first_id``: what an ingest hands ``CorpusIndex.insert``."""
    from cadence_rag_tpu_torch.core.index import DocRow

    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    lex = rng.integers(-4, 5, size=(n, lex_dim)).astype(np.int8)
    tech = rng.integers(1, 5000, size=(n, slots)).astype(np.int32)
    return [DocRow(doc_id=first_id + i, call_seq=int(rng.integers(0, N_CALLS)),
                   started_sec=int(rng.integers(1_600_000_000, 1_750_000_000)),
                   lex_sig=lex[i], lex_dl=12,
                   lex_touched=np.flatnonzero(lex[i])[:32].astype(np.int32),
                   tech=tech[i], embedding=emb[i]) for i in range(n)]


def cross_capacity(corpus, first_id, seed):
    """Insert batches of up to 512 host-made rows until the corpus's capacity
    has changed. -> (seconds, rows inserted)"""
    cap0 = corpus.capacity
    chunk = max(1, min(512, cap0 // 8))
    n = ((cap0 - corpus.count) // chunk + 2) * chunk
    rows = synthetic_doc_rows(n, first_id, seed, corpus.dim, corpus.lex_dim,
                              corpus.tech_slots)

    def cross():
        t = time.perf_counter()
        for lo in range(0, n, chunk):
            corpus.insert(rows[lo:lo + chunk])
            if corpus.capacity != cap0:
                return time.perf_counter() - t, lo + chunk
        raise RuntimeError(f"{corpus.name}: {n} rows did not cross capacity {cap0}")

    return cross


def fill_to_headroom(corpus, seed):
    """Fill the room the capacity has left down to ``GROW_HEADROOM`` rows (an
    eighth of a small capacity) with synthetic rows. -> rows added"""
    from cadence_rag_tpu_torch.evals.synth import append_synthetic_rows

    headroom = min(GROW_HEADROOM, corpus.capacity // 8)
    n = corpus.capacity - headroom - corpus.count
    if n > 0:
        append_synthetic_rows(corpus, n, N_CALLS, seed=seed)
    return max(n, 0)


def text_tokens(texts):
    from cadence_rag_tpu_torch.ingest.chunking import extract_tech_tokens

    return [extract_tech_tokens(t) for t in texts]


def known_batch(index, texts, ids, batch):
    """``batch`` unscoped queries naming known rows (text, id) of ``index``,
    planned by the port. -> (args, modes, expected ids)"""
    from cadence_rag_tpu_torch.evals.synth import plan_text_queries

    which = [j % len(texts) for j in range(batch)]
    picked = [texts[i] for i in which]
    allowed = np.ones((batch, index.call_capacity), dtype=bool)
    args, modes = plan_text_queries(index, picked, text_tokens(picked), allowed,
                                    scoped=False)
    return args, modes, np.array([ids[i] for i in which], dtype=np.int64)


def same_corpus_state(got, want):
    """The six device arrays (first ``count`` rows), the host mirrors, the
    lexical stats and the counters of two corpora, compared on the device.
    -> the name of the first thing that differs, or None."""
    n = want.count
    if got.count != n:
        return "count"
    for a, b, attr in zip(got.device_arrays(), want.device_arrays(),
                          ("emb", "lex", "tech", "call_idx", "started", "has_emb")):
        if not torch.equal(a[:n], b[:n]):
            return attr
    for attr in ("h_ids", "h_call", "h_started", "h_has_emb"):
        if not np.array_equal(getattr(got, attr)[:n], getattr(want, attr)[:n]):
            return attr
    if not np.array_equal(got.doc_freq, want.doc_freq):
        return "doc_freq"
    for attr in ("dl_sum", "tombstones", "emb_rows"):
        if getattr(got, attr) != getattr(want, attr):
            return attr
    return None


def first_ids_over_http(port, texts, workdir):
    res = http_rounds(port, "/retrieve", lambda r: [
        {"query": t, "return_style": "ids_only"} for t in texts], 1, workdir)
    return [d["retrieved_ids"][:1] for _s, _l, d in res[0][1]]


def run_lifecycle_served(device, index, workdir, dispatches, survivors,
                         concurrency=128, rounds=10, traffic_rounds=20):
    """The lifecycle steps that run on the served index, its store and its
    server (see the module docstring, phase 6d): the rerank lane under
    traffic, a checkpoint saved under traffic and restored into a fresh
    index, and a capacity doubling through the background migration under
    traffic. -> summary"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.checkpoint import restore_index, save_index
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager
    from cadence_rag_tpu_torch.core.prewarm import free_hbm_bytes, plan_next_capacity
    from cadence_rag_tpu_torch.evals.synth import insert_text_rows
    from cadence_rag_tpu_torch.utils import events

    from collections import Counter

    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk

    out = {}
    launches = Counter()

    def kernel_checks(corpora, capacity, seed):
        """K1 and K3 against their plain versions on each corpus's tensors;
        the launches of these comparisons are not the path's."""
        launches.update(fused_scan=fused_scan.launches, tech_topk=range_topk.launches)
        checks = [check_kernels_on_corpus(c, capacity, concurrency, seed + i)
                  for i, c in enumerate(corpora)]
        fused_scan.launches = 0
        range_topk.launches = 0
        return checks

    fused_scan.launches = 0
    range_topk.launches = 0
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    known_texts = [t for t, _i in survivors]
    known_ids = [i for _t, i in survivors]
    want_first = [[f"chunk:{i}"] for i in known_ids]
    port, stop = start_server()
    try:
        # 1. the rerank lane under (b)-traffic, beside an unreranked round
        packs = lambda salt: (lambda r: [
            {"query": q} for q in unique_queries(concurrency, salt + r)])
        http_rounds(port, "/retrieve", packs(30_000), 1, workdir)
        plain = http_rounds(port, "/retrieve", packs(30_100), rounds, workdir)
        settings.rerank_enabled, settings.rerank_provider = True, "lexical"
        try:
            http_rounds(port, "/retrieve", packs(30_200), 1, workdir)
            reranked = http_rounds(port, "/retrieve", packs(30_300), rounds, workdir)
        finally:
            settings.rerank_enabled = False
        notes = lambda res: [d["notes"]["retrieval"] for _w, r in res for _s, _l, d in r]
        if any(n["reranked_from"] is not None for n in notes(plain)):
            raise RuntimeError("rerank: an unreranked answer reports reranked_from")
        if not all((n["reranked_from"] or 0) >= 1 for n in notes(reranked)):
            raise RuntimeError("rerank: an answer under RERANK_ENABLED was not reranked")
        out["rerank"] = {
            "plain": round_stats(plain), "reranked": round_stats(reranked),
            "rerank_ms": float(np.mean([n["timings_ms"]["rerank_ms"]
                                        for n in notes(reranked)])),
            "reranked_from": float(np.mean([n["reranked_from"]
                                            for n in notes(reranked)]))}

        # 3. checkpoint: saved under traffic, restored into a fresh index
        ckpt = workdir / "ckpt"
        ids_only = lambda r: [{"query": q, "return_style": "ids_only"}
                              for q in unique_queries(concurrency, 40_000 + r)]
        saves = {}
        for name, block in (("blocking", True), ("background", False)):
            if saves and shutil.disk_usage(workdir).free < 2.2 * saves["blocking"]["bytes"]:
                # no room for two generations side by side: drop the first
                shutil.rmtree(ckpt)
            def save(block=block):
                t = time.perf_counter()
                meta = save_index(str(ckpt), index, block=block)
                returned = time.perf_counter() - t
                if not block:
                    meta["_writer"].join(900)
                return returned, time.perf_counter() - t, meta["generation"]

            events.enable()
            try:
                traffic, (returned, total, generation), _window = run_under_traffic(
                    port, workdir, dispatches, f"checkpoint {name}", save, ids_only,
                    traffic_rounds)
                spans = spans_by_tag(events.drain())
            finally:
                events.disable()
            saves[name] = {
                "call_returned_s": returned, "to_disk_s": total,
                "generation": generation,
                "lock_s": sum(spans["index.checkpoint_snapshot"]),
                "pinned_alloc_s": sum(spans.get("index.checkpoint_pinned_alloc", [0.0])),
                "write_s": sum(spans["checkpoint.write"]),
                "bytes": sum(f.stat().st_size for f in ckpt.iterdir()),
                "traffic": traffic_latency(traffic)}
        t0 = time.perf_counter()
        fresh = DeviceIndexManager(device)
        meta = restore_index(str(ckpt), fresh)
        sync()
        restore_s = time.perf_counter() - t0
        args, modes, expected = known_batch(fresh, known_texts, known_ids, concurrency)
        check_first(serve_batch(fresh, args, modes), expected, "restored index")
        serving_s = time.perf_counter() - t0
        for got, want in ((fresh.chunks, index.chunks), (fresh.artifacts, index.artifacts)):
            differs = same_corpus_state(got, want)
            if differs:
                raise RuntimeError(f"restored {want.name}: {differs} differs from "
                                   "the served index")
        out["checkpoint"] = {
            "saves": saves, "restore_s": restore_s, "to_serving_s": serving_s,
            "rows": {k: int(v) for k, v in meta["counts"].items()},
            "known_first": len(known_ids),
            "kernels": kernel_checks((fresh.chunks, fresh.artifacts),
                                     fresh.call_capacity, 80)}
        del fresh, args
        if cuda:
            torch.cuda.empty_cache()

        # 5. growth through the background migration, under traffic
        corpus = index.chunks
        cap0 = corpus.capacity
        t = time.perf_counter()
        filled = fill_to_headroom(corpus, seed=70)
        sync()
        fill_s = time.perf_counter() - t
        free = free_hbm_bytes(device)
        planned = plan_next_capacity(corpus, cap0 + 1, concurrency)
        grow_texts = [GROW_KNOWN_TEXT.format(i=i, t=6300 + i) for i in range(N_KNOWN)]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        events.enable()
        try:
            t = time.perf_counter()
            # a real insert past PREWARM_FILL_FRACTION: the trigger
            insert_text_rows(corpus, grow_texts, text_tokens(grow_texts),
                             doc_id0=GROW_ID0, call_seq=KNOWN_CALL,
                             started0=KNOWN_STARTED + 10_000)
            migration = corpus._migration
            if migration is None or migration.new_cap != planned:
                raise RuntimeError(f"growth: no migration toward {planned} started")
            if not migration.ready.wait(300):
                raise RuntimeError("growth: the migration never became ready")
            ready_s = time.perf_counter() - t
            traffic, (inserts_s, crossed_rows), _window = run_under_traffic(
                port, workdir, dispatches, "growth swap",
                cross_capacity(corpus, 70_000_000, 71), ids_only, traffic_rounds)
            sync()
            spans = spans_by_tag(events.drain())
        finally:
            events.disable()
        if corpus.capacity != planned or corpus._migration is not None:
            raise RuntimeError(f"growth: capacity {corpus.capacity}, planned {planned}")
        if "index.growth_swap" not in spans or "index.grow" in spans:
            raise RuntimeError(f"growth: spans {sorted(spans)}: the swap did not happen")
        texts = known_texts + grow_texts
        firsts = first_ids_over_http(port, texts, workdir)
        want = want_first + [[f"chunk:{GROW_ID0 + i}"] for i in range(N_KNOWN)]
        if firsts != want:
            wrong = [(w, g) for w, g in zip(want, firsts) if w != g]
            raise RuntimeError(f"after the growth {len(wrong)} known rows are not "
                               f"first, e.g. {wrong[0]}")
        out["growth_migration"] = {
            "old_capacity": cap0, "capacity": corpus.capacity, "rows": corpus.count,
            "filled_rows": filled, "fill_s": fill_s, "free_bytes": free,
            "planned": planned, "ready_s": ready_s,
            "crossing_inserts_s": inserts_s, "crossing_rows": crossed_rows,
            "alloc_fill_s": sum(spans["index.migration_alloc"]),
            "copy_s": sum(spans["index.migration_copy"]),
            "swap_s": sum(spans["index.growth_swap"]),
            "mirrors_s": sum(spans["index.grow_mirrors"]),
            "held_bytes": held if cuda else None,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
            "traffic": traffic_latency(traffic), "known_first": len(want),
            "kernels": kernel_checks((corpus,), index.call_capacity, 90)}
        launches.update(fused_scan=fused_scan.launches, tech_topk=range_topk.launches)
        out["launches"] = dict(launches)
    finally:
        stop()
    return out


# files no PR of the port edits (the JAX package, its tests, the documents
# that predate the port): the vocab step's corpus stays the same from PR to
# PR, so its known documents stay on the same texts
FROZEN_SOURCES = ("cadence_rag_tpu/*.py", "cadence_rag_tpu/*/*.py", "tests/unit/*.py",
                  "tests/integration/*.py", "tests/kernels/*.py", "docs/*.md")
# root Markdown that names the card or the port's package follows the port
PORT_MARKS = ("H100", "cadence_rag_tpu_torch")


def source_texts(n):
    """n distinct documents of real text: windows of three consecutive
    non-empty lines of the checkout's sources that no PR of the port edits
    (``FROZEN_SOURCES``, and the root's Markdown but the documents that
    follow the port, which name its card or its package: ``PORT_MARKS``),
    then of two and of four lines, if three do not give enough."""
    root = Path(__file__).resolve().parent
    files = sorted({p for pat in FROZEN_SOURCES for p in root.glob(pat)}
                   | {p for p in root.glob("*.md")
                      if not any(m in p.read_text(errors="ignore") for m in PORT_MARKS)})
    lines = []
    for path in files:
        try:
            lines += [ln.strip() for ln in path.read_text(errors="ignore").splitlines()
                      if len(ln.strip()) >= 12]
        except OSError:
            continue
    seen, out = set(), []
    for width in (3, 2, 4, 5):
        for i in range(0, len(lines) - width):
            text = " ".join(lines[i:i + width])[:600]
            key = " ".join(text.lower().split())
            if key not in seen:
                seen.add(key)
                out.append(text)
                if len(out) == n:
                    return out
    raise RuntimeError(f"the checkout's sources give {len(out)} distinct documents, "
                       f"not {n}")


def run_vocab(device, n_chunks, n_artifacts, head, n_known, batch):
    """The learned vocab head at work (phase 6d, step 2): a store of
    ``n_chunks`` + ``n_artifacts`` documents of real text (``source_texts``)
    and an index over the same ids; ``build_and_apply`` learns the head and
    re-featurizes every document (store blobs, device rows, df tables); then
    every known document must come first for its own text, K1 is held to its
    plain version on the re-scattered ``lex`` tensor, a restart from a
    checkpoint passes startup's digest check with the rows bit-equal, and a
    restart without one rebuilds the index from the store. -> summary"""
    import tempfile

    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.core.checkpoint import restore_index, save_index
    from cadence_rag_tpu_torch.core.vocab import (
        activate_from_store, build_and_apply, vocab_digest,
    )
    from cadence_rag_tpu_torch.embed.stub import HashEmbeddingProvider
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.evals.synth import bulk_store_rows, install_synthetic_corpus
    from cadence_rag_tpu_torch.ingest import featurize
    from cadence_rag_tpu_torch.ingest.sync import reset_syncer
    from cadence_rag_tpu_torch.schemas import RetrieveRequest
    from cadence_rag_tpu_torch.serve.api import startup
    from cadence_rag_tpu_torch.store.db import get_store, reset_store
    from cadence_rag_tpu_torch.utils import events

    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_vocab_"))
    overrides = {"store_path": str(workdir / "vocab.db"), "embeddings_provider": "stub",
                 "embeddings_base_url": "", "store_sync_interval_s": 0.0,
                 "log_level": "WARNING"}
    saved = {key: getattr(settings, key) for key in overrides}
    for key, value in overrides.items():
        setattr(settings, key, value)
    try:
        texts = source_texts(n_chunks + n_artifacts)
        reset_store()
        core_index.reset_index()
        reset_syncer()
        index = core_index.get_index(device)
        index.ensure_call_capacity(N_CALLS)
        install_synthetic_corpus(index.chunks, n_chunks, N_CALLS, seed=0)
        install_synthetic_corpus(index.artifacts, n_artifacts, N_CALLS, seed=1)
        store = get_store()
        bulk_store_rows(store, n_chunks, n_artifacts, N_CALLS,
                        chunk_text=lambda i: texts[i],
                        artifact_text=lambda i: texts[n_chunks + i])
        step = n_chunks // n_known
        known_ids = [1 + j * step for j in range(n_known)]
        known_texts = [texts[i - 1] for i in known_ids]
        vecs = np.asarray(HashEmbeddingProvider().embed(known_texts).vectors, np.float32)
        index.chunks.set_embeddings(known_ids, vecs)
        requests = [RetrieveRequest(query=known_texts[j % n_known], return_style="ids_only")
                    for j in range(batch)]
        want = [[f"chunk:{known_ids[j % n_known]}"] for j in range(batch)]

        def known_first(what):
            got = [a["retrieved_ids"][:1] for a in retrieve_evidence_batch(requests)]
            if got != want:
                wrong = [(w, g) for w, g in zip(want, got) if w != g]
                raise RuntimeError(f"vocab, {what}: {len(wrong)} known documents not "
                                   f"first, e.g. {wrong[0]}")

        events.enable()
        try:
            summary = build_and_apply(store, index, head=head)
            spans = spans_by_tag(events.drain())
        finally:
            events.disable()
        vocab, version = featurize.active_vocab()
        if vocab is None or vocab.size != head or summary["version"] != version:
            raise RuntimeError(f"vocab: {summary}, active head "
                               f"{None if vocab is None else vocab.size}")
        live = sum(c["live_rows"] for c in summary["corpora"].values())
        if live != n_chunks + n_artifacts:
            raise RuntimeError(f"vocab: {live} rows re-scattered of "
                               f"{n_chunks + n_artifacts}")
        known_first("after the apply")
        kernels = check_kernels_on_corpus(index.chunks, index.call_capacity, batch, 100)
        # a restart from a checkpoint: the store's vocab activates, the
        # checkpoint's matches it by content, the rows are bit-equal
        n = index.chunks.count
        lex = index.chunks.lex[:n].clone()
        save_index(str(workdir / "ckpt"), index)
        core_index.reset_index()
        if featurize.active_vocab() != (None, 0):
            raise RuntimeError("vocab: reset_index left a vocab active")
        if activate_from_store(store) != version:
            raise RuntimeError("vocab: the store's vocab did not activate")
        t0 = time.perf_counter()
        restored = core_index.get_index(device)
        meta = restore_index(str(workdir / "ckpt"), restored)
        startup(device)              # the digest check, then a reconcile
        sync()
        restart_s = time.perf_counter() - t0
        if (meta["lex_vocab_sha"] != vocab_digest(featurize.active_vocab()[0])
                or not torch.equal(restored.chunks.lex[:n], lex)):
            raise RuntimeError("vocab: the restored index differs from the saved one")
        known_first("after the restart from a checkpoint")
        # a restart without one: startup rebuilds the index from the store,
        # whose blobs the apply rewrote: the same signatures (the rebuilt
        # rows have no embeddings: this store holds none)
        del restored
        core_index.reset_index()
        t0 = time.perf_counter()
        startup(device)
        sync()
        rebuild_s = time.perf_counter() - t0
        rebuilt = core_index.get_index()
        if (rebuilt.chunks.count, rebuilt.artifacts.count) != (n_chunks, n_artifacts):
            raise RuntimeError(f"vocab: rebuilt {rebuilt.chunks.count} + "
                               f"{rebuilt.artifacts.count} rows")
        if featurize.active_vocab()[1] != version:
            raise RuntimeError("vocab: the rebuild did not activate the store's vocab")
        if not torch.equal(rebuilt.chunks.lex[:n], lex):
            raise RuntimeError("vocab: the rows rebuilt from the store's blobs differ "
                               "from the re-scattered ones")
        return {"documents": n_chunks + n_artifacts, "head": int(vocab.size),
                "version": version, "learn_s": sum(spans["vocab.learn"]),
                "apply_s": sum(spans["vocab.apply"]), "rows_rescattered": live,
                "native_featurizer": featurize.native_available(),
                "known_first": n_known, "kernels": kernels,
                "restart_from_checkpoint_s": restart_s,
                "rebuild_from_store_s": rebuild_s}
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        core_index.reset_index()
        reset_syncer()
        shutil.rmtree(workdir, ignore_errors=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()


def lanes_differ(got, want, atol=1e-5):
    """Two (chunks, artifacts) lane outputs -> (positions whose ids differ,
    those of them whose scores differ by more than ``atol`` too, the largest
    score difference)."""
    moved = apart = 0
    worst = 0.0
    for g_corpus, w_corpus in zip(got, want):
        for lane, (ids, scores, counts) in w_corpus.items():
            g_ids, g_scores, g_counts = g_corpus[lane]
            if not np.array_equal(g_counts, counts):
                return -1, -1, float("inf")
            for b, m in enumerate(counts):
                diff = np.abs(g_scores[b, :m] - scores[b, :m])
                worst = max(worst, float(diff.max(initial=0.0)))
                other = g_ids[b, :m] != ids[b, :m]
                moved += int(other.sum())
                apart += int((other & (diff > atol)).sum())
    return moved, apart, worst


def run_cold_tier(device, full, batches, hot_rows, n_known, batch):
    """The host cold tier (phase 6d, step 4): an index capped at ``hot_rows``
    device rows takes the rows of ``full``'s chunks in their order (the rest
    go to pinned host memory), then serves the main path's batches through
    the index API and the engine. Every lane must carry the uncapped index's
    ids, every known row (they all sit in the cold tier) must come first, a
    delete and a backfill must land in the cold tier, and K1 and K3 are held
    to their plain versions on a block's own staged tensors. -> summary"""
    import tempfile
    import types

    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.core.coldtier import ColdTier
    from cadence_rag_tpu_torch.embed.stub import HashEmbeddingProvider
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.evals.coldtier_bench import bare_h2d_gbps
    from cadence_rag_tpu_torch.evals.synth import install_capped_copy, plan_text_queries
    from cadence_rag_tpu_torch.ingest.sync import reset_syncer
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk
    from cadence_rag_tpu_torch.schemas import RetrieveRequest
    from cadence_rag_tpu_torch.store.db import reset_store
    from cadence_rag_tpu_torch.utils import events

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_cold_"))
    overrides = {"store_path": str(workdir / "cold.db"), "embeddings_provider": "stub",
                 "embeddings_base_url": "", "index_max_device_rows": hot_rows}
    saved = {key: getattr(settings, key) for key in overrides}
    for key, value in overrides.items():
        setattr(settings, key, value)
    fused_scan.launches = 0
    range_topk.launches = 0
    try:
        reset_store()
        core_index.reset_index()
        reset_syncer()
        capped = core_index.get_index(device)
        capped.ensure_call_capacity(N_CALLS)
        events.enable()
        try:
            t0 = time.perf_counter()
            install_capped_copy(full.chunks, capped.chunks)
            sync()
            install_s = time.perf_counter() - t0
            spans = spans_by_tag(events.drain())
        finally:
            events.disable()
        capped.artifacts.load_state(full.artifacts.state_arrays())
        tier = capped.chunks.cold
        if capped.chunks.count != hot_rows or tier is None or (
                capped.chunks.count + tier.count != full.chunks.count):
            raise RuntimeError(f"cold: {capped.chunks.count} hot rows")
        block = int(settings.cold_block_rows)
        out = {"hot_rows": hot_rows, "cold_rows": tier.count, "block_rows": block,
               "blocks": -(-tier.count // block), "install_s": install_s,
               "pinned_alloc_s": sum(spans.get("coldtier.alloc", [0.0])),
               "pinned_bytes": sum(a.numel() * a.element_size()
                                   for a in tier.row_arrays()),
               "pinned": bool(tier.emb.is_pinned()) if cuda else False,
               "batches": {}}
        if cuda and not out["pinned"]:
            raise RuntimeError("cold: the tier's rows are not in pinned memory")

        def lanes(index, args, modes):
            return index.collect_packed(index.query_both_packed_async(
                *args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS, chunk_mode=modes[0],
                artifact_mode=modes[1], recall_target=0.95, fuse_rrf=True))

        for name, args, modes, expected in batches:
            want = full.collect_packed(full.query_both_packed_async(
                *args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS, chunk_mode=modes[0],
                artifact_mode=modes[1], recall_target=0.95, fuse_rrf=False))
            got = lanes(capped, args, modes)       # device RRF stands down
            moved, apart, worst = lanes_differ(got, want)
            if apart:
                raise RuntimeError(
                    f"cold ({name}, {modes}): {apart} lane positions carry another "
                    f"id than the uncapped index's with scores more than 1e-5 apart")
            check_first_lanes(got, expected, f"cold {name}")
            shipped0 = ColdTier.bytes_shipped
            times, hot_times = [], []
            for _ in range(4):
                t = time.perf_counter()
                lanes(capped, args, modes)
                times.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                serve_batch(full, args, modes)
                hot_times.append((time.perf_counter() - t) * 1e3)
            shipped = (ColdTier.bytes_shipped - shipped0) / 4
            out["batches"][name] = {
                "modes": modes, "ids_moved": moved, "max_score_diff": worst,
                "batch_ms": times[1:], "all_hot_batch_ms": hot_times[1:],
                "bytes_shipped": shipped,
                "h2d_gbs": shipped / (float(np.median(times[1:])) / 1e3) / 1e9}
        if cuda:
            out["bare_copy_gbs"] = bare_h2d_gbps(tier, min(block, tier.count))
            out["bound_ms"] = (out["batches"]["unscoped"]["bytes_shipped"]
                               / out["bare_copy_gbs"] / 1e6)
        # through the engine: every known row (all in the cold tier) first
        texts, tokens = known_rows(n_known)
        if not all(tier.contains(KNOWN_ID0 + i) for i in range(n_known)):
            raise RuntimeError("cold: the known rows are not in the cold tier")
        requests = [RetrieveRequest(query=texts[j % n_known], return_style="ids_only")
                    for j in range(batch)]

        def engine_firsts():
            return [a["retrieved_ids"][:1] for a in retrieve_evidence_batch(requests)]

        want = [[f"chunk:{KNOWN_ID0 + j % n_known}"] for j in range(batch)]
        if engine_firsts() != want:
            raise RuntimeError("cold: a known row is not first through the engine")
        # a delete and a backfill that land in the cold tier
        n_cold = tier.count
        victims = [int(i) for i in tier.ids[1000:1064]] + [KNOWN_ID0]
        probes = [int(i) for i in tier.ids[n_cold // 2: n_cold // 2 + 8]]
        probe_texts = [f"backfill probe {i} of the cold tier shard" for i in range(8)]
        vecs = np.asarray(HashEmbeddingProvider().embed(probe_texts).vectors, np.float32)
        if capped.chunks.delete_ids(victims) != len(victims):
            raise RuntimeError("cold: the delete did not reach every cold row")
        if capped.chunks.set_embeddings(probes, vecs) != len(probes):
            raise RuntimeError("cold: the backfill did not reach every cold row")
        firsts = engine_firsts()
        if firsts[0] == want[0] or firsts[1:n_known] != want[1:n_known]:
            raise RuntimeError("cold: after the delete the known rows answer wrong")
        allowed = np.ones((8, capped.call_capacity), dtype=bool)
        args, modes = plan_text_queries(capped, probe_texts, text_tokens(probe_texts),
                                        allowed, scoped=False)
        dense = lanes(capped, args, modes)[0]["dense"]
        if [int(r[0]) for r in dense[0]] != probes:
            raise RuntimeError("cold: a backfilled cold row is not first in the dense lane")
        out.update(deleted=len(victims), backfilled=len(probes),
                   tombstones=tier.tombstones, known_first=n_known - 1)
        out["launches"] = {"fused_scan": fused_scan.launches,
                           "tech_topk": range_topk.launches}
        if cuda and min(out["launches"].values()) <= 0:
            raise RuntimeError(f"the cold tier step did not launch K1 and K3: "
                               f"{out['launches']}")
        # K1 and K3 on a block's own tensors: the full first block, the tail
        staging = tier._staging_for(min(block, tier.count))
        out["kernels"] = []
        for start in (0, (tier.count // block) * block):
            stop = min(start + block, tier.count)
            if stop <= start:
                continue
            arrays = tuple(s[: stop - start] for s in staging)
            for dst, src in zip(arrays, tier.row_arrays()):
                dst.copy_(src[start:stop], non_blocking=True)
            shaped = types.SimpleNamespace(
                name=f"cold block at row {start}", device=device,
                lock=capped.chunks.lock, count=stop - start,
                device_arrays=lambda arrays=arrays: arrays)
            out["kernels"].append(check_kernels_on_corpus(
                shaped, capped.call_capacity, batch, 110 + start % 7))
        return out
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        core_index.reset_index()
        reset_syncer()
        shutil.rmtree(workdir, ignore_errors=True)
        if cuda:
            torch.cuda.empty_cache()


def run_sync_growth(device, index, batches, batch):
    """A capacity doubling with ``GROWTH_MIGRATION_ENABLED=0`` (phase 6d,
    step 5, second half), on the index-API phase's own index, under a thread
    that serves the main path's unscoped batch through the index API all the
    while: the ``index.grow`` span, the longest batch across it beside the
    median, and the same steps timed one by one on arrays of the same shapes
    (allocation, fill, copy, host mirrors). -> summary"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.utils import events

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    corpus = index.chunks
    corpus.ivf = None                 # the batches below are planned ann/exact
    with corpus.lock:
        # the known rows' insert took this corpus past PREWARM_FILL_FRACTION
        # long ago: drop the migration that has stood ready since
        corpus._cancel_migration_locked()
    if cuda:
        torch.cuda.empty_cache()
    cap0 = corpus.capacity
    enabled = settings.growth_migration_enabled
    settings.growth_migration_enabled = False
    try:
        filled = fill_to_headroom(corpus, seed=72)
        # the steps of a doubling, one by one, on the same shapes
        split = {}
        sync()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        probe = [torch.empty((2 * cap0,) + tuple(a.shape[1:]), dtype=a.dtype, device=device)
                 for a in corpus.device_arrays()]
        sync()
        split["allocation_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for a in probe:
            a.zero_()
        sync()
        split["fill_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for new, old in zip(probe, corpus.device_arrays()):
            new[:cap0].copy_(old)
        sync()
        split["copy_s"] = time.perf_counter() - t
        del probe
        if cuda:
            torch.cuda.empty_cache()     # the growth below allocates anew
        _name, args, modes, _expected = batches[0]
        stop, samples, errors = threading.Event(), [], []

        def serve():
            try:
                while not stop.is_set():
                    t = time.perf_counter()
                    serve_batch(index, args, modes)
                    samples.append((time.time(), (time.perf_counter() - t) * 1e3))
            except Exception as exc:
                errors.append(exc)

        cross = cross_capacity(corpus, 80_000_000, 73)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        server = threading.Thread(target=serve, name="index-api traffic")
        server.start()
        events.enable()
        try:
            wait_for(lambda: errors or len(samples) >= 5, "the index-API traffic")
            began = time.time()
            inserts_s, crossed_rows = cross()
            ended = time.time()
            wait_for(lambda: errors or (samples and samples[-1][0] > ended + 0.2),
                     "batches after the growth")
            spans = spans_by_tag(events.drain())
        finally:
            events.disable()
            stop.set()
            server.join(120)
        if errors:
            raise errors[0]
        if corpus.capacity <= cap0 or "index.grow" not in spans:
            raise RuntimeError(f"growth: capacity {corpus.capacity}, spans {sorted(spans)}")
        split["host_mirrors_s"] = sum(spans["index.grow_mirrors"])
        ms = np.array([m for _t, m in samples])
        across = [m for t_, m in samples if t_ >= began]
        for name, b_args, b_modes, expected in batches:
            check_first(serve_batch(index, b_args, b_modes), expected,
                        f"after the growth, {name}")
        return {"old_capacity": cap0, "capacity": corpus.capacity, "rows": corpus.count,
                "filled_rows": filled, "crossing_inserts_s": inserts_s,
                "crossing_rows": crossed_rows,
                "grow_s": sum(spans["index.grow"]), "split": split,
                "held_bytes": held if cuda else None,
                "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
                "batches": int(ms.size), "batch_p50_ms": float(np.median(ms)),
                "longest_batch_ms": float(max(across)),
                "kernels": [check_kernels_on_corpus(corpus, index.call_capacity, batch, 120)]}
    finally:
        settings.growth_migration_enabled = enabled


# -- models: the Qwen3 encoder beside the served index, the neural embedder and
# reranker, the /embed service ---------------------------------------------------
# known rows for the Qwen3 step: distinct words at both ends (the encoder pools
# the last position), distinct tech tokens
QWEN3_WORDS = ("amber", "basalt", "cobalt", "dune", "ember", "fjord", "garnet",
               "harbor", "indigo", "jasper", "kelp", "lagoon", "marble", "nectar",
               "onyx", "prairie")
QWEN3_KNOWN_TEXT = ("{w} check {i}: the {w} replica lagged behind after the rollout "
                    "of v5.{i}.2, tracked in OPS-{t} near {w}")
QWEN3_ATOL = 1e-2        # card (bf16 GEMMs, f32 out) vs plain, unit vectors
QWEN3_MIN_COS = 0.999
EMBED_SERVICE_ATOL = 1e-5
BACKFILL_BATCH = 4
# the neural real gate's answers on the card hold the CPU's ids this deep: K1's
# lexical half is held to its plain version within 1e-3 (the f32 query in three
# bf16 pieces), so rows whose fused scores tie that closely may swap below
GATE_HEAD = 10
ROOT = Path(__file__).resolve().parent
EMBEDDER_ARTIFACT = ROOT / "artifacts" / "embedder" / "tuned_small_v1.npz"
RERANKER_ARTIFACT = ROOT / "artifacts" / "reranker" / "two_register_v1.npz"


def encoder_bound_ms(cfg, tokens):
    """The least time of one forward pass over ``tokens`` padded tokens: the
    larger of 2 x non-embedding parameters x tokens at the bf16 tensor peak
    and the bf16 non-embedding weights read once at the HBM peak."""
    params = cfg.param_count() - cfg.vocab_buckets * cfg.d_model
    return max(2.0 * params * tokens / (BF16_PEAK_TFLOPS * 1e12),
               2.0 * params / (HBM_PEAK_GBS * 1e9)) * 1e3


def first_layers(model, n_layers):
    """An encoder over the first ``n_layers`` of ``model``'s stacked weights
    (views, no copy)."""
    import dataclasses

    from cadence_rag_tpu_torch.models.qwen3 import Qwen3Encoder

    sub = Qwen3Encoder(dataclasses.replace(model.cfg, n_layers=n_layers),
                       model.device)
    for name, param in sub.named_parameters():
        full = getattr(model, name)
        param.data = full[:n_layers] if name not in ("tok_emb", "final_norm") else full
    return sub


def check_encoder(provider, queries, chunk_texts, depth):
    """The encoder's card path against its plain path (f32 products of
    bf16-rounded operands) at its widths and ``depth`` layers. -> report"""
    sub = first_layers(provider.model, depth)
    out = {"depth": depth}
    for name, texts in (("queries", queries), ("chunks", chunk_texts)):
        tokens = torch.from_numpy(provider.tokenize(texts))
        card, plain = sub(tokens), sub(tokens, plain=True)
        if not (torch.isfinite(card).all() and torch.isfinite(plain).all()):
            raise RuntimeError(f"qwen3 {name}: non-finite vectors")
        err = float((card - plain).abs().max())
        cos = float((card * plain).sum(dim=1).min())
        if err > QWEN3_ATOL or cos < QWEN3_MIN_COS:
            raise RuntimeError(f"qwen3 {name}: card vs plain |err| {err:.3g}, min "
                               f"cosine {cos:.6f} (limits {QWEN3_ATOL}, "
                               f"{QWEN3_MIN_COS})")
        out[name] = {"shape": list(tokens.shape), "max_abs_err": err, "min_cos": cos}
    del sub
    return out


def ingest_texts_as_call(external_id, texts, index=None):
    """One call whose transcript holds ``texts``, one chunk each, through
    the ingest path. With ``index``, the store's chunk ids first move past
    the index's highest: rows appended to the index alone (the lifecycle's
    fill) took the ids after the store's, and an insert of an id the index
    holds is a no-op. -> (call_id, chunk ids, the chunks' stored texts)"""
    from cadence_rag_tpu_torch.ingest.ingest import ingest_transcript
    from cadence_rag_tpu_torch.schemas import CallRef, ChunkingOptions, UtteranceIn
    from cadence_rag_tpu_torch.store.db import get_store

    if index is not None:
        corpus = index.chunks
        with corpus.lock:
            top = int(corpus.h_ids[:corpus.count].max(initial=0))
        with get_store().tx() as conn:
            conn.execute("UPDATE sqlite_sequence SET seq = MAX(seq, ?) "
                         "WHERE name = 'chunks'", (top,))
    call_id, _n, n_chunks = ingest_transcript(
        CallRef(external_id=external_id, title=external_id),
        [UtteranceIn(speaker="Ana", start_ts_ms=i * 1000, end_ts_ms=i * 1000 + 900,
                     text=t) for i, t in enumerate(texts)],
        ChunkingOptions(target_tokens=8, max_tokens=400, overlap_tokens=0))
    if n_chunks != len(texts):
        raise RuntimeError(f"{external_id}: {n_chunks} chunks for {len(texts)} texts")
    with get_store().read() as conn:
        rows = conn.execute(
            "SELECT chunk_id, text FROM chunks WHERE call_id = ? ORDER BY chunk_id",
            (call_id,)).fetchall()
    return call_id, [int(r["chunk_id"]) for r in rows], [r["text"] for r in rows]


def run_models_served(device, index, workdir, dispatches, preset="4b",
                      concurrency=128, rounds=10, depth=2, n_chunk_texts=32):
    """Steps 1, 2 and the served half of 4 of the models phase, on the served
    index and store: the Qwen3 encoder made on the card beside the index,
    held against its plain path at ``depth`` layers and timed at its full
    depth; then the HTTP server with ``EMBEDDINGS_PROVIDER=qwen3`` over the
    index, known rows ingested and embedded by the encoder through the
    backfill, rounds of ``concurrency`` ids_only requests beside stub rounds
    of the same run, every known row first in the dense lane and fused; then
    (b)-traffic with ``RERANK_PROVIDER=neural`` beside the lexical provider.
    -> summary"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.device import set_models_device
    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu_torch.evals.synth import synth_text
    from cadence_rag_tpu_torch.models.qwen3 import Qwen3EmbeddingProvider
    from cadence_rag_tpu_torch.models.reranker import NeuralReranker
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk
    from cadence_rag_tpu_torch.utils import events

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    saved = {k: getattr(settings, k) for k in (
        "embeddings_provider", "qwen3_preset", "rerank_enabled", "rerank_provider",
        "reranker_params_path")}
    stop = None
    try:
        # 1. the encoder, made on the card beside the index
        settings.qwen3_preset = preset
        set_models_device(device)
        Qwen3EmbeddingProvider._instance = None
        sync()
        held = torch.cuda.memory_allocated() if cuda else None
        t0 = time.perf_counter()
        provider = Qwen3EmbeddingProvider.shared()
        sync()
        model = provider.model
        cfg = model.cfg
        out["init"] = {
            "s": time.perf_counter() - t0, "model": provider.model_id,
            "bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
            "params": cfg.param_count(), "layers": cfg.n_layers,
            "index_bytes_before": held}
        queries = unique_queries(concurrency, 50_000)
        chunk_texts = [synth_text(i) for i in range(n_chunk_texts)]
        out["check"] = check_encoder(provider, queries, chunk_texts, depth)
        timed = {}
        for name, texts in (("queries", queries), ("chunks", chunk_texts)):
            tokens = torch.from_numpy(provider.tokenize(texts)).to(device)
            n_tok = tokens.numel()
            ms = cuda_ms(lambda: model(tokens), 5) if cuda else None
            timed[name] = {"batch": tokens.shape[0], "seq": tokens.shape[1],
                           "ms": ms, "bound_ms": encoder_bound_ms(cfg, n_tok)}
        # a backfill batch at its largest bucket: EMBEDDINGS_BATCH_SIZE texts
        # of max_len tokens, beside the index
        long_tokens = torch.randint(1, cfg.vocab_buckets, (
            int(settings.embeddings_batch_size), cfg.max_len), device=device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model(long_tokens)
        sync()
        timed["backfill_batch"] = {
            "batch": long_tokens.shape[0], "seq": long_tokens.shape[1],
            "ms": (time.perf_counter() - t0) * 1e3,
            "bound_ms": encoder_bound_ms(cfg, long_tokens.numel()),
            "held_bytes": torch.cuda.memory_allocated() if cuda else None,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}
        del long_tokens
        out["timed"] = timed

        # 2. /retrieve with the encoder in the request
        fused_scan.launches = 0
        range_topk.launches = 0
        dispatches.take()
        settings.embeddings_provider = "qwen3"
        t0 = time.perf_counter()
        call_id, ids, texts = ingest_texts_as_call(
            "smoke-qwen3-known", [QWEN3_KNOWN_TEXT.format(i=i, t=5200 + i, w=w)
                                  for i, w in enumerate(QWEN3_WORDS)], index)
        backfill = run_embedding_backfill(batch_size=int(settings.embeddings_batch_size),
                                          call_id=call_id, source="chip_smoke")
        ingest_s = time.perf_counter() - t0
        if backfill.model_used != provider.model_id:
            raise RuntimeError(f"the backfill embedded with {backfill.model_used}")
        # the stored texts, embedded again as one query batch, against the rows
        # the backfill wrote into the index: the diagonal is each known row's
        # dense score, the rest its nearest rival among the known rows
        with index.chunks.lock:
            pos = torch.as_tensor(index.chunks.position_of(ids), dtype=torch.int64)
            stored = index.chunks.emb[pos.to(device)].float()
        scores = torch.from_numpy(provider.embed(texts).vectors).to(device) @ stored.T
        rival = scores - 2.0 * torch.eye(len(ids), device=device)
        out["known_rows"] = {"rows": len(ids), "ingest_backfill_s": ingest_s,
                             "model": backfill.model_used,
                             "own_score_min": float(scores.diagonal().min()),
                             "rival_score_max": float(rival.max())}
        port, stop = start_server()
        ids_only = lambda salt: (lambda r: [
            {"query": q, "return_style": "ids_only"}
            for q in unique_queries(concurrency, salt + r)])
        served = {}
        for kind, salt in (("stub", 60_000), ("qwen3", 61_000)):
            settings.embeddings_provider = kind
            http_rounds(port, "/retrieve", ids_only(salt), 1, workdir)
            events.enable()
            try:
                got = http_rounds(port, "/retrieve", ids_only(salt + 100), rounds, workdir)
                embeds = [ev for ev in events.drain() if ev["tag"] == "retrieve.embed"]
            finally:
                events.disable()
            served[kind] = {**round_stats(got),
                            "embed_ms": float(np.mean([ev["s"] for ev in embeds])) * 1e3,
                            "embed_calls": len(embeds),
                            "batches": float(np.mean([ev["batch"] for ev in embeds]))}
        settings.embeddings_provider = "qwen3"
        known = http_rounds(port, "/retrieve", lambda r: [
            {"query": t, "return_style": "ids_only", "debug": True} for t in texts],
            1, workdir)
        dense_first = [d["debug"]["lanes"]["chunks"]["dense"][0]["chunk_id"]
                       if d["debug"]["lanes"]["chunks"].get("dense") else None
                       for _s, _l, d in known[0][1]]
        fused_first = [d["retrieved_ids"][:1] for _s, _l, d in known[0][1]]
        if dense_first != ids:
            raise RuntimeError(f"qwen3: known rows not first in the dense lane: "
                               f"{list(zip(ids, dense_first))}; {out['known_rows']}")
        if fused_first != [[f"chunk:{i}"] for i in ids]:
            raise RuntimeError(f"qwen3: known rows not first: {fused_first}")
        out["served"] = served
        out["known_first"] = len(ids)
        out["launches"] = {"fused_scan": fused_scan.launches,
                           "tech_topk": range_topk.launches}
        out["dispatched"] = sorted(set(dispatches.take()))
        out["corpora"] = {name: {"rows": corpus.capacity, "dim": corpus.dim,
                                 "lex_dim": corpus.lex_dim,
                                 "slots": corpus.tech.shape[1],
                                 "emb_dtype": corpus.emb_dtype}
                          for name, corpus in (("chunks", index.chunks),
                                               ("artifacts", index.artifacts))}

        # 4 (served). (b)-traffic with the cross-encoder, beside the lexical
        # provider (the stub embedder in both)
        settings.embeddings_provider = "stub"
        settings.reranker_params_path = str(RERANKER_ARTIFACT)
        NeuralReranker.reset()
        packs = lambda salt: (lambda r: [
            {"query": q} for q in unique_queries(concurrency, salt + r)])
        settings.rerank_enabled = True
        reranked = {}
        for provider_name, salt in (("lexical", 62_000), ("neural", 63_000)):
            settings.rerank_provider = provider_name
            http_rounds(port, "/retrieve", packs(salt), 1, workdir)
            got = http_rounds(port, "/retrieve", packs(salt + 100), rounds, workdir)
            notes = [d["notes"]["retrieval"] for _w, res in got for _s, _l, d in res]
            if not all((n["reranked_from"] or 0) >= 1 for n in notes):
                raise RuntimeError(f"rerank {provider_name}: an answer was not reranked")
            reranked[provider_name] = {
                **round_stats(got),
                "rerank_ms": float(np.mean([n["timings_ms"]["rerank_ms"] for n in notes])),
                "reranked_from": float(np.mean([n["reranked_from"] for n in notes]))}
        out["rerank"] = reranked
        out["reranker_device"] = str(NeuralReranker.shared().device)
        stop()
        stop = None
    finally:
        if stop is not None:
            stop()
        for key, value in saved.items():
            setattr(settings, key, value)
        Qwen3EmbeddingProvider._instance = None
        NeuralReranker.reset()
        if cuda:
            torch.cuda.empty_cache()
    return out


def paraphrase_mrr(embed):
    """Dense-only MRR of the held-out paraphrase queries over their calls'
    transcripts (``tests/integration/test_neural_provider.py``'s third
    case): ``embed(texts)`` -> (n, dim) unit vectors."""
    from cadence_rag_tpu_torch.evals.train_corpus import (
        EVENTS, generate_calls, train_eval_split,
    )

    _, eval_combos = train_eval_split(seed=0)
    docs, gold_sets, queries = [], [], []
    rng = np.random.default_rng(3)
    for call in generate_calls(eval_combos, seed=1):
        phr = EVENTS[call.event]["summary"]
        queries.append(phr[int(rng.integers(0, len(phr)))].format(svc=call.service))
        gold = set()
        for text in call.transcript:
            if call.service in text:
                gold.add(len(docs))
            docs.append(text)
        gold_sets.append(gold)
    ranks = np.argsort(-(embed(queries) @ embed(docs).T), axis=1)
    total = 0.0
    for qi, gold in enumerate(gold_sets):
        for rank, di in enumerate(ranks[qi], start=1):
            if di in gold:
                total += 1.0 / rank
                break
    return total / len(gold_sets)


def gate_with_ids(device, **kwargs):
    """The real gate, with the ids of every gold query's answer and each
    answer's per-lane ranks and scores (the same queries once more with
    ``debug``, on the gate's own store and index). The calls it ingests
    start one second apart from a fixed date, as the parity tests' clock
    has them: the tech lane ranks by the call's start second, so two runs on
    the wall clock may rank differently. -> outcome"""
    import itertools
    from datetime import datetime, timedelta, timezone

    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.evals import metrics
    from cadence_rag_tpu_torch.evals.fixtures import GOLD_QUERIES
    from cadence_rag_tpu_torch.evals.real_gate import run_gate
    from cadence_rag_tpu_torch.ingest import ingest
    from cadence_rag_tpu_torch.schemas import RetrieveRequest

    seen = {}
    inner, clock = metrics.compute_metrics, ingest.now_utc
    ticks = itertools.count()
    start = datetime(2025, 6, 1, tzinfo=timezone.utc)

    def recording(gold, results, **kw):
        seen["results"] = results
        seen["lanes"] = {query_id: r["debug"]["lanes"] for (query_id, _q, _n), r in zip(
            GOLD_QUERIES, retrieve_evidence_batch([
                RetrieveRequest(query=q, return_style="ids_only", debug=True)
                for _id, q, _n in GOLD_QUERIES]))}
        return inner(gold, results, **kw)

    metrics.compute_metrics = recording
    ingest.now_utc = lambda: start + timedelta(seconds=next(ticks))
    try:
        outcome = run_gate(device=device, **kwargs)
    finally:
        metrics.compute_metrics, ingest.now_utc = inner, clock
    return {**outcome, "results": seen["results"], "lanes": seen["lanes"]}


RRF_K = 60


def _corpus_of(answer_id):
    kind, _, num = answer_id.partition(":")
    return (("chunks", "chunk_id") if kind == "chunk"
            else ("artifacts", "artifact_chunk_id")), num


def lane_ranks(lanes, answer_id):
    """One answer id's (``chunk:N`` / ``artifact_chunk:N``) RRF score from
    the debug lanes' ranks (sum of 1/(60 + rank), in f64 as the host merge
    takes it) and its (rank, score) in each lane that holds it."""
    (corpus, field), num = _corpus_of(answer_id)
    held = {lane: (row["rank"], row["score"]) for lane, rows in lanes[corpus].items()
            for row in rows if str(row[field]) == num}
    return sum(1.0 / (RRF_K + rank) for rank, _score in held.values()), held


def gate_gaps(card, cpu):
    """Where the card's real gate answers otherwise than the CPU's: for each
    such query, the first rank that differs, the two ids there, and each
    id's fused score and lanes on both devices. The gap is the fused score
    between the two rows on each device: a near-tie is a gap of a few f32
    ulps that flips sign between the devices. -> [report]"""
    out = []
    for query_id, want in cpu["results"].items():
        got = card["results"].get(query_id, [])
        if got == want:
            continue
        rank = next(i for i, (a, b) in enumerate(zip(got + [None] * len(want),
                                                      want + [None] * len(got)))
                    if a != b)
        ids = {"card": got[rank] if rank < len(got) else None,
               "cpu": want[rank] if rank < len(want) else None}
        rows = {}
        for side, outcome in (("card", card), ("cpu", cpu)):
            lanes = outcome["lanes"][query_id]
            rows[side] = {which: dict(zip(("fused", "lanes"), lane_ranks(lanes, i)))
                          for which, i in ids.items() if i is not None}
        gap = {side: (r["card"]["fused"] - r["cpu"]["fused"]) if len(r) == 2 else None
               for side, r in rows.items()}
        # a lane that holds an id on one device and not on the other: its
        # last row (the k-th) on each, whose scores a near-tie puts close
        edges = {}
        for which, i in ids.items():
            if i is None:
                continue
            (corpus, field), _num = _corpus_of(i)
            held = {side: set(r[which]["lanes"]) for side, r in rows.items()}
            for lane in held["card"] ^ held["cpu"]:
                last = {side: outcome["lanes"][query_id][corpus][lane][-1]
                        for side, outcome in (("card", card), ("cpu", cpu))}
                edges[f"{corpus}/{lane}"] = {
                    side: [row[field], row["rank"], row["score"]]
                    for side, row in last.items()}
                edges[f"{corpus}/{lane}"]["gap"] = abs(
                    last["card"]["score"] - last["cpu"]["score"])
        out.append({"query": query_id, "rank": rank + 1, "ids": ids, "rows": rows,
                    "fused_gap": gap, "lane_edges": edges})
    return out


EMBED_SERVICE_TEXTS = (
    "the ledger replica fell behind after the failover to the standby region",
    "rolling back to v2.3.1 stopped the resets on billing-api within minutes",
    "we should pin the client library and add retries to the export job",
    "the downgrade fixed the failures on the auth gateway before the release",
    "quota broker throttled the export runner overnight and the queue backed up",
    "search tier latency spiked during the shard move and recovered after noon",
)


def run_embed_service(device, workdir):
    """Step 5: ``serve/embed_service --provider neural`` in a child process on
    the card; a backfill through the port's HTTP provider stores the
    vectors the in-process provider gives. -> summary"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.index import get_index, reset_index
    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu_torch.models.embedder import NeuralEmbeddingProvider
    from cadence_rag_tpu_torch.store.db import get_store, reset_store

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    device = torch.device(device)
    env = child_env()
    env.update(EMBEDDER_PARAMS_PATH=str(EMBEDDER_ARTIFACT), EMBEDDINGS_DIM="1024")
    if device.type == "cpu":
        # one intra-op thread, as the reference below runs: the CPU's f32
        # sums are then reduced in one order on both sides
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD, "cadence_rag_tpu_torch.serve.embed_service",
         "--provider", "neural", "--device", str(device), "--host", "127.0.0.1",
         "--port", str(port)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    saved = {k: getattr(settings, k) for k in (
        "store_path", "embeddings_provider", "embeddings_base_url",
        "embedder_params_path", "embeddings_dim")}
    try:
        def health():
            if child.poll() is not None:
                raise RuntimeError(f"embed_service exited: {child.stderr.read()[-2000:]}")
            try:
                return http_json(port, "GET", "/health", timeout=5)
            except (urllib.error.URLError, ConnectionError, OSError):
                return None
        status, body = wait_for(health, "the embed service", timeout=300)
        ready_s = time.perf_counter() - t0
        settings.store_path = str(workdir / "embed_service.db")
        settings.embeddings_provider = "http"
        settings.embeddings_base_url = f"http://127.0.0.1:{port}"
        settings.embeddings_dim = 1024
        reset_store()
        reset_index()
        get_index(device)
        call_id, ids, _texts = ingest_texts_as_call("smoke-embed-service",
                                                  list(EMBED_SERVICE_TEXTS))
        t0 = time.perf_counter()
        summary = run_embedding_backfill(batch_size=BACKFILL_BATCH, call_id=call_id,
                                         source="chip_smoke")
        backfill_s = time.perf_counter() - t0
        with get_store().read() as conn:
            rows = conn.execute(
                "SELECT chunk_id, text, embedding FROM chunks WHERE call_id = ? "
                "ORDER BY chunk_id", (call_id,)).fetchall()
        stored = np.stack([np.frombuffer(r["embedding"], np.float32) for r in rows])
        settings.embedder_params_path = str(EMBEDDER_ARTIFACT)
        provider = NeuralEmbeddingProvider(device=device)
        texts = [r["text"] for r in rows]
        # the backfill's batches in its order, as the service embedded them
        threads = torch.get_num_threads()
        if device.type == "cpu":
            torch.set_num_threads(1)
        try:
            parts = [provider.embed(texts[i:i + BACKFILL_BATCH])
                     for i in range(0, len(texts), BACKFILL_BATCH)]
        finally:
            torch.set_num_threads(threads)
        local = np.concatenate([np.asarray(p.vectors, np.float32) for p in parts])
        err = float(np.abs(stored - local).max())
        if err > EMBED_SERVICE_ATOL or summary.model_used != parts[0].model:
            raise RuntimeError(f"embed service: stored vectors differ from the "
                               f"in-process provider's by {err:.3g} "
                               f"({summary.model_used} vs {parts[0].model})")
        return {"ready_s": ready_s, "health": body, "rows": len(rows),
                "backfill_s": backfill_s, "model": summary.model_used,
                "max_abs_err": err}
    finally:
        child.terminate()
        try:
            child.wait(30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(30)
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        reset_index()


def run_models_offline(device, workdir, cpu_gate=True):
    """Steps 3, 4's gate and 5 of the models phase, each on a store and an
    index of its own: the committed embedder loaded on ``device`` (its bag
    regenerated there) against the CPU's, the real gate with
    ``provider="neural"`` (with ``cpu_gate``, the first ``GATE_HEAD`` ids of
    every answer the CPU run's), the paraphrase MRR against the stub's; the rerank gate
    over ``two_register_v1.npz``; the /embed service. -> summary"""
    from cadence_rag_tpu_torch.config import settings

    saved_dim = settings.embeddings_dim
    settings.embeddings_dim = 1024      # the committed embedder's width
    try:
        return _models_offline(device, workdir, cpu_gate)
    finally:
        settings.embeddings_dim = saved_dim


def _models_offline(device, workdir, cpu_gate):
    from cadence_rag_tpu_torch.embed.stub import HashEmbeddingProvider
    from cadence_rag_tpu_torch.evals.rerank_gate import run_gate as rerank_gate
    from cadence_rag_tpu_torch.models import embedder as emb

    out = {}
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    model, cfg = emb.load_params(str(EMBEDDER_ARTIFACT), device)
    if cuda:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ref, _cfg = emb.load_params(str(EMBEDDER_ARTIFACT), "cpu")
    texts = list(EMBED_SERVICE_TEXTS)
    tokens = torch.from_numpy(emb.batch_tokenize(texts, cfg))
    out["embedder"] = {
        "load_s": load_s, "device": str(model.device),
        "bag_max_abs_err": float((model.bag_emb.cpu() - ref.bag_emb).abs().max()),
        "max_abs_err": float((model(tokens).cpu() - ref(tokens)).abs().max())}
    embed_neural = lambda ts: model(torch.from_numpy(emb.batch_tokenize(ts, cfg))).cpu().numpy()
    stub = HashEmbeddingProvider()
    embed_stub = lambda ts: np.asarray(stub.embed(ts).vectors, np.float32)
    out["paraphrase_mrr"] = {"neural": paraphrase_mrr(embed_neural),
                             "stub": paraphrase_mrr(embed_stub)}
    if out["paraphrase_mrr"]["neural"] <= out["paraphrase_mrr"]["stub"] + 0.05:
        raise RuntimeError(f"paraphrase MRR: {out['paraphrase_mrr']}")
    del model, ref

    gates = {"card": gate_with_ids(device, provider="neural",
                                   embedder_params_path=str(EMBEDDER_ARTIFACT))}
    card = gates["card"]
    low = {k: card["metrics"][k] for k, floor in GATE_FLOORS.items()
           if card["metrics"][k] < floor}
    if low or card["failures"]:
        raise RuntimeError(f"neural real gate under its floors: {low} {card['failures']}")
    out["gate_neural"] = {"metrics": card["metrics"]}
    if cpu_gate:
        gates["cpu"] = gate_with_ids("cpu", provider="neural",
                                     embedder_params_path=str(EMBEDDER_ARTIFACT))
        cpu, got = gates["cpu"]["results"], card["results"]
        heads = [q for q in cpu if got.get(q, [])[:GATE_HEAD] != cpu[q][:GATE_HEAD]]
        if heads or set(cpu) != set(got):
            raise RuntimeError(f"the neural real gate's first {GATE_HEAD} ids on the "
                               f"card are not the CPU's in {heads}")
        out["gate_neural"].update(
            answers=len(cpu), same_answers=sum(got[q] == cpu[q] for q in cpu),
            cpu_metrics=gates["cpu"]["metrics"],
            gaps=gate_gaps(gates["card"], gates["cpu"]))

    rr = rerank_gate(device=device, params_path=str(RERANKER_ARTIFACT))
    if rr["failures"]:
        raise RuntimeError(f"rerank gate: {rr['failures']}")
    out["rerank_gate"] = {k: v for k, v in rr.items() if k != "workdir"}
    out["embed_service"] = run_embed_service(device, workdir)
    return out


# -- training (ROADMAP Queue 1 item 6b) ------------------------------------------
PARAPHRASE_RECIPE = dict(vocab_buckets=8192, d_model=128, n_layers=2, n_heads=4,
                         d_ff=512, max_len=48, embed_dim=1024)
RERANK_RECIPE = dict(vocab_buckets=8192, d_model=128, n_layers=2, n_heads=4, d_ff=512,
                     max_len=64, prior_residual=True, prior_gain=1.0)
# tests/test_torch_models_cuda.py's tolerances for the card path's gradients
CARD_GRAD_RTOL = 0.1
CARD_LOSS_ATOL = 1e-3
GRAD_FLOOR = 1 / 64
# the gates' runs. At their defaults (600 steps; 800 at prior gain 1.0) the
# JAX package's gates miss their own floors on the CPU (PERF.md, ROADMAP
# Queue 3). The rerank gate takes two_register_v1.npz's recipe (NOTES_DEV.md:
# gain 0.2, 2000 steps). The paraphrase gate takes twice tuned_small_v1.npz's
# 3000 steps: at 3000 one card run in seven missed the margin (0.6464 against
# 0.6474), at 6000 four of four read 0.748-0.810
PARAPHRASE_GATE_KW = dict(steps=6000)
RERANK_GATE_KW = dict(steps=2000, prior_gain=0.2)
CPU_STEPS = 20
# scripts/train_embedder.py's CLI defaults
TRAIN_CLI = dict(steps=200, batch=32, lr=1e-4, d_model=256, n_layers=4,
                 vocab_buckets=32768, max_len=64, seed=0, entity_swap_p=0.5)
GEOMETRY_N = 1_000_000
GEOMETRY_QUERIES = 256
GEOMETRY_FLOORS = {"ann_recall": 0.95, "int8_eps_recall": 0.99}
ADAMW_BYTES = 7 * 4     # reads p, g, mu, nu and writes p, mu, nu, f32 each


def recipe_texts(seed):
    """One batch of 32 from the paraphrase corpus: (summaries, their calls'
    first transcript lines, another call's line)."""
    from cadence_rag_tpu_torch.evals.train_corpus import generate_calls, train_eval_split

    calls = generate_calls(train_eval_split(seed=0)[0], seed=0)
    pick = np.random.default_rng(seed).choice(len(calls), 32, replace=False)
    return ([calls[i].summary for i in pick], [calls[i].transcript[0] for i in pick],
            [calls[(i + 1) % len(calls)].transcript[0] for i in pick])


def card_against_plain(model, loss_of):
    """The loss and every leaf's gradient on the card path and the plain
    path. -> {"loss", "loss_diff", "rel": {leaf: max |card - plain| / max
    |plain|}, "held": {leaf: max |card - plain| / max(max |plain|,
    GRAD_FLOOR x the model's largest |plain|)}, "max_held"}"""
    from cadence_rag_tpu_torch.models import embedder as emb

    losses, grads = [], []
    for plain in (False, True):
        loss = loss_of(plain)
        losses.append(float(loss.detach()))
        grads.append(emb.gradients(model, loss))
    diff = {name: float((grads[0][name] - g).abs().max())
            for name, g in grads[1].items() if g is not None}
    scale = {name: float(grads[1][name].abs().max()) for name in diff}
    top = max(scale.values())
    rel = {name: d / max(scale[name], 1e-30) for name, d in diff.items()}
    held = {name: d / max(scale[name], GRAD_FLOOR * top) for name, d in diff.items()}
    return {"loss": losses[1], "loss_diff": abs(losses[0] - losses[1]), "rel": rel,
            "held": held, "max_held": max(held.values()), "grad_max": top}


def check_training_gradients(device):
    """Step 1: both models' card-path gradients against the plain path's on
    one batch of each gate's recipe."""
    from cadence_rag_tpu_torch.models import embedder as emb
    from cadence_rag_tpu_torch.models import prng, reranker

    anchors, positives, negatives = recipe_texts(seed=5)
    cfg = emb.EmbedderConfig(**PARAPHRASE_RECIPE)
    model = emb.trainable(emb.init_params(cfg, prng.PRNGKey(0), device))
    a, p, n = (torch.from_numpy(emb.batch_tokenize(t, cfg))
               for t in (anchors, positives, negatives))
    out = {"embedder": card_against_plain(
        model, lambda plain: emb.info_nce_loss(model, a, p, negatives=n, plain=plain))}
    rcfg = reranker.RerankerConfig(**RERANK_RECIPE)
    model = emb.trainable(reranker.init_params(rcfg, prng.PRNGKey(0), device))
    hi = np.stack([reranker.pair_tokenize(q, d, rcfg) for q, d in zip(anchors, positives)])
    lo = np.stack([reranker.pair_tokenize(q, d, rcfg) for q, d in zip(anchors, negatives)])
    prior = np.random.default_rng(6).normal(size=(2, 32)).astype(np.float32)
    out["reranker"] = card_against_plain(
        model, lambda plain: reranker.pairwise_loss(model, hi, lo, prior[0], prior[1], plain))
    for name, r in out.items():
        if r["loss_diff"] > CARD_LOSS_ATOL or r["max_held"] > CARD_GRAD_RTOL:
            raise RuntimeError(f"{name}: card gradients off the plain path's: {r}")
    return out


def encoder_step_flops(recipe, sequences, seq_len, head_dim):
    """Operations of one training step (forward, and a backward of twice
    its products) of the encoder of ``recipe`` over ``sequences`` x
    ``seq_len`` tokens, the full L x L attention products included, and a
    (d_model x ``head_dim``) head on each pooled row."""
    d, f = recipe["d_model"], recipe["d_ff"]
    per_token = recipe["n_layers"] * (2 * d * (3 * d + d + 2 * f) + 4 * seq_len * d)
    return 3.0 * sequences * (seq_len * per_token + 2 * d * head_dim)


def n_params_of(recipe, embed_dim):
    """Every leaf's elements: embeddings, blocks, the head, the bag head
    (vocab x ``embed_dim``) and ``mix``."""
    v, d, f = recipe["vocab_buckets"], recipe["d_model"], recipe["d_ff"]
    return (v * d + recipe["max_len"] * d + 2 * d + d * embed_dim + v * embed_dim + 2
            + recipe["n_layers"] * (4 * d + 4 * d * d + 2 * d * f))


def step_bound_ms(flops, n_params):
    """The larger of the step's products at the bf16 dense peak and
    AdamW's bytes at the HBM rate. -> (ms, "operations" | "bytes")"""
    by_ops = flops / (BF16_PEAK_TFLOPS * 1e12) * 1e3
    by_bytes = n_params * ADAMW_BYTES / (HBM_PEAK_GBS * 1e9) * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")


def step_ms(history):
    """Mean ms a step after the first (each step waited for)."""
    return (history[-1]["t"] - history[0]["t"]) / (len(history) - 1) * 1e3


def fixture_pairs():
    """The real gate's fixture calls as rerank pairs: each call's title
    against its utterances, with seeded priors."""
    from cadence_rag_tpu_torch.evals.fixtures import FIXTURE_CALLS

    rng = np.random.default_rng(9)
    return [(title, texts, rng.normal(size=len(texts)).astype(np.float32))
            for title, _ext, texts, _arts in FIXTURE_CALLS]


def run_training(device, workdir):
    """The training phase, on stores of its own: card gradients against
    plain; the paraphrase gate at its defaults (and the first CPU_STEPS
    steps of the same training on the CPU); the rerank gate's training
    branch at its defaults, its artifact reloaded into ``NeuralReranker``;
    ``train`` at ``scripts/train_embedder.py``'s CLI defaults; the geometry
    gate at GEOMETRY_N rows through K1. -> summary"""
    from cadence_rag_tpu_torch.config import settings

    saved_dim = settings.embeddings_dim
    settings.embeddings_dim = 1024      # the gates' and the CLI's width
    try:
        out = {"gradients": check_training_gradients(device)}
        out.update(run_training_gates(device, workdir))
    finally:
        settings.embeddings_dim = saved_dim
    torch.cuda.empty_cache()
    out["geometry"] = run_geometry(device)
    return out


def run_training_gates(device, workdir):
    """Steps 2-4 of the training phase."""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.evals import paraphrase_gate, rerank_gate
    from cadence_rag_tpu_torch.models import reranker
    from cadence_rag_tpu_torch.scripts import train_embedder

    out = {}
    # 2. the paraphrase gate; its pairs and training arguments are kept for
    # the CPU's steps and the CLI-default run
    seen, inner = {}, train_embedder.train

    def keep(pairs, negatives, **kwargs):
        seen.update(pairs=pairs, negatives=negatives, kwargs=kwargs)
        return inner(pairs, negatives, **kwargs)

    hist = []
    train_embedder.train = keep
    try:
        t0 = time.perf_counter()
        gate = paraphrase_gate.run_gate(device=device, history=hist, **PARAPHRASE_GATE_KW)
        gate_s = time.perf_counter() - t0
    finally:
        train_embedder.train = inner
    cpu_hist = []
    inner(seen["pairs"], seen["negatives"], **{
        **seen["kwargs"], "steps": CPU_STEPS, "device": "cpu", "history": cpu_hist,
        "out_path": str(workdir / "cpu_steps.npz")})
    bound, bound_by = step_bound_ms(encoder_step_flops(PARAPHRASE_RECIPE, 3 * 32, 48, 1024),
                                    n_params_of(PARAPHRASE_RECIPE, 1024))
    out["paraphrase"] = {
        **{k: v for k, v in gate.items() if k != "workdir"}, "s": gate_s,
        "steps": len(hist), "ms_per_step": step_ms(hist), "bound_ms": bound,
        "bound_by": bound_by, "losses": [h["loss"] for h in hist[:CPU_STEPS]],
        "cpu_losses": [h["loss"] for h in cpu_hist]}
    if gate["failures"]:
        raise RuntimeError(f"paraphrase gate: {gate['failures']}")

    # 3. the rerank gate's training branch; the model as training left it
    # scores the fixture pairs when it is saved
    at_save, save = {}, reranker.save_params

    def score_at_save(path, model):
        at_save["scores"] = [
            reranker.score_pairs(model, np.stack([reranker.pair_tokenize(
                q, d, model.rerank_cfg) for d in docs]), prior).cpu().numpy()
            for q, docs, prior in fixture_pairs()]
        return save(path, model)

    rr_hist, artifact = [], workdir / "rerank_gate.npz"
    reranker.save_params = score_at_save
    try:
        t0 = time.perf_counter()
        rr = rerank_gate.run_gate(device=device, save_path=str(artifact), history=rr_hist,
                                  **RERANK_GATE_KW)
        rr_s = time.perf_counter() - t0
    finally:
        reranker.save_params = save
    if rr["failures"]:
        raise RuntimeError(f"rerank gate (training): {rr['failures']}")
    saved_path = settings.reranker_params_path
    settings.reranker_params_path = str(artifact)
    try:
        served = reranker.NeuralReranker(device=device)
        reload_err = max(float(np.abs(served.score(q, docs, prior) - want).max())
                         for (q, docs, prior), want in zip(fixture_pairs(), at_save["scores"]))
    finally:
        settings.reranker_params_path = saved_path
    if reload_err > 1e-5:
        raise RuntimeError(f"the saved reranker scores {reload_err} off the trained model")
    bound, bound_by = step_bound_ms(encoder_step_flops(RERANK_RECIPE, 2 * 32, 64, 1),
                                    n_params_of(RERANK_RECIPE, 1))
    out["rerank"] = {**{k: v for k, v in rr.items() if k != "workdir"}, "s": rr_s,
                     "steps": len(rr_hist), "ms_per_step": step_ms(rr_hist),
                     "bound_ms": bound, "bound_by": bound_by, "reload_err": reload_err}

    # 4. train at the CLI's defaults over the gate's pairs
    cli_hist = []
    t0 = time.perf_counter()
    train_embedder.train(seen["pairs"], seen["negatives"], out_path=str(workdir / "cli.npz"),
                         device=device, history=cli_hist, **TRAIN_CLI)
    cli_s = time.perf_counter() - t0
    cli = dict(TRAIN_CLI, d_ff=4 * TRAIN_CLI["d_model"])
    bound, bound_by = step_bound_ms(encoder_step_flops(cli, 3 * 32, 64, 1024),
                                    n_params_of(cli, 1024))
    out["train_cli"] = {"s": cli_s, "steps": len(cli_hist), "ms_per_step": step_ms(cli_hist),
                        "bound_ms": bound, "bound_by": bound_by,
                        "first_loss": cli_hist[0]["loss"], "final_loss": cli_hist[-1]["loss"]}
    return out


def run_geometry(device):
    """Step 5: the geometry gate at GEOMETRY_N rows over the committed
    embedder's vectors, its ann lane through K1, and K1 against its plain
    version at the shape the gate launched it with."""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.engine.planner import recall_target_for_ef_search
    from cadence_rag_tpu_torch.evals import geometry_gate
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan, fused_scan_plain

    timings = {}
    t0 = time.perf_counter()
    docs, queries = geometry_gate.embedder_geometry(
        GEOMETRY_N, GEOMETRY_QUERIES, 0, str(EMBEDDER_ARTIFACT), device, timings)
    fused_scan.launches = 0
    geo = geometry_gate.run_gates(
        docs, queries, 10, recall_target_for_ef_search(settings.embeddings_hnsw_ef_search),
        device=device)
    launches = fused_scan.launches
    geo_s = time.perf_counter() - t0
    if launches <= 0:
        raise RuntimeError("the geometry gate did not launch K1")
    low = {k: geo[k] for k, floor in GEOMETRY_FLOORS.items() if geo[k] < floor}
    if low:
        raise RuntimeError(f"geometry gate under its floors: {low}")
    n = docs.shape[0]
    rows = docs.to(torch.bfloat16)
    del docs
    q = queries[:64]
    mask = torch.ones((q.shape[0], n), dtype=torch.bool, device=device)
    args = (q, torch.zeros((q.shape[0], 32), dtype=torch.float32, device=device), rows,
            torch.zeros((n, 32), dtype=torch.int8, device=device), mask,
            torch.ones(n, dtype=torch.bool, device=device))
    got = fused_scan(*args, dense=True)
    torch.cuda.synchronize()
    want = fused_scan_plain(*args, dense=True)
    k1 = check_lane(got[0], got[1], want[0], want[1],
                    (q.to(torch.bfloat16).float(), rows, 1.0, mask, n), DENSE_ATOL)
    del rows, mask, got, want, args
    torch.cuda.empty_cache()
    return {**geo, "timings": timings, "s": geo_s, "launches": launches,
            "k1": {"batch": int(q.shape[0]), "rows": n, **k1}}


# -- parallel: the row-sharded index ------------------------------------------
PARALLEL_SPEC = "data:2"
EXACT_ATOL = 1e-5                # exact dense lane: one cuBLAS product per N


def shard_launches():
    """{"<corpus>/<shard>": {"fused_scan": n, "tech_topk": n}} of the index
    path since the tally was last cleared (``parallel/sharded.py``)."""
    from cadence_rag_tpu_torch.parallel import sharded

    return {f"{corpus}/{shard}": dict(tally) for (corpus, shard), tally
            in sorted(sharded.launches_by_shard.items())}


@contextlib.contextmanager
def off_the_tally():
    """Launches inside (timing repeats, comparisons) are not the main
    path's: the per-shard tally and K1's and K3's counts are restored after
    them."""
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk
    from cadence_rag_tpu_torch.parallel import sharded

    saved = {key: collections.Counter(t) for key, t in sharded.launches_by_shard.items()}
    counts = fused_scan.launches, range_topk.launches
    try:
        yield
    finally:
        sharded.launches_by_shard.clear()
        sharded.launches_by_shard.update(saved)
        fused_scan.launches, range_topk.launches = counts


def packed_flat(index, args, modes, fuse):
    """One dispatch, collected -> (the flat output, the collected lanes)"""
    disp = index.query_both_packed_async(
        *args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS, chunk_mode=modes[0],
        artifact_mode=modes[1], recall_target=0.95, fuse_rrf=fuse)
    out = index.collect_packed(disp)
    return disp.flat_host.numpy().copy(), out


def compare_lanes(got, want, sig, exact_dense):
    """Lane by lane, the sharded index's flat output against the unsharded
    one's: bit-identical, or for the exact dense lane scores within
    EXACT_ATOL with the ids identical except at near-ties (positions whose
    two ids differ while their scores agree within EXACT_ATOL).
    -> {lane: (positions compared, near-ties)}"""
    from cadence_rag_tpu_torch.ops.pack import unflatten_lanes

    layout = dict(chunk_ks=sig.chunk_ks, artifact_ks=sig.artifact_ks,
                  chunk_mode=sig.chunk_mode, artifact_mode=sig.artifact_mode,
                  dense_enabled=sig.dense_enabled)
    g_lanes, w_lanes = unflatten_lanes(got, **layout), unflatten_lanes(want, **layout)
    out = {}
    for corpus, g_corpus, w_corpus in zip(("chunks", "artifacts"), g_lanes, w_lanes):
        for lane, (w_vals, w_pos) in w_corpus.items():
            g_vals, g_pos = g_corpus[lane]
            name = f"{corpus}/{lane}"
            if lane == "dense" and exact_dense:
                finite = np.isfinite(w_vals)
                if not np.array_equal(finite, np.isfinite(g_vals)):
                    raise RuntimeError(f"{name}: finite entries differ")
                err = float(np.abs(g_vals[finite] - w_vals[finite]).max(initial=0.0))
                moved = finite & (g_pos != w_pos)
                if err > EXACT_ATOL:
                    raise RuntimeError(f"{name}: scores differ by {err:.3g}")
                out[name] = (int(finite.sum()), int(moved.sum()), err)
                continue
            if not (np.array_equal(g_vals.view(np.int32), w_vals.view(np.int32))
                    and np.array_equal(g_pos, w_pos)):
                bad = np.argwhere((g_pos != w_pos) | (g_vals.view(np.int32)
                                                      != w_vals.view(np.int32)))
                raise RuntimeError(f"{name}: the sharded lane is not the unsharded "
                                   f"one's, e.g. at {bad[0].tolist()}")
            out[name] = (int(w_pos.size), 0, 0.0)
    return out


def recall_at(got_pos, want_pos, k=10):
    """Mean share of the exact top-k positions a lane's top-k holds."""
    return float(np.mean([len(set(g[:k].tolist()) & set(w[:k].tolist())) / k
                          for g, w in zip(got_pos, want_pos)]))


def engine_known_answers(index, texts, batch, workdir, ivf=False):
    """The known rows' texts as ``batch`` unscoped ids_only requests through
    the engine (``retrieve_evidence_batch``) with ``index`` as the
    process-wide index and a store of its own under ``workdir`` (unfiltered
    ids_only reads none of its rows). -> retrieved_ids per request"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.schemas import RetrieveRequest
    from cadence_rag_tpu_torch.store.db import reset_store

    overrides = {"store_path": str(workdir / "engine.db"), "dense_ivf_enabled": ivf,
                 "embeddings_provider": "stub", "embeddings_base_url": ""}
    saved = {key: getattr(settings, key) for key in overrides}
    saved_index = core_index._index
    for key, value in overrides.items():
        setattr(settings, key, value)
    reset_store()
    try:
        core_index._index = index
        return [r["retrieved_ids"] for r in retrieve_evidence_batch([
            RetrieveRequest(query=texts[j % len(texts)], return_style="ids_only")
            for j in range(batch)])]
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        core_index._index = saved_index
        reset_store()


def check_engine_alike(full, sh, texts, batch, workdir, what, ivf=False):
    """The engine's answers on the sharded index: the unsharded index's, and
    every known row first."""
    got = engine_known_answers(sh, texts, batch, workdir, ivf)
    if got != engine_known_answers(full, texts, batch, workdir, ivf):
        raise RuntimeError(f"parallel {what}: the engine answers otherwise sharded")
    wrong = [j for j, ids in enumerate(got)
             if ids[:1] != [f"chunk:{KNOWN_ID0 + j % len(texts)}"]]
    if wrong:
        raise RuntimeError(f"parallel {what}: known row not first through the "
                           f"engine for {len(wrong)} requests, e.g. {got[wrong[0]][:3]}")
    return len(got)


def silent_doc_rows(n, first_id):
    """Rows that match no query (no embedding, empty signature and tech
    slots): growth moves them, and once tombstoned they change no answer."""
    from cadence_rag_tpu_torch.core.index import DocRow
    from cadence_rag_tpu_torch.config import settings

    lex = np.zeros(int(settings.lexical_dim), dtype=np.int8)
    tech = np.zeros(int(settings.tech_hash_slots), dtype=np.int32)
    return [DocRow(doc_id=first_id + i, call_seq=0, started_sec=1_700_000_000,
                   lex_sig=lex, lex_dl=0, lex_touched=np.zeros(0, np.int32),
                   tech=tech, embedding=None) for i in range(n)]


def time_sharded_program(full, sh, args, modes, batch, device):
    """Device times of one packed batch: the sharded program and its halves
    (each shard's lanes; the gather + merge + RRF + flatten) beside the
    unsharded program. -> {name: ms}"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.index import _stage
    from cadence_rag_tpu_torch.ops.pack import (
        dual_corpus_retrieve_packed, pack_queries, sparse_lex_rows,
    )
    from cadence_rag_tpu_torch.parallel import sharded

    F = int(settings.query_lex_features)
    packed = _stage(pack_queries(
        args[0], sparse_lex_rows(args[1], sh.chunks.doc_freq,
                                 sh.chunks.live_count, F),
        sparse_lex_rows(args[1], sh.artifacts.doc_freq,
                        sh.artifacts.live_count, F),
        *args[2:]), device)
    statics = dict(batch=batch, emb_dim=sh.chunks.dim, q_feats=F,
                   tech_q=args[2].shape[1], n_calls=args[3].shape[1],
                   chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS,
                   chunk_mode=modes[0], artifact_mode=modes[1],
                   dense_enabled=True)
    local = sharded.packed_lanes(sh.chunks, sh.artifacts, packed, **statics)
    return {
        "lanes_ms": cuda_ms(
            lambda: sharded.packed_lanes(sh.chunks, sh.artifacts, packed,
                                         **statics), 5),
        "merge_ms": cuda_ms(
            lambda: sharded.packed_merge(local, sh.chunks.mesh, chunk_ks=CHUNK_KS,
                                         artifact_ks=ARTIFACT_KS, fuse_rrf=True), 20),
        "unsharded_program_ms": cuda_ms(
            lambda: dual_corpus_retrieve_packed(
                full.chunks.device_arrays(), full.artifacts.device_arrays(),
                packed, fuse_rrf=True, **statics), 5),
        "sharded_program_ms": cuda_ms(
            lambda: sharded.packed_query(sh.chunks, sh.artifacts, packed,
                                         fuse_rrf=True, **statics), 5),
    }


def run_parallel_local(device, full, batches, ivf_args, ivf_modes, batch, n_known,
                       workdir, turns=3):
    """(a) One process, ``PARALLEL_SPEC`` over ``[device, device]``: the main
    path's rows copied into a sharded index, then its batches (unscoped
    ``ann``, scoped ``exact``) and the ivf batch held to the unsharded
    index ``full``; the sharded IVF build's recall beside the unsharded
    one's; a growth of the artifacts past capacity; a v2 save and a restore
    into a fresh sharded index. -> summary"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.checkpoint import restore_index, save_index
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager
    from cadence_rag_tpu_torch.evals.synth import install_sharded_copy
    from cadence_rag_tpu_torch.ops.topk import dense_scores, masked_topk_exact
    from cadence_rag_tpu_torch.parallel import sharded
    from cadence_rag_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = make_mesh(PARALLEL_SPEC, [device, device])
    summary = {"mesh": PARALLEL_SPEC}
    t0 = time.perf_counter()
    sh = DeviceIndexManager(device, mesh=mesh)
    sh.ensure_call_capacity(full.call_capacity)
    install_sharded_copy(full.chunks, sh.chunks)
    install_sharded_copy(full.artifacts, sh.artifacts)
    sync()
    summary["copy_s"] = time.perf_counter() - t0
    summary["shard_rows"] = {"chunks": sh.chunks.shard_rows,
                             "artifacts": sh.artifacts.shard_rows}
    dispatches = DispatchLog(sh)
    sharded.launches_by_shard.clear()
    for name, args, modes, expected in batches:
        exact = modes[0] == "exact"
        got, out = packed_flat(sh, args, modes, True)
        check_first(out, expected, f"parallel {name}")
        want, _ = packed_flat(full, args, modes, True)
        if not exact and not np.array_equal(got, want):
            raise RuntimeError(f"parallel {name}: the fused output is not the "
                               "unsharded index's")
        g_lanes, _ = packed_flat(sh, args, modes, False)
        w_lanes, _ = packed_flat(full, args, modes, False)
        disp = sh.query_both_packed_async(
            *args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS, chunk_mode=modes[0],
            artifact_mode=modes[1], recall_target=0.95, fuse_rrf=False)
        sh.collect_packed(disp)
        summary[name] = {"modes": modes, "fused_identical": bool(np.array_equal(got, want)),
                         "lanes": compare_lanes(g_lanes, w_lanes, disp.sig, exact)}
        # batch times: the unsharded and the sharded index in turns
        times = {"unsharded": [], "sharded": []}
        for which in ("unsharded", "sharded", "sharded", "unsharded") * turns:
            idx = full if which == "unsharded" else sh
            sync()
            t = time.perf_counter()
            serve_batch(idx, args, modes)
            sync()
            times[which].append((time.perf_counter() - t) * 1e3)
        summary[name]["batch_ms"] = times
        if cuda:
            with off_the_tally():
                summary[name].update(time_sharded_program(
                    full, sh, args, modes, batch, device))
    texts, _tokens = known_rows(n_known)
    summary["engine_ann"] = check_engine_alike(full, sh, texts, batch, workdir, "ann")
    summary["launches"] = shard_launches()
    summary["dispatched"] = dispatches.take()

    # ivf: the unsharded build's state serves the same ids sharded
    sh.chunks.load_ivf_state(full.chunks.ivf)
    expected = np.array([KNOWN_ID0 + j % n_known for j in range(batch)])
    got, g_out = packed_flat(sh, ivf_args, ivf_modes, True)
    want, w_out = packed_flat(full, ivf_args, ivf_modes, True)
    check_first_lanes(g_out, expected, "parallel ivf")
    for lane in ("dense", "lex", "tech"):
        if not np.array_equal(g_out[0][lane][0], w_out[0][lane][0]):
            raise RuntimeError(f"parallel ivf: chunk {lane} ids differ from the "
                               "unsharded index's")
    dispatches.take()
    summary["engine_ivf"] = check_engine_alike(full, sh, texts, batch, workdir, "ivf",
                                               ivf=True)
    if {(cm, dense) for cm, _am, _b, dense, _w in dispatches.calls} != {("ivf", True)}:
        raise RuntimeError(f"parallel ivf: the engine planned {dispatches.calls[:2]}")
    # the sharded build (its k-means reads both shards) beside the unsharded
    # one, by recall@10 of the dense lane against the exact scan
    q = torch.from_numpy(ivf_args[0]).to(device)
    n = full.chunks.count
    exact = masked_topk_exact(
        dense_scores(q, full.chunks.emb[:n]),
        (full.chunks.started[:n] != INT32_MIN)[None, :].expand(q.shape[0], n)
        & full.chunks.has_emb[None, :n], 10)[1].cpu().numpy()
    allowed = np.ones((batch, sh.call_capacity), bool)
    dmin = np.full(batch, INT32_MIN + 1, np.int32)
    dmax = np.full(batch, INT32_MAX, np.int32)
    flat_recall = recall_at(
        full.chunks.ivf_dense_query(ivf_args[0], allowed, dmin, dmax, 10)[1].cpu().numpy(),
        exact)
    if cuda:
        # the ivf dense lane on one state: each shard gathers and scores the
        # whole probed candidate list (the rows it does not own masked)
        lane_ms = {which: cuda_ms(lambda: idx.chunks.ivf_dense_query(
            ivf_args[0], allowed, dmin, dmax, CHUNK_KS[0]), 5)
            for which, idx in (("unsharded", full), ("sharded", sh))}
        summary["ivf_lane_ms"] = lane_ms
    sync()
    t = time.perf_counter()
    state = sh.chunks.build_ivf()
    sync()
    summary["ivf"] = {
        "ids_identical": True, "build_s": time.perf_counter() - t,
        "clusters": state.n_clusters, "nprobe": state.nprobe,
        "recall_sharded_build": recall_at(
            sh.chunks.ivf_dense_query(ivf_args[0], allowed, dmin, dmax, 10)[1]
            .cpu().numpy(), exact),
        "recall_unsharded_build": flat_recall}

    summary["dispatched"] += dispatches.take()

    # growth past the artifacts' capacity: rows move between the shards
    cap0, rows0 = sh.artifacts.capacity, sh.artifacts.count
    extra = cap0 - rows0 + 1
    silent = silent_doc_rows(extra, int(full.artifacts.h_ids[:rows0].max()) + 1)
    sync()
    t = time.perf_counter()
    sh.artifacts.insert(silent)
    sync()
    summary["growth"] = {"corpus": "artifact_chunks", "old_capacity": cap0,
                         "capacity": sh.artifacts.capacity, "rows": sh.artifacts.count,
                         "insert_s": time.perf_counter() - t}
    if sh.artifacts.capacity <= cap0:
        raise RuntimeError("parallel: the artifacts did not grow")
    # tombstoned again: the live count (the lexical idf) is the unsharded
    # index's once more, so its answers must be too
    sh.artifacts.delete_ids([r.doc_id for r in silent])
    for name, args, modes, expected in batches:
        got, out = packed_flat(sh, args, modes, True)
        check_first(out, expected, f"parallel {name} after growth")
        want, _ = packed_flat(full, args, modes, True)
        if modes[0] != "exact" and not np.array_equal(got, want):
            raise RuntimeError(f"parallel {name}: answers changed across the growth")
    summary["dispatched_grown"] = dispatches.take()

    # a v2 save of the sharded index, restored into a fresh sharded index
    ckpt = workdir / "parallel_v2"
    t = time.perf_counter()
    meta = save_index(str(ckpt), sh)
    save_s = time.perf_counter() - t
    fresh = DeviceIndexManager(device, mesh=mesh)
    t = time.perf_counter()
    restore_index(str(ckpt), fresh)
    sync()
    restore_s = time.perf_counter() - t
    shutil.rmtree(ckpt, ignore_errors=True)
    for name, args, modes, expected in batches:
        got, out = packed_flat(fresh, args, modes, True)
        check_first(out, expected, f"parallel {name} restored")
        want, _ = packed_flat(sh, args, modes, True)
        if not np.array_equal(got, want):
            raise RuntimeError(f"parallel {name}: the restored sharded index "
                               "answers otherwise")
    summary["checkpoint"] = {"format": meta["format_version"], "save_s": save_s,
                             "restore_s": restore_s,
                             "rows": {k: int(v) for k, v in meta["counts"].items()}}
    summary["corpora"] = {
        name: {"rows": c.shard_rows, "dim": c.dim, "lex_dim": c.lex_dim,
               "slots": c.tech_slots, "emb_dtype": c.emb_dtype}
        for name, c in (("chunks", sh.chunks), ("artifacts", sh.artifacts))}
    # the shapes the growth left: the artifacts' shards doubled
    summary["corpora_before_growth"] = dict(summary["corpora"])
    summary["corpora_before_growth"]["artifacts"] = dict(
        summary["corpora"]["artifacts"], rows=cap0 // 2)
    del sh, fresh
    if cuda:
        torch.cuda.empty_cache()
    return summary


def synthetic_shards(device, n, dim, lex_dim, slots, seed, rows_per=131072):
    """Checkpoint-shaped slabs of ``n`` synthetic rows (doc ids 1..n), made
    on ``device`` and handed over as host arrays, for
    ``CorpusIndex.load_state_streaming``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for r0 in range(0, n, rows_per):
        m = min(rows_per, n - r0)
        x = torch.randn((m, dim), generator=g, device=device)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        yield {
            "emb": x.to(torch.bfloat16).cpu(),
            "lex": torch.randint(-4, 5, (m, lex_dim), generator=g, device=device,
                                 dtype=torch.int8).cpu().numpy(),
            "tech": torch.randint(1, 5000, (m, slots), generator=g, device=device,
                                  dtype=torch.int32).cpu().numpy(),
            "ids": np.arange(r0 + 1, r0 + m + 1, dtype=np.int64),
            "call": torch.randint(0, N_CALLS, (m,), generator=g, device=device,
                                  dtype=torch.int32).cpu().numpy(),
            "started": torch.randint(1_600_000_000, 1_750_000_000, (m,), generator=g,
                                     device=device, dtype=torch.int32).cpu().numpy(),
            "has_emb": np.ones(m, dtype=bool),
        }


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(device, n_chunks, n_artifacts, workdir, concurrency=128, rounds=10):
    """(b) A two-process gang on ``device``'s one card: this process is the
    leader, started through ``serve.api.startup`` (what ``serve.http``
    runs) with the ``DIST_*`` settings and ``MESH_SHAPE`` ``PARALLEL_SPEC``,
    and serves ``serve.http``'s app; the follower is
    ``python -m cadence_rag_tpu_torch.serve.http`` in a child process. The
    rows go through the leader's index (``load_state_streaming``, as a
    restore does), so every row reaches the follower over the op-log; the
    store gets the matching rows and the known rows are ingested. Over
    HTTP: ids_only and packs, the known rows' queries, a DELETE, then a
    compaction of both corpora and ids_only again; a v3 gang save,
    restored into a one-process index served the same way, must answer
    alike. -> summary"""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.core.checkpoint import restore_index, save_index
    from cadence_rag_tpu_torch.evals.synth import bulk_store_rows
    from cadence_rag_tpu_torch.ingest.sync import reset_syncer
    from cadence_rag_tpu_torch.parallel import mesh as mesh_mod
    from cadence_rag_tpu_torch.parallel import oplog, sharded
    from cadence_rag_tpu_torch.serve.api import startup
    from cadence_rag_tpu_torch.store.db import get_store, reset_store

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    coord = f"127.0.0.1:{free_port()}"
    overrides = {"store_path": str(workdir / "gang.db"),
                 "embeddings_provider": "stub", "embeddings_base_url": "",
                 "retrieve_batch_window_ms": 5, "store_sync_interval_s": 0.0,
                 "log_level": "WARNING", "mesh_shape": PARALLEL_SPEC,
                 "dist_coordinator": coord, "dist_num_processes": 2,
                 "dist_process_id": 0, "dist_oplog_port": free_port()}
    saved = {key: getattr(settings, key) for key in overrides}
    for key, value in overrides.items():
        setattr(settings, key, value)
    env = child_env()
    env.update({"STORE_PATH": str(workdir / "follower.db"), "LOG_LEVEL": "INFO",
                "MESH_SHAPE": PARALLEL_SPEC, "DIST_COORDINATOR": coord,
                "DIST_NUM_PROCESSES": "2", "DIST_PROCESS_ID": "1",
                "DIST_OPLOG_PORT": str(overrides["dist_oplog_port"])})
    follower_log = workdir / "follower.log"
    follower = subprocess.Popen(
        [sys.executable, "-c", CHILD, "cadence_rag_tpu_torch.serve.http",
         "--device", device.type, "--port", str(free_port())],
        env=env, stdout=open(follower_log, "w"), stderr=subprocess.STDOUT)
    stop = None
    summary = {"mesh": PARALLEL_SPEC}
    try:
        reset_store()
        core_index.reset_index()
        reset_syncer()
        sharded.launches_by_shard.clear()
        t0 = time.perf_counter()
        startup(device.type)
        gang = mesh_mod.gang()
        summary["startup_s"] = time.perf_counter() - t0
        summary["backend"] = gang.backend
        index = core_index.get_index()
        log = oplog.leader()
        sent0 = log.bytes_sent
        t0 = time.perf_counter()
        for corpus, n, seed in ((index.chunks, n_chunks, 0),
                                (index.artifacts, n_artifacts, 1)):
            rng = np.random.default_rng(seed)
            corpus.load_state_streaming(
                synthetic_shards(device, n, corpus.dim, corpus.lex_dim,
                                 corpus.tech_slots, seed),
                rng.integers(1, max(n // 4, 2), size=corpus.lex_dim).astype(np.int64),
                12 * n, n)
        sync()
        load_s = time.perf_counter() - t0
        summary["oplog_load"] = {"s": load_s, "bytes": log.bytes_sent - sent0,
                                 "gbs": (log.bytes_sent - sent0) / load_s / 1e9,
                                 "rows": n_chunks + n_artifacts}
        index.ensure_call_capacity(N_CALLS)
        t0 = time.perf_counter()
        with get_store().read() as conn:
            conn.execute("PRAGMA cache_size = -1048576")
        bulk_store_rows(get_store(), n_chunks, n_artifacts, N_CALLS)
        known_call, known_texts, known_ids = ingest_known_rows(N_KNOWN)
        summary["store_s"] = time.perf_counter() - t0
        port, stop = start_server()
        ids_only = lambda salt: (lambda r: [
            {"query": q, "return_style": "ids_only"}
            for q in unique_queries(concurrency, salt + r)])
        known = lambda r: [{"query": t, "return_style": "ids_only"} for t in known_texts]

        def known_first(tag):
            got = [res[2]["retrieved_ids"][:1]
                   for _w, ress in http_rounds(port, "/retrieve", known, 1, workdir)
                   for res in ress]
            wrong = [(i, g) for i, g in zip(known_ids, got) if g != [f"chunk:{i}"]]
            if wrong:
                raise RuntimeError(f"gang {tag}: known rows not first, e.g. {wrong[0]}")

        http_rounds(port, "/retrieve", ids_only(0), 1, workdir)          # warm
        gang_a = http_rounds(port, "/retrieve", ids_only(1), rounds, workdir)
        summary["ids_only"] = round_stats(gang_a)
        summary["packs"] = round_stats(http_rounds(
            port, "/retrieve", lambda r: [{"query": q} for q in unique_queries(
                concurrency, 500 + r)], 2, workdir))
        known_first("loaded")
        # DELETE the synthetic call whose rows the answers named most
        with get_store().read() as conn:
            owner = dict(conn.execute(
                "SELECT chunk_id, call_id FROM chunks WHERE chunk_id <= ?",
                (n_chunks,)).fetchall())
        named = {}
        for _w, ress in gang_a:
            for _s, _l, data in ress:
                for cid in answer_ids(data)[0]:
                    if cid in owner:
                        named[owner[cid]] = named.get(owner[cid], 0) + 1
        doomed = max(named, key=named.get)
        with get_store().read() as conn:
            doomed_ids = {int(r[0]) for r in conn.execute(
                "SELECT chunk_id FROM chunks WHERE call_id = ?", (doomed,)).fetchall()}
        t = time.perf_counter()
        status, _body = http_json(port, "DELETE", f"/calls/{doomed}")
        summary["delete"] = {"status": status, "ms": (time.perf_counter() - t) * 1e3,
                             "chunks": len(doomed_ids), "named": named[doomed]}
        if status != 200:
            raise RuntimeError(f"gang: DELETE /calls/{doomed} answered {status}")
        # compaction of both corpora (mirrored; rows move between processes)
        compact = {}
        for corpus in (index.chunks, index.artifacts):
            sync()
            t = time.perf_counter()
            corpus.compact()
            sync()
            compact[corpus.name] = {"s": time.perf_counter() - t, "rows": corpus.count,
                                    "capacity": corpus.capacity}
        summary["compaction"] = compact
        after = http_rounds(port, "/retrieve", ids_only(1), rounds, workdir)
        summary["ids_only_after"] = round_stats(after)
        gang_answers = [d["retrieved_ids"] for _w, ress in after for _s, _l, d in ress]
        leaked = {i for ids in gang_answers for i in ids
                  if i.startswith("chunk:") and int(i[6:]) in doomed_ids}
        if leaked:
            raise RuntimeError(f"gang: deleted rows answered: {sorted(leaked)[:4]}")
        known_first("compacted")
        ckpt = workdir / "gang_v3"
        t = time.perf_counter()
        meta = save_index(str(ckpt))
        summary["v3_save"] = {"s": time.perf_counter() - t,
                              "format": meta["format_version"],
                              "files": {k: len(v) for k, v in meta["heavy_files"].items()}}
        if meta["format_version"] != 3:
            raise RuntimeError("gang: the save was not format v3")
        summary["launches_leader"] = shard_launches()
        stop()
        stop = None
        oplog.uninstall_leader()
        rc = follower.wait(timeout=120)
        text = follower_log.read_text()
        if rc != 0:
            raise RuntimeError(f"gang: the follower exited {rc}: {text[-2000:]}")
        found = re.search(r"oplog\.shutdown applied=(\d+) shard_launches=(\{.*\})", text)
        if not found:
            raise RuntimeError(f"gang: the follower logged no shutdown: {text[-2000:]}")
        summary["follower_ops"] = int(found.group(1))
        summary["launches_follower"] = json.loads(found.group(2))
        mesh_mod.leave_gang()

        # the v3 directory, restored into one process, answers alike
        for key in ("mesh_shape", "dist_coordinator", "dist_num_processes",
                    "dist_process_id", "dist_oplog_port"):
            setattr(settings, key, saved[key])
        core_index.reset_index()
        solo = core_index.get_index(device)
        t = time.perf_counter()
        restore_index(str(ckpt), solo)
        sync()
        summary["v3_restore_s"] = time.perf_counter() - t
        shutil.rmtree(ckpt, ignore_errors=True)
        port, stop = start_server()
        http_rounds(port, "/retrieve", ids_only(0), 1, workdir)          # warm
        single = http_rounds(port, "/retrieve", ids_only(1), rounds, workdir)
        summary["ids_only_single"] = round_stats(single)
        single_answers = [d["retrieved_ids"] for _w, ress in single for _s, _l, d in ress]
        if single_answers != gang_answers:
            diff = sum(a != b for a, b in zip(single_answers, gang_answers))
            raise RuntimeError(f"gang: {diff} of {len(gang_answers)} answers differ "
                               "from the one-process index restored from its v3 save")
        known_first("restored from v3")
        summary["answers_compared"] = len(gang_answers)
        return summary
    finally:
        if stop is not None:
            stop()
        if oplog.leader() is not None:
            oplog.uninstall_leader()
        if follower.poll() is None:
            follower.kill()
            follower.wait(30)
        mesh_mod.leave_gang()
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        core_index.reset_index()
        reset_syncer()


def run_dist_check(device_type, processes=2):
    """(c) ``evals/dist_check`` as its own launcher runs it. -> summary"""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, "cadence_rag_tpu_torch.evals.dist_check",
         "--device", device_type, "--processes", str(processes),
         "--port", str(free_port())],
        capture_output=True, text=True, timeout=600, env=child_env())
    out = proc.stdout
    if proc.returncode != 0 or "DIST CHECK PASSED" not in out or out.count("MATCH") != processes:
        raise RuntimeError(f"dist_check failed (rc {proc.returncode}): "
                           f"{out[-2000:]}{proc.stderr[-2000:]}")
    return {"s": time.perf_counter() - t, "processes": processes,
            "lines": [ln for ln in out.splitlines() if "sharded lanes" in ln]}


def run_parallel(device, full, batches, ivf_args, ivf_modes, batch, n_known,
                 n_chunks, n_artifacts, gang_concurrency=128, gang_rounds=6, turns=3):
    """The ``parallel`` phase: (a) one process at ``PARALLEL_SPEC``, (b) the
    two-process gang over HTTP, (c) ``dist_check``. -> summary"""
    import tempfile

    device = torch.device(device)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    try:
        local = run_parallel_local(device, full, batches, ivf_args, ivf_modes, batch,
                                   n_known, workdir, turns=turns)
        gang = run_gang(device, n_chunks, n_artifacts, workdir,
                        concurrency=gang_concurrency, rounds=gang_rounds)
        dist = run_dist_check(device.type)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"local": local, "gang": gang, "dist_check": dist}


# -- the harness phase ---------------------------------------------------------------
HARNESS_CHUNKS = 1_000_000
SERVE_BENCH_ITERS = 20
HOST_PROFILE_TOP = 15
HOST_PROFILE_ARGV = ("--iters", "10", "--top", str(HOST_PROFILE_TOP))
FULLSTACK_ARGV = ("--n", str(HARNESS_CHUNKS), "--trials", "2", "--iters", "10")
# the soak cut from 240,000 chunks and 10 minutes to 60,000 and 2.5 (120,000
# and 4 until the script outgrew its time limit on slower hosts): the
# writer's 500 rows/s cross a growth from 65,536 rows, and the vocab rebuild
# (77-116 s over ~150,000 documents on the card's host while it serves; ~77,000
# here) starts at 15% of the run and ends before its last quarter, whose
# scan rate the decay gate holds to the first quarter's (at 2 minutes and
# 120,000 chunks it ran into the last quarter); deletes and the compaction
# at the JAX defaults
SOAK_KW = dict(minutes=2.5, chunks=60_000, batch=128, writer_rows_s=500.0,
               window_s=15.0, decay_floor=0.70)
TRACE_MS = 1500
SERVE_ALL_TEXT = ("the gateway fell over when the etcd quorum was lost during the "
                  "zone-b maintenance window at 02:10")


class HarnessDispatches:
    """Every dispatch any index makes through ``query_both_packed_async``
    while installed (the harnesses build their own indexes), grouped by its
    corpora's device shapes: {shapes: [DispatchLog's tuples]}."""

    def __init__(self):
        from cadence_rag_tpu_torch.core.index import DeviceIndexManager

        self.groups = collections.defaultdict(list)
        self._cls = DeviceIndexManager
        inner = self._inner = DeviceIndexManager.query_both_packed_async
        groups = self.groups

        def recording(index, *args, **kw):
            shapes = tuple((name, c.capacity, c.dim, c.lex_dim, c.tech_slots,
                            str(c.emb_dtype))
                           for name, c in (("chunks", index.chunks),
                                           ("artifacts", index.artifacts)))
            groups[shapes].append((kw["chunk_mode"], kw["artifact_mode"],
                                   args[2].shape[0], args[0] is not None,
                                   args[2].shape[1]))
            return inner(index, *args, **kw)

        DeviceIndexManager.query_both_packed_async = recording

    def close(self):
        self._cls.query_both_packed_async = self._inner

    def count(self):
        return sum(len(calls) for calls in list(self.groups.values()))

    def cases(self):
        """-> [(corpora, dispatched)], as JSON: check_served_shapes takes
        them with ``emb_dtype`` made a torch dtype again"""
        out = []
        for shapes, calls in sorted(self.groups.items()):
            corpora = {name: {"rows": rows, "dim": dim, "lex_dim": lex_dim,
                              "slots": slots, "emb_dtype": dt[len("torch."):]}
                       for name, rows, dim, lex_dim, slots, dt in shapes}
            out.append((corpora, sorted(set(calls))))
        return out


def trace_kernels(trace):
    """{kernel: CUDA kernel events} of a Chrome trace, by KERNEL_NAMES."""
    events = trace.get("traceEvents", [])
    return {name: sum(1 for ev in events if ev.get("cat") == "kernel"
                      and needle in str(ev.get("name", "")))
            for name, needle in KERNEL_NAMES.items()}


def trace_launch_records(trace):
    """(kernel launches the CUDA runtime recorded on the host, kernels the
    card recorded) in a Chrome trace: launches without a kernel mean the
    capture lost the card's activity records."""
    events = trace.get("traceEvents", [])
    launched = sum(1 for ev in events if ev.get("cat") == "cuda_runtime"
                   and "LaunchKernel" in str(ev.get("name", "")))
    return launched, sum(1 for ev in events if ev.get("cat") == "kernel")


def fetch_trace(port, ms):
    """One ``GET /trace?ms=`` of the trace listener -> (trace, bytes)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace?ms={ms}",
                                timeout=120) as resp:
        raw = resp.read()
    return json.loads(raw), len(raw)


@contextlib.contextmanager
def settings_kept():
    """Every setting restored on exit: host_profile and fullstack_profile
    set theirs and leave them, as the JAX package's do."""
    import dataclasses

    from cadence_rag_tpu_torch.config import settings

    saved = {f.name: getattr(settings, f.name) for f in dataclasses.fields(settings)}
    try:
        yield settings
    finally:
        for name, value in saved.items():
            setattr(settings, name, value)


def captured_main(main, argv):
    """Run an entry point's ``main(argv)`` -> its standard output."""
    import io

    buf = io.StringIO()
    with settings_kept(), contextlib.redirect_stdout(buf):
        main(list(argv))
    return buf.getvalue()


def serve_bench_traced(device, n_chunks, batch, dispatches):
    """(a) ``run_serve_bench`` ids_only with the writer at 500 rows/s, and
    beside it one ``GET /trace`` of the trace listener (started as
    ``PROFILER_PORT`` starts it) once its batches have begun (``dispatches``
    has seen one more). -> (report, trace summary)"""
    from cadence_rag_tpu_torch.evals import serve_bench
    from cadence_rag_tpu_torch.serve import profiler

    port = free_port()
    profiler.start_server(port, host="127.0.0.1")
    mark = dispatches.count()
    got, failed, done = {}, [], threading.Event()

    def capture():
        try:
            while dispatches.count() == mark and not done.is_set():
                time.sleep(0.01)
            if not done.is_set():
                trace, nbytes = fetch_trace(port, TRACE_MS)
                got.update(kernels=trace_kernels(trace), bytes=nbytes, ms=TRACE_MS)
        except Exception as exc:  # reported below
            failed.append(exc)

    thread = threading.Thread(target=capture, daemon=True)
    thread.start()
    try:
        report = serve_bench.run_serve_bench(
            n_chunks, batch, SERVE_BENCH_ITERS, "ids_only", concurrent_ingest=True,
            ingest_rate_rows_s=500.0, device=device)
    finally:
        done.set()
        thread.join(TRACE_MS / 1e3 + 120)
        profiler.stop_server(port)
    if failed or not got:
        raise RuntimeError(f"harness: no trace from the listener: {failed}")
    if device.type == "cuda" and min(got["kernels"].values()) <= 0:
        raise RuntimeError(f"harness: the trace names no K1 or K3 kernel: {got}")
    return report, got


def run_serve_all(device):
    """``scripts/serve_all.py --device`` as a child over a store of its own:
    /health, one bundle dropped in the inbox answered first through
    /retrieve, /diagnostics, one ``GET /trace`` of the api child's listener
    (``PROFILER_PORT``) while it serves, then SIGTERM. -> summary"""
    import tempfile

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_all_"))
    port, trace_port = free_port(), free_port()
    env = child_env()
    env.update(STORE_PATH=str(workdir / "shared.db"), INGEST_ROOT_DIR=str(workdir / "ingest"),
               EMBEDDINGS_PROVIDER="stub", EMBEDDINGS_BASE_URL="",
               INDEX_INITIAL_CAPACITY="4096", INGEST_SINGLE_FILE_MIN_AGE_S="0",
               STORE_SYNC_INTERVAL_S="0.2", INGEST_POLL_SECONDS="1",
               PROFILER_PORT=str(trace_port))
    (workdir / "ingest" / "inbox").mkdir(parents=True)
    log_path = workdir / "serve_all.log"
    t0 = time.perf_counter()
    out = {}
    log_file = open(log_path, "w")
    sup = subprocess.Popen(
        [sys.executable, "-c", CHILD, "cadence_rag_tpu_torch.scripts.serve_all",
         "--store", env["STORE_PATH"], "--inbox", env["INGEST_ROOT_DIR"],
         "--host", "127.0.0.1", "--port", str(port), "--device", device.type],
        env=env, stdout=log_file, stderr=subprocess.STDOUT)
    try:
        def healthy():
            if sup.poll() is not None:
                raise RuntimeError("serve_all exited: " + log_path.read_text()[-3000:])
            try:
                return http_json(port, "GET", "/health", timeout=10)[1]["status"] == "ok"
            except OSError:
                return False

        wait_for(healthy, "serve_all's api /health", timeout=180, every=0.5)
        out["healthy_s"] = time.perf_counter() - t0
        bundle = workdir / "ingest" / "inbox" / "smoke-bundle"
        bundle.mkdir()
        (bundle / "transcript.json").write_text(json.dumps([
            {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 900, "text": SERVE_ALL_TEXT}]))
        (bundle / "_READY").touch()
        t1 = time.perf_counter()

        def answered():
            status, body = http_json(port, "POST", "/retrieve",
                                     {"query": "etcd quorum lost zone-b maintenance"})
            quotes = body.get("quotes") if status == 200 else None
            return bool(quotes) and SERVE_ALL_TEXT[:40] in quotes[0]["snippet"]

        wait_for(answered, "the bundle's call answering first", timeout=180, every=0.25)
        out["bundle_answered_s"] = time.perf_counter() - t1
        jobs = http_json(port, "GET", "/ingest/jobs")[1]["items"]
        out["job_status"] = jobs[0]["status"] if jobs else None
        out["diagnostics_device"] = http_json(port, "GET", "/diagnostics")[1]["index"]["device"]
        stop, served = threading.Event(), []

        def serve():
            while not stop.is_set():
                served.append(http_json(port, "POST", "/retrieve", {
                    "query": "etcd quorum", "return_style": "ids_only"})[0])

        thread = threading.Thread(target=serve, daemon=True)
        thread.start()
        lost = []
        try:
            trace, nbytes = fetch_trace(trace_port, 1000)
            # a capture whose host side recorded kernel launches but whose
            # card side recorded no kernel lost the card's activity records
            # (seen once in each of two whole-script runs, never with the
            # step alone): it cannot show which kernels served, so the
            # step takes one more capture, and reports the lost one
            launched, recorded = trace_launch_records(trace)
            if device.type == "cuda" and launched and not recorded:
                lost.append({"launches": launched, "bytes": nbytes})
                trace, nbytes = fetch_trace(trace_port, 1000)
        finally:
            stop.set()
            thread.join(60)
        out["trace"] = {"kernels": trace_kernels(trace), "bytes": nbytes,
                        "requests": len(served),
                        "launch_records": trace_launch_records(trace),
                        "lost_captures": lost}
    finally:
        sup.send_signal(signal.SIGTERM)
        try:
            out["rc"] = sup.wait(timeout=90)
        except subprocess.TimeoutExpired:
            sup.kill()
            out["rc"] = "killed"
        log_file.close()
        text = log_path.read_text()
        shutil.rmtree(workdir, ignore_errors=True)
    pids = {name: int(pid) for name, pid in
            re.findall(r"\[serve_all\] started (\S+) pid=(\d+)", text)}
    out["children"] = sorted(pids)
    out["alive_after"] = [name for name, pid in pids.items()
                          if Path(f"/proc/{pid}").exists()
                          and "zombie" not in _proc_state(pid)]
    out["s"] = time.perf_counter() - t0
    if (out["rc"] != 0 or "[serve_all] done" not in text or out["alive_after"]
            or set(pids) != {"api", "scanner", "worker0"}):
        raise RuntimeError(f"serve_all did not stop cleanly: {out}; {text[-3000:]}")
    if not out["diagnostics_device"].startswith(device.type) or out["job_status"] != "succeeded":
        raise RuntimeError(f"serve_all: {out}")
    if device.type == "cuda" and min(out["trace"]["kernels"].values()) <= 0:
        raise RuntimeError(f"serve_all: the api's trace names no K1 or K3: {out['trace']}")
    return out


# -- the model axis (parallel/tensor.py, the tensor-parallel models) --------------
QWEN_TP_SPEC = "data:1,model:2"
MODEL_AXIS_SPEC = "data:2,model:2"
# JAX's own tolerance for tensor-parallel against one device
# (tests/unit/test_qwen3.py), and a cosine floor per unit vector
QWEN_TP_ATOL = 2e-2
QWEN_TP_MIN_COS = 0.999
EMB_TP_LR = 1e-4
# each step's loss within tests/test_torch_training.py's TRAJECTORY_ATOL, and
# the parameters' change after the last step, gathered, within
# EMB_TP_CHANGE_RTOL of the unsharded change as a share of it
# (param_change_gap: a run that changes nothing reads 1; the CPU's three
# steps against JAX read 0.041, tests/test_torch_tensor_parallel.py)
EMB_TP_LOSS_ATOL = 1.5e-2
EMB_TP_CHANGE_RTOL = 0.1
# the phase's sizes on the card: the 4b preset at a 128 x 16-token batch, the
# committed embedder 20 steps on 32 x 48 tokens, serving at 131,072 chunks +
# 16,384 artifacts (the main path's widths at an eighth of its depth)
MODEL_AXIS_KW = dict(preset="4b", q_batch=128, q_seq=16, q_reps=3, emb_steps=20,
                     emb_batch=32, n_chunks=131_072, n_artifacts=16_384, batch=128,
                     n_known=N_KNOWN)


def seeded_tokens(rng, batch, seq, vocab):
    """(batch, seq) int32 ids in [1, vocab), each row padded after a length
    in [2, seq]."""
    tokens = rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)
    for row, length in enumerate(rng.integers(2, seq + 1, size=batch)):
        tokens[row, length:] = 0
    return tokens


def timed_in_turns(fns, reps, sync):
    """{name: [ms]} of each of two calls, in turns (a, b, b, a) x reps."""
    (a, fa), (b, fb) = fns.items()
    times = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)) * reps:
        sync()
        t = time.perf_counter()
        fn()
        sync()
        times[name].append((time.perf_counter() - t) * 1e3)
    return times


def qwen_tensor_parallel(device, preset, batch, seq, reps):
    """Step 1: the Qwen3 preset born sharded over ``QWEN_TP_SPEC`` on
    ``[device, device]``: init seconds and bytes a position; the shards
    gathered equal the unsharded ``init_params`` bit for bit; one batch
    tensor-parallel against unsharded (the card path on CUDA): max |err|
    and min cosine; each timed in turns. -> summary"""
    from cadence_rag_tpu_torch.models import prng, qwen3
    from cadence_rag_tpu_torch.parallel.mesh import make_mesh

    cfg = qwen3.PRESETS[preset]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    mesh = make_mesh(QWEN_TP_SPEC, [device, device])
    out = {"preset": preset, "mesh": QWEN_TP_SPEC, "batch": [batch, seq]}
    sync()
    t = time.perf_counter()
    sharded = qwen3.init_params(cfg, prng.PRNGKey(0), device, mesh=mesh)
    sync()
    out["init_sharded_s"] = time.perf_counter() - t
    out["bytes_per_position"] = [sharded.params.nbytes(pos) for pos in range(mesh.size)]
    t = time.perf_counter()
    whole = qwen3.init_params(cfg, prng.PRNGKey(0), device)
    sync()
    out["init_unsharded_s"] = time.perf_counter() - t
    out["bytes_unsharded"] = sum(p.numel() * p.element_size() for p in whole.params().values())
    gathered = qwen3.gather_params(sharded).params()
    differ = [name for name, p in whole.params().items() if not torch.equal(gathered[name], p)]
    del gathered
    if differ:
        raise RuntimeError(f"model axis: the born-sharded {preset} gathers otherwise "
                           f"than the unsharded init in {differ}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tokens = seeded_tokens(np.random.default_rng(0), batch, seq, cfg.vocab_buckets)
    tp_vecs, vecs = sharded(tokens), whole(torch.from_numpy(tokens))
    if not (torch.isfinite(tp_vecs).all() and torch.isfinite(vecs).all()):
        raise RuntimeError("model axis: non-finite qwen3 vectors")
    out["max_abs_err"] = float((tp_vecs - vecs).abs().max())
    out["min_cos"] = float((tp_vecs * vecs).sum(dim=1).min())
    if out["max_abs_err"] > QWEN_TP_ATOL or out["min_cos"] < QWEN_TP_MIN_COS:
        raise RuntimeError(f"model axis: qwen3 {preset} tensor-parallel against "
                           f"unsharded |err| {out['max_abs_err']:.3g}, min cosine "
                           f"{out['min_cos']:.6f} (limits {QWEN_TP_ATOL}, "
                           f"{QWEN_TP_MIN_COS})")
    ids = torch.from_numpy(tokens)
    out["ms"] = timed_in_turns({"unsharded": lambda: whole(ids),
                                "tensor_parallel": lambda: sharded(tokens)}, reps, sync)
    out["bound_ms"] = encoder_bound_ms(cfg, batch * seq)
    if device.type == "cuda":
        # the forward's all-reduces alone: two a layer, each the sum of the
        # model group's f32 (batch, seq, d_model) partials
        from cadence_rag_tpu_torch.parallel import tensor as tp

        parts = {pos: torch.randn(batch, seq, cfg.d_model, device=device)
                 for pos in mesh.model_group(0)}
        out["all_reduces"] = 2 * cfg.n_layers
        out["all_reduce_ms"] = cuda_ms(
            lambda: [tp.all_reduce(parts, mesh) for _ in range(out["all_reduces"])], 5)
        del parts
    del sharded, whole
    return out


def param_change_gap(got, want, start):
    """||(got - start) - (want - start)|| / ||want - start|| over every
    leaf (name -> tensor): how far one run moved the parameters otherwise
    than the other, as a share of the other's move."""
    num = den = 0.0
    for name, value in want.items():
        moved = value.double() - start[name].double()
        num += float(((got[name].double() - start[name].double() - moved) ** 2).sum())
        den += float((moved ** 2).sum())
    return (num / den) ** 0.5


def embedder_dp_tp(device, steps, batch):
    """Step 2: the committed embedder dp+tp over ``MODEL_AXIS_SPEC`` on
    ``[device] * 4``, ``steps`` InfoNCE steps from the artifact's weights on
    seeded batches, beside the unsharded ``train_step`` on the same batches:
    each step's loss, the parameters after the last step gathered against
    the unsharded ones, ms a step of each. -> summary"""
    import copy

    from cadence_rag_tpu_torch.models import embedder as emb
    from cadence_rag_tpu_torch.parallel.mesh import make_mesh

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    mesh = make_mesh(MODEL_AXIS_SPEC, [device] * 4)
    ref, cfg = emb.load_params(str(EMBEDDER_ARTIFACT), device)
    sharded = emb.shard_params(copy.deepcopy(ref), mesh)
    opt_ref, opt_tp = emb.adamw_init(ref), emb.adamw_init(sharded.params.leaves())
    start = {name: p.detach().clone() for name, p in ref.named_parameters()}
    rng = np.random.default_rng(0)
    out = {"mesh": MODEL_AXIS_SPEC, "steps": steps, "batch": [batch, cfg.max_len],
           "lr": EMB_TP_LR, "losses": [], "ms": {"unsharded": [], "dp_tp": []}}
    for _ in range(steps):
        a, p = (seeded_tokens(rng, batch, cfg.max_len, cfg.vocab_buckets) for _ in range(2))
        losses = []
        for name, (model, opt) in (("unsharded", (ref, opt_ref)), ("dp_tp", (sharded, opt_tp))):
            sync()
            t = time.perf_counter()
            _m, _o, loss = emb.train_step(model, opt, a, p, lr=EMB_TP_LR)
            losses.append(float(loss))
            sync()
            out["ms"][name].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(losses)
    out["loss_gap"] = max(abs(u - s) for u, s in out["losses"])
    with torch.no_grad():
        got = dict(emb.gather_params(sharded).named_parameters())
        want = dict(ref.named_parameters())
        out["param_change_gap"] = param_change_gap(got, want, start)
        out["param_max_abs"] = max(float((got[name] - p).abs().max())
                                   for name, p in want.items())
    if not all(np.isfinite(out["losses"]).ravel()) or out["loss_gap"] > EMB_TP_LOSS_ATOL \
            or not out["param_change_gap"] <= EMB_TP_CHANGE_RTOL:
        raise RuntimeError(f"model axis: dp+tp steps against unsharded: loss gap "
                           f"{out['loss_gap']:.3g} (limit {EMB_TP_LOSS_ATOL}), "
                           f"parameters' change {out['param_change_gap']:.3g} apart "
                           f"(limit {EMB_TP_CHANGE_RTOL})")
    return out


def model_axis_serving(device, n_chunks, n_artifacts, batch, n_known, workdir):
    """Step 4: the main path's rows copied into an index under
    ``MODEL_AXIS_SPEC`` and one under ``data:2`` (``[device] * 4`` and
    ``* 2``); a batch of ``batch`` in ``ann`` (unscoped) and in ``exact``
    (scoped) through the index API: every known row first, K1 and K3
    launched once per data shard a dispatch (not per position), the fused
    and per-lane outputs those of the ``data:2`` index bit for bit; then
    through the engine (ids_only) the ``data:2`` index's answers. K1's and
    K3's counts hold the ``MODEL_AXIS_SPEC`` index's dispatches alone: they
    are set to 0 just before them, and the ``data:2`` index's dispatches
    and the per-lane reruns are kept off them.
    -> summary, with the dispatches and the shard shapes for
    ``check_served_shapes``"""
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager
    from cadence_rag_tpu_torch.evals.synth import install_sharded_copy
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk
    from cadence_rag_tpu_torch.parallel import sharded as sharded_mod
    from cadence_rag_tpu_torch.parallel.mesh import make_mesh

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    full, texts, tokens = build_index(device, n_chunks, n_artifacts, n_known)
    indexes = {}
    for spec, n in ((MODEL_AXIS_SPEC, 4), ("data:2", 2)):
        sh = DeviceIndexManager(device, mesh=make_mesh(spec, [device] * n))
        sh.ensure_call_capacity(full.call_capacity)
        install_sharded_copy(full.chunks, sh.chunks)
        install_sharded_copy(full.artifacts, sh.artifacts)
        indexes[spec] = sh
    del full
    sync()
    ma, d2 = indexes[MODEL_AXIS_SPEC], indexes["data:2"]
    out = {"mesh": MODEL_AXIS_SPEC, "setup_s": time.perf_counter() - t0,
           "shards": sorted(ma.chunks._shards),
           "shard_rows": {"chunks": ma.chunks.shard_rows,
                          "artifacts": ma.artifacts.shard_rows}}
    dispatches = DispatchLog(ma)
    batches = [(name,) + plan_batch(ma, texts, tokens, batch, scoped)
               for name, scoped in (("unscoped", False), ("scoped", True))]
    out["modes"] = [modes for _name, _args, modes, _e in batches]
    if out["modes"] != [("ann", "ann"), ("exact", "exact")]:
        raise RuntimeError(f"model axis: planned {out['modes']}, not ann and exact")
    sharded_mod.launches_by_shard.clear()
    fused_scan.launches = 0
    range_topk.launches = 0
    flats = {}
    for name, args, modes, expected in batches:
        flats[name], got = packed_flat(ma, args, modes, True)
        check_first(got, expected, f"model axis {name}")
    out["launches_by_shard"] = shard_launches()
    # every data shard scanned once a dispatch (the CPU runs the plain
    # versions: its tallies stay empty)
    want = {f"{c}/{s}": ({"fused_scan": len(batches), "tech_topk": len(batches)}
                         if cuda else {})
            for c in ("artifact_chunks", "chunks") for s in range(2)}
    if out["launches_by_shard"] != want:
        raise RuntimeError(f"model axis: K1 and K3 launches by shard "
                           f"{out['launches_by_shard']}, not once per data shard: {want}")
    with off_the_tally():
        for name, args, modes, _expected in batches:
            same = np.array_equal(flats[name], packed_flat(d2, args, modes, True)[0])
            lanes = np.array_equal(packed_flat(ma, args, modes, False)[0],
                                   packed_flat(d2, args, modes, False)[0])
            if not (same and lanes):
                raise RuntimeError(f"model axis {name}: the output is not the data:2 "
                                   f"index's (fused {same}, lanes {lanes})")
    got = engine_known_answers(ma, texts, batch, workdir)
    out["launches"] = {"fused_scan": fused_scan.launches, "tech_topk": range_topk.launches}
    with off_the_tally():
        if got != engine_known_answers(d2, texts, batch, workdir):
            raise RuntimeError("model axis: the engine answers otherwise than under data:2")
    wrong = [j for j, ids in enumerate(got) if ids[:1] != [f"chunk:{KNOWN_ID0 + j % n_known}"]]
    if wrong:
        raise RuntimeError(f"model axis: known row not first through the engine for "
                           f"{len(wrong)} requests")
    out["engine_answers"] = len(got)
    out["dispatched"] = dispatches.take()
    out["corpora"] = {
        name: {"rows": c.shard_rows, "dim": c.dim, "lex_dim": c.lex_dim,
               "slots": c.tech_slots, "emb_dtype": str(c.emb_dtype).split(".")[-1]}
        for name, c in (("chunks", ma.chunks), ("artifacts", ma.artifacts))}
    del indexes, ma, d2
    return out


def run_model_axis(device, workdir, preset, q_batch, q_seq, q_reps, emb_steps,
                   emb_batch, n_chunks, n_artifacts, batch, n_known):
    """The model axis on one device, in four steps (each a function above):
    the Qwen3 preset tensor-parallel, the embedder's dp+tp steps,
    ``graft.dryrun_multichip(8)``, and serving under ``MODEL_AXIS_SPEC``;
    then, on CUDA, K1 and K3 against their plain versions at the shapes
    serving launched them with (launches not counted). -> summary"""
    from cadence_rag_tpu_torch import graft
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk

    device = torch.device(device)
    out = {"steps_s": {}}
    t0 = mark = time.perf_counter()

    def step(name):
        nonlocal mark
        out["steps_s"][name] = time.perf_counter() - mark
        mark = time.perf_counter()

    log(f"model_axis 1/4: qwen3 {preset} born sharded over {QWEN_TP_SPEC} on "
        f"[{device}, {device}], a {q_batch} x {q_seq}-token batch against unsharded")
    out["qwen3"] = qwen_tensor_parallel(device, preset, q_batch, q_seq, q_reps)
    step("qwen3")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"model_axis 2/4: the committed embedder dp+tp over {MODEL_AXIS_SPEC}, "
        f"{emb_steps} InfoNCE steps of {emb_batch} pairs against unsharded")
    out["embedder"] = embedder_dp_tp(device, emb_steps, emb_batch)
    step("embedder")
    log(f"model_axis 3/4: graft.dryrun_multichip(8, device={device.type!r})")
    fused_scan.launches = 0
    range_topk.launches = 0
    graft.dryrun_multichip(8, device=device)
    out["dryrun_launches"] = {"fused_scan": fused_scan.launches,
                              "tech_topk": range_topk.launches}
    step("dryrun")
    log(f"model_axis 4/4: serving under {MODEL_AXIS_SPEC}, {n_chunks} chunks + "
        f"{n_artifacts} artifacts, batches of {batch} in ann and exact")
    out["serving"] = model_axis_serving(device, n_chunks, n_artifacts, batch, n_known,
                                        Path(workdir))
    step("serving")
    out["launches"] = out["serving"]["launches"]
    out["s"] = time.perf_counter() - t0
    if device.type == "cuda":
        sv = out["serving"]
        sv["shapes"] = check_served_shapes(device, sv["dispatched"], {
            name: dict(c, emb_dtype=getattr(torch, c["emb_dtype"]))
            for name, c in sv["corpora"].items()}, seed=70)
    return out


MODEL_AXIS_CHILD = r"""
import json, sys, tempfile
for name in ("jax", "jaxlib", "cadence_rag_tpu"):
    sys.modules[name] = None
import torch
import chip_smoke
from cadence_rag_tpu_torch.kernels import build
build.load()
torch.backends.cuda.matmul.allow_tf32 = False
with tempfile.TemporaryDirectory(prefix="chip_smoke_model_axis_") as tmp:
    out = chip_smoke.run_model_axis(torch.device(sys.argv[1]), tmp,
                                    **chip_smoke.MODEL_AXIS_KW)
with open(sys.argv[2], "w") as fh:
    json.dump(out, fh)
"""


def run_model_axis_child(device):
    """``run_model_axis`` in a process of its own, after the earlier phases
    freed the card (as the harness phase runs). Its lines go to this
    process's output; its counts of K1 and K3 launches are the child's,
    from 0. -> its summary"""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_axis_") as tmp:
        path = Path(tmp) / "model_axis.json"
        proc = subprocess.run(
            [sys.executable, "-c", MODEL_AXIS_CHILD, str(device), str(path)],
            env=child_env(), timeout=400)
        if proc.returncode != 0 or not path.exists():
            raise RuntimeError(f"the model_axis phase failed (rc {proc.returncode})")
        return json.loads(path.read_text())


def report_model_axis(ma, smi):
    """The model_axis phase's lines."""
    q, e, sv = ma["qwen3"], ma["embedder"], ma["serving"]
    med = {name: float(np.median(ts)) for name, ts in q["ms"].items()}
    log(f"model_axis qwen3 ({smi}): {q['preset']} born sharded over {q['mesh']} in "
        f"{q['init_sharded_s']:.2f} s (unsharded {q['init_unsharded_s']:.2f} s), "
        f"{q['bytes_per_position'][0] / 1e9:.3f} GB a position of "
        f"{q['bytes_unsharded'] / 1e9:.3f} GB; gathered equal to the unsharded init bit "
        f"for bit; batch {q['batch'][0]} x {q['batch'][1]} tokens tensor-parallel against "
        f"unsharded |err| {q['max_abs_err']:.3g}, min cosine {q['min_cos']:.6f} (limits "
        f"{QWEN_TP_ATOL}, {QWEN_TP_MIN_COS}); ms a batch at all {q['preset']} layers: "
        f"unsharded {med['unsharded']:.2f} ({q['ms']['unsharded']}), tensor-parallel "
        f"{med['tensor_parallel']:.2f} ({q['ms']['tensor_parallel']}), bound "
        f"{q['bound_ms']:.2f} ms; its {q['all_reduces']} all-reduces alone "
        f"{q['all_reduce_ms']:.3f} ms of device time")
    ms = {name: float(np.median(ts[1:] or ts)) for name, ts in e["ms"].items()}
    log(f"model_axis embedder ({smi}): tuned_small_v1.npz dp+tp over {e['mesh']}, "
        f"{e['steps']} InfoNCE steps of {e['batch'][0]} x {e['batch'][1]} tokens at lr "
        f"{e['lr']}: loss gap to the unsharded step {e['loss_gap']:.3g} (limit "
        f"{EMB_TP_LOSS_ATOL}; first {e['losses'][0]}, last {e['losses'][-1]}), "
        f"the parameters' change after the last step {e['param_change_gap']:.4g} of the "
        f"unsharded change apart (limit {EMB_TP_CHANGE_RTOL}; max |err| "
        f"{e['param_max_abs']:.3g}); median ms a step after the first: unsharded "
        f"{ms['unsharded']:.2f}, dp+tp {ms['dp_tp']:.2f}")
    log(f"model_axis serving ({smi}): {sv['mesh']} over one card, shards "
        f"{sv['shards']} of {sv['shard_rows']} rows (set up {sv['setup_s']:.1f} s); "
        f"batches planned {sv['modes']}, every known row first, fused and per-lane "
        f"outputs the data:2 index's bit for bit, {sv['engine_answers']} engine answers "
        f"the data:2 index's; K1 and K3 launches by data shard {sv['launches_by_shard']}, "
        f"in all (the engine's included) {sv['launches']}")
    log(f"model_axis ({smi}): graft.dryrun_multichip(8) passed (K1 and K3 launches, "
        f"not the main path's: {ma['dryrun_launches']}); steps (s) "
        + ", ".join(f"{k} {v:.1f}" for k, v in ma["steps_s"].items())
        + f"; phase {ma['s']:.1f} s in its child")


def _proc_state(pid):
    try:
        return Path(f"/proc/{pid}/status").read_text().split("State:")[1].split("\n")[0]
    except (OSError, IndexError):
        return "zombie"


def release_card():
    """Drop what the earlier phases left on the card before the harness
    builds its own indexes: the process-wide index (its background
    migrations cancelled), the store and the in-process models. -> bytes
    still allocated"""
    import gc

    from cadence_rag_tpu_torch.core.index import reset_index
    from cadence_rag_tpu_torch.models.embedder import NeuralEmbeddingProvider
    from cadence_rag_tpu_torch.models.qwen3 import Qwen3EmbeddingProvider
    from cadence_rag_tpu_torch.models.reranker import NeuralReranker
    from cadence_rag_tpu_torch.store.db import reset_store

    reset_index()
    reset_store()
    for cls in (NeuralEmbeddingProvider, Qwen3EmbeddingProvider, NeuralReranker):
        cls._instance = None
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


HARNESS_CHILD = r"""
import json, sys
for name in ("jax", "jaxlib", "cadence_rag_tpu"):
    sys.modules[name] = None
import torch
import chip_smoke
from cadence_rag_tpu_torch.kernels import build
build.load()
torch.backends.cuda.matmul.allow_tf32 = False
out = chip_smoke.run_harness(torch.device(sys.argv[1]))
with open(sys.argv[2], "w") as fh:
    json.dump(out, fh)
"""


def run_harness_child(device):
    """``run_harness`` in a process of its own, as an operator runs these
    entry points: a fresh interpreter. In this one, after every earlier
    phase, the heap is large enough that a full collection stalls the soak's
    serving loop for 0.3-0.4 s, and the soak's vocab rebuild ran past the
    end of its 2 minutes. Its lines go to this process's output; its
    counts of K1 and K3 launches are the child's, from 0. -> its summary"""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as tmp:
        path = Path(tmp) / "harness.json"
        proc = subprocess.run(
            [sys.executable, "-c", HARNESS_CHILD, str(device), str(path)],
            env=child_env(), timeout=900)
        if proc.returncode != 0 or not path.exists():
            raise RuntimeError(f"the harness phase failed (rc {proc.returncode})")
        return json.loads(path.read_text())


def run_harness(device):
    """The measurement and deployment entry points on the card, in order:
    serve_bench (two runs, a trace beside the first), host_profile,
    fullstack_profile, ingest_bench, the soak and serve_all. -> summary"""
    from cadence_rag_tpu_torch.evals import (
        fullstack_profile, host_profile, ingest_bench, serve_bench, soak,
    )
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk

    device = torch.device(device)
    out = {"steps_s": {}}
    fused_scan.launches = 0
    range_topk.launches = 0
    dispatches = HarnessDispatches()

    def step(name):
        out["steps_s"][name] = time.perf_counter()

    try:
        t0 = time.perf_counter()
        log(f"harness 1/6: serve_bench {HARNESS_CHUNKS} chunks batch 128 ids_only with "
            f"the writer at 500 rows/s, a GET /trace of {TRACE_MS} ms beside it")
        out["serve_bench_writer"], out["trace"] = serve_bench_traced(
            device, HARNESS_CHUNKS, 128, dispatches)
        log("harness 1/6: serve_bench evidence_pack_json, 2 threads")
        out["serve_bench_packs"] = serve_bench.run_serve_bench(
            HARNESS_CHUNKS, 128, SERVE_BENCH_ITERS, "evidence_pack_json", threads=2,
            device=device)
        step("serve_bench")
        log(f"harness 2/6: host_profile {' '.join(HOST_PROFILE_ARGV)} (1,000,000 chunks, "
            "batch 64: its defaults)")
        text = captured_main(host_profile.main,
                             HOST_PROFILE_ARGV + ("--device", device.type))
        out["host_profile"] = text
        step("host_profile")
        log(f"harness 3/6: fullstack_profile {' '.join(FULLSTACK_ARGV)}")
        text = captured_main(fullstack_profile.main, FULLSTACK_ARGV + ("--device",
                                                                       device.type))
        out["fullstack"] = json.loads(text.strip().splitlines()[-1])
        step("fullstack_profile")
        log("harness 4/6: ingest_bench at its defaults (20 calls x 40 utterances)")
        out["ingest_bench"] = ingest_bench.run_ingest_bench(device=device)
        step("ingest_bench")
        log(f"harness 5/6: soak {SOAK_KW}")
        out["soak"] = sk = soak.run_soak(device=device, **SOAK_KW)
        step("soak")
        if (sk["failures"] or not sk["capacity_growths"] or not sk["compactions"]
                or not (sk["vocab_rebuild"] or {}).get("ran")):
            raise RuntimeError(f"harness: the soak failed its gates: "
                               f"{ {k: v for k, v in sk.items() if k != 'windows'} }")
        out["launches"] = {"fused_scan": fused_scan.launches,
                           "tech_topk": range_topk.launches}
        log(f"harness 6/6: serve_all --device {device.type} over a store of its own")
        out["serve_all"] = run_serve_all(device)
        step("serve_all")
    finally:
        dispatches.close()
    out["dispatched"] = dispatches.cases()
    out["s"] = time.perf_counter() - t0
    marks = [t0] + list(out["steps_s"].values())
    out["steps_s"] = {name: at - before for (name, at), before
                      in zip(out["steps_s"].items(), marks)}
    return out


def report_harness(device, hv, smi):
    """The harness phase's lines, then K1 and K3 against their plain versions
    at every shape it launched them with, per corpora shape. -> the
    shape checks"""
    sb, sp, tr = hv["serve_bench_writer"], hv["serve_bench_packs"], hv["trace"]
    log(f"harness serve_bench ({smi}): {sb['chunks']} chunks, batch {sb['batch']} "
        f"ids_only, {SERVE_BENCH_ITERS} iters, the writer at 500 rows/s: set up in "
        f"{sb['setup_s']} s, p50 batch {sb['p50_batch_ms']} ms p99 {sb['p99_batch_ms']} "
        f"ms max {sb['max_batch_ms']} ms, {sb['qps']} QPS, {sb['concurrent_inserts']} rows "
        f"inserted ({sb['insert_rows_per_s']} rows/s); the listener's {tr['ms']} ms trace "
        f"beside it ({tr['bytes'] / 1e6:.1f} MB): CUDA kernel events K1 "
        f"{tr['kernels']['fused_scan']}, K3 {tr['kernels']['tech_topk']}; "
        f"evidence_pack_json with {sp['threads']} threads {sp['qps']} QPS (set up in "
        f"{sp['setup_s']} s)")
    hp = hv["host_profile"]
    log(f"harness host_profile ({smi}), {HARNESS_CHUNKS} chunks, batch 64, 10 iters: "
        + " | ".join(ln.strip() for ln in hp.splitlines()
                     if ln.startswith(("setup", "compile+first", "engine timings_ms",
                                       "profiled"))))
    tottime = hp.split("===== top by tottime =====")[1].strip().splitlines()
    log(f"harness host_profile top {HOST_PROFILE_TOP} by tottime:")
    for line in tottime[:HOST_PROFILE_TOP + 1]:
        log("  " + line)
    fs = hv["fullstack"]
    tl = fs["timeline_rrf_on_d3"]
    log(f"harness fullstack_profile ({smi}), {fs['n']} rows, batch {fs['batch']}, "
        f"{' '.join(FULLSTACK_ARGV[2:])}: serial QPS device RRF on "
        f"{fs['serial_rrf_on']['qps_runs']} off {fs['serial_rrf_off']['qps_runs']}; "
        "pipelined QPS " + ", ".join(
            f"{k[len('pipelined_'):-len('_qps')]} {v}" for k, v in fs.items()
            if k.startswith("pipelined_"))
        + f"; timeline (RRF on, depth 3): {tl['qps']} QPS, "
        f"enqueue {tl['enqueue_s']} s, finish {tl['finish_s']} s, host idle "
        f"{tl['host_idle_s']} s of {tl['total_s']} s, device_ms p50 {tl['device_ms_p50']}")
    ib = hv["ingest_bench"]
    log(f"harness ingest_bench ({smi}): {ib['calls']} calls, {ib['utterances']} "
        f"utterances -> {ib['chunks']} chunks in {ib['ingest_s']} s "
        f"({ib['ingest_utterances_per_s']} utterances/s); backfill of "
        f"{ib['embed_rows']} rows in {ib['embed_s']} s ({ib['embed_rows_per_s']} rows/s); "
        f"{ib['device_chunk_count']} rows on the card")
    sk = hv["soak"]
    log(f"harness soak ({smi}), cut from 240,000 chunks and 10 minutes to "
        f"{sk['chunks_start']} and {sk['minutes']:g}: {sk['queries']} queries, "
        f"{sk['qps_overall']} QPS, p50 batch {sk['p50_batch_ms']} ms p99 "
        f"{sk['p99_batch_ms']} ms max {sk['max_batch_ms']} ms at {sk['max_batch_t_s']} s; "
        f"scan Mrows/s first quarter {sk['scan_mrows_s_first_quarter']} last "
        f"{sk['scan_mrows_s_last_quarter']} (floor {SOAK_KW['decay_floor']}); "
        f"{sk['inserted_rows']} rows inserted, {sk['deleted_rows']} deleted, "
        f"{sk['compactions']} compaction ({sk['compact_seconds']} s), vocab rebuild "
        f"{sk['vocab_rebuild']}, capacity {sk['capacity_start']} -> {sk['capacity_end']}; "
        f"RSS {sk['rss_start_mb']:.0f} -> {sk['rss_end_mb']:.0f} MB; failures "
        f"{sk['failures']}; windows (t_s qps p99_ms rows) " + ", ".join(
            f"{w['t_s']} {w['qps']} {w['p99_ms']} {w['rows']}" for w in sk["windows"]))
    sa = hv["serve_all"]
    log(f"harness serve_all --device {device.type} ({smi}): children {sa['children']}, api "
        f"healthy after {sa['healthy_s']:.1f} s, the dropped bundle answered first "
        f"{sa['bundle_answered_s']:.1f} s after it landed (job {sa['job_status']}), "
        f"/diagnostics device {sa['diagnostics_device']}; the api's PROFILER_PORT trace "
        f"of 1000 ms over {sa['trace']['requests']} requests: K1 "
        f"{sa['trace']['kernels']['fused_scan']}, K3 {sa['trace']['kernels']['tech_topk']} "
        f"kernel events (runtime launches, card kernels {sa['trace']['launch_records']}; "
        f"captures that lost the card's records first: {sa['trace']['lost_captures']}); "
        f"SIGTERM -> rc {sa['rc']}, no child alive; step {sa['s']:.1f} s")
    log("harness steps (wall s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in hv["steps_s"].items())
        + f"; launches {hv['launches']}")
    return [check_served_shapes(
                device, dispatched,
                {name: {**c, "emb_dtype": getattr(torch, c["emb_dtype"])}
                 for name, c in corpora.items()}, seed=200 + 10 * i)
            for i, (corpora, dispatched) in enumerate(hv["dispatched"])]


# -- the probes phase ----------------------------------------------------------------
# The on-card probes at the JAX probes' defaults, in one child process:
# rtt_probe2 first, so that its first staging and readback find PyTorch's
# caching host allocator without a block of their size. Two cuts keep the
# script inside its time limit (the phase took 55.9 s at the defaults):
# cta_ab's serial trials 3 -> 2 and iterations 20 -> 10, lane_probe's timed
# launches 20 -> 5 (its answer checks are whole).
PROBES = (
    ("rtt_probe2", ()),
    ("rtt_probe", ()),
    ("h2d_probe", ()),
    ("h2d_probe2", ()),
    ("rtt_probe3", ()),
    ("cta_ab", ("--trials", "2", "--iters", "10")),
    ("coldtier_probe", ()),
    ("growth_probe", ()),
    ("prewarm_probe", ()),
    ("lane_probe", ("--iters", "5")),
    ("lane_probe", ("--probe", "plane", "--iters", "5")),
)
PROBE_CUTS = "cta_ab --trials 2 --iters 10 (3, 20), lane_probe --iters 5 (20)"
PROBES_CHILD = r"""
import json, sys
for name in ("jax", "jaxlib", "cadence_rag_tpu"):
    sys.modules[name] = None
import torch
import chip_smoke
from cadence_rag_tpu_torch.kernels import build
build.load()
torch.backends.cuda.matmul.allow_tf32 = False
out = chip_smoke.run_probes(torch.device(sys.argv[1]))
with open(sys.argv[2], "w") as fh:
    json.dump(out, fh)
"""


def run_probes_child(device):
    """``run_probes`` in a process of its own, as an operator runs the
    probes: the earlier phases' heap and cached blocks do not colour their
    timings. Its counts of K1 and K3 launches are the child's, from 0. ->
    its summary"""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_probes_") as tmp:
        path = Path(tmp) / "probes.json"
        proc = subprocess.run(
            [sys.executable, "-c", PROBES_CHILD, str(device), str(path)],
            env=child_env(), timeout=600)
        if proc.returncode != 0 or not path.exists():
            raise RuntimeError(f"the probes phase failed (rc {proc.returncode})")
        return json.loads(path.read_text())


def run_probes(device, probes=PROBES):
    """Each probe's ``main`` in turn (``--device`` the card's type), its
    standard output kept; a probe whose own check fails raises. Between
    probes the index is dropped and the allocator's cache emptied. ->
    {"probes": [{name, argv, s, lines}], launches, dispatched, s}"""
    import gc
    import importlib

    from cadence_rag_tpu_torch.core.index import reset_index
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk

    device = torch.device(device)
    fused_scan.launches = 0
    range_topk.launches = 0
    dispatches = HarnessDispatches()
    out = {"probes": []}
    t0 = time.perf_counter()
    try:
        for name, argv in probes:
            module = importlib.import_module(f"cadence_rag_tpu_torch.evals.{name}")
            argv = tuple(argv) + ("--device", device.type)
            t = time.perf_counter()
            text = captured_main(module.main, argv)
            out["probes"].append({"name": name, "argv": list(argv),
                                  "s": time.perf_counter() - t,
                                  "lines": text.strip().splitlines()})
            reset_index()
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dispatches.close()
    out["launches"] = {"fused_scan": fused_scan.launches,
                       "tech_topk": range_topk.launches}
    out["dispatched"] = dispatches.cases()
    out["s"] = time.perf_counter() - t0
    return out


def report_probes(device, pv, smi):
    """The probes' lines under a ``probes`` prefix, then K1 and K3 against
    their plain versions at every shape the probes dispatched through the
    index, per corpora shape. -> the shape checks"""
    for p in pv["probes"]:
        head = f"probes {p['name']} {' '.join(p['argv'])} ({smi}; {p['s']:.1f} s):"
        for line in p["lines"]:
            log(f"{head} {line}")
    log(f"probes ({smi}): {len(pv['probes'])} runs in {pv['s']:.1f} s in their child, "
        f"cut from the JAX defaults: {PROBE_CUTS}; "
        + ", ".join(f"{p['name']} {p['s']:.1f}" for p in pv["probes"])
        + f"; launches {pv['launches']}")
    return [check_served_shapes(
                device, dispatched,
                {name: {**c, "emb_dtype": getattr(torch, c["emb_dtype"])}
                 for name, c in corpora.items()}, seed=300 + 10 * i)
            for i, (corpora, dispatched) in enumerate(pv["dispatched"])]


def write_details(path, details):
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(details, indent=1, default=str))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--details", type=Path, default=None,
                        help="write every measurement as JSON to this file")
    parser.add_argument("--phase", choices=["model_axis", "probes"], default=None,
                        help="build the kernels and run this phase alone (no "
                             "result line)")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from cadence_rag_tpu_torch.device import resolve_device
    from cadence_rag_tpu_torch.kernels import build
    from cadence_rag_tpu_torch.ops.dense_scan import dense_scan
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk

    device = resolve_device("cuda")
    # plain versions: full f32 matmuls (the lexical query is f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    details = Details(device=kind, nvidia_smi=smi, torch=torch.__version__)
    # written when the process ends, so a failed run keeps what it measured
    atexit.register(write_details, opts.details, details)

    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report(build.LOG_PATH.read_text())
    details.update(build_s=build_s, nvcc_s=build.last_build_seconds, ptxas=ptxas)
    log(f"build: {build_s:.1f} s (nvcc {build.last_build_seconds:.1f} s) -> "
        f"{build.LIB_PATH}; ptxas (registers at entry, spill stores/loads B): "
        + " | ".join(f"{r['kernel']} {r['registers']} regs, spills "
                     f"{r['spill_stores']}/{r['spill_loads']}" for r in ptxas))
    if opts.phase == "model_axis":
        details["model_axis"] = ma = run_model_axis_child(device)
        report_model_axis(ma, smi)
        return 0
    if opts.phase == "probes":
        details["probes"] = pv = run_probes_child(device)
        details["probes_shapes"] = report_probes(device, pv, smi)
        return 0

    details["k1"] = check_k1(device, 1_048_576, 128, 1024, 4096,
                             torch.bfloat16, seed=1, reps=5)
    details["k1_served"] = check_k1(device, 1_048_576, 128, 1024, 4096,
                                    torch.bfloat16, seed=1, reps=5, lex="served")
    details["k1_ragged_int8"] = check_k1(device, 300_037, 128, 1024, 4096,
                                         torch.int8, seed=2, reps=3)
    details["k3"] = check_k3(device, 1_048_576, 128, 16, seed=3, reps=10)

    fused_scan.launches = 0
    range_topk.launches = 0
    dense_scan.launches = 0
    index, batches, summary = run_main_path(
        device, 1_000_000, 100_000, batch=128, n_known=N_KNOWN)
    launches = {"fused_scan": fused_scan.launches, "tech_topk": range_topk.launches}
    if min(launches.values()) <= 0:
        raise RuntimeError(f"main path did not launch every kernel: {launches}")
    for name, args, modes, _expected in batches:
        times = []
        for _ in range(4):
            t = time.perf_counter()
            serve_batch(index, args, modes)
            times.append((time.perf_counter() - t) * 1e3)
        summary[name]["warm_batch_ms"] = times[1:]
    details["main"] = summary
    log(f"main: 1M chunks + 100k artifacts set up in {summary['setup_s']:.1f} s; "
        + "; ".join(
            f"{name} batch of 128 (chunks {summary[name]['modes'][0]}, "
            f"artifacts {summary[name]['modes'][1]}) warm "
            f"{np.median(summary[name]['warm_batch_ms']):.1f} ms"
            for name, *_ in batches)
        + f"; every known row first; launches {launches}")

    # warm rounds cut from 20 to 10 and traffic batches under the writes from
    # 60 rounds to 30, to keep the script inside its time limit
    serve = run_serve(device, 1_000_000, 100_000, warm_rounds=10, write_rounds=30)
    details["serve"] = serve
    if min(serve["launches"].values()) <= 0:
        raise RuntimeError(f"the served path did not launch K1 and K3: {serve['launches']}")
    writes = serve["writes"]
    if min(writes["launches"].values()) <= 0:
        raise RuntimeError(
            f"the writes phase did not launch K1 and K3: {writes['launches']}")
    prof = serve["profiled_round"]
    log(f"serve: 1M chunks + 100k artifacts, store rows and {N_KNOWN} known rows "
        f"ingested, set up in {serve['setup_s']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in serve["setup_split_s"].items())
        + f"); {smi}; HTTP from a client process, 128 concurrent: "
        + "; ".join(
            f"({name}) {what} p50 {serve[name]['p50_ms']:.1f} ms p99 "
            f"{serve[name]['p99_ms']:.1f} ms {serve[name]['qps']:.0f} QPS"
            for name, what in (("a", "ids_only ann"), ("b", "packs ann"),
                               ("c", "packs scoped exact"),
                               ("d", "/retrieve/batch of 128 per call")))
        + f"; batches {serve['batch_sizes']}; engine timings (b) "
        + ", ".join(f"{k} {v:.2f}" for k, v in serve["engine_timings_ms"].items())
        + f"; every known row first; launches {serve['launches']}; profiled round "
        f"of (a): K1 {prof['k1_ms']:.2f} ms, K3 {prof['k3_ms']:.2f} ms, kernels "
        f"{prof['kernel_ms']:.1f} of {prof['wall_ms']:.1f} ms wall")
    log("serve engine, batch 128 (ms, the engine's stage spans): ids_only "
        + ", ".join(f"{k} {v:.2f}" for k, v in serve["split_ids_only"].items())
        + " | packs " + ", ".join(f"{k} {v:.2f}" for k, v in serve["split_packs"].items())
        + " | scoped packs " + ", ".join(
            f"{k} {v:.2f}" for k, v in serve["split_scoped"].items())
        + " | QPS " + ", ".join(f"{k} {v:.0f}" for k, v in serve["engine_qps"].items()))
    log(f"featurizer ({smi}), engine stage spans of an ids_only batch of 128, ms: "
        "native C++ (native/lexhash.cpp) "
        + ", ".join(f"{k} {v:.2f}" for k, v in serve["split_ids_only"].items())
        + " | pure Python (ops/hashing.py), same run "
        + ", ".join(f"{k} {v:.2f}" for k, v in serve["split_ids_only_python"].items()))
    sync, deletes, comp = writes["sync"], writes["delete"], writes["compaction"]
    gib = lambda b: b / 2**30
    log(f"writes ({smi}): second startup (reconcile of the populated index, syncer "
        f"every {sync['interval_s']} s) {writes['startup_s']:.1f} s; worker child "
        f"ingested {sync['bundles']} bundles store-only in {writes['worker_s']:.1f} s; "
        f"every synced row first; lag from a job's end to the first answer holding "
        f"its row min {sync['lag_from_job_end_s']['min']:.3f} p50 "
        f"{sync['lag_from_job_end_s']['p50']:.3f} max "
        f"{sync['lag_from_job_end_s']['max']:.3f} s (from the job's start p50 "
        f"{sync['lag_from_job_start_s']['p50']:.3f} s); DELETE /calls/{{id}} x"
        f"{deletes['calls']} ({deletes['chunks']} chunks, {deletes['artifact_chunks']} "
        f"artifact chunks) p50 {deletes['p50_ms']:.1f} ms (one-chunk calls "
        f"{deletes['one_chunk_call_p50_ms']:.1f} ms, synthetic calls of ~977 chunks "
        f"{deletes['synthetic_call_p50_ms']:.1f} ms), no deleted id in any answer")
    bulk = writes["bulk_tombstones"]
    log(f"writes, under 128 concurrent /retrieve: delete_ids of {bulk['chunks']} "
        f"chunks {bulk['chunks_s']:.2f} s and {bulk['artifact_chunks']} artifact "
        f"chunks {bulk['artifact_chunks_s']:.2f} s (requests p50 "
        f"{bulk['traffic']['p50_ms']:.1f} ms, longest {bulk['traffic']['max_ms']:.1f} "
        f"ms); the crossing DELETE {comp['crossing_delete_ms']:.1f} ms with "
        + "; ".join(
            f"{r['corpus']} compacted {r['rows_before']} -> {r['rows_after']} rows "
            f"(capacity {r['capacity']}) in {r['seconds'] * 1e3:.1f} ms, peak "
            f"{gib(r['peak_bytes']):.2f} GiB over {gib(r['held_bytes']):.2f} GiB held"
            for r in comp["records"])
        + f"; requests across it p50 {comp['traffic']['p50_ms']:.1f} ms, p99 "
        f"{comp['traffic']['p99_ms']:.1f} ms, longest {comp['traffic']['max_ms']:.1f} "
        f"ms; afterwards tombstones 0, counts {comp['count_after']}, "
        f"{comp['known_first']} known rows first, no deleted id; launches "
        f"{writes['launches']}")
    log("gate (real, fixtures, on the card): " + ", ".join(
        f"{k} {serve['gate'][k]:.4f} (floor {floor})" for k, floor in GATE_FLOORS.items()))
    life = serve["lifecycle"]
    if min(life["launches"].values()) <= 0:
        raise RuntimeError(
            f"the lifecycle phase did not launch K1 and K3: {life['launches']}")
    rr, ck, gm = life["rerank"], life["checkpoint"], life["growth_migration"]
    log(f"lifecycle rerank ({smi}): real gate with rerank_provider=lexical "
        + ", ".join(f"{k} {serve['gate_reranked'][k]:.4f} (floor {floor})"
                    for k, floor in GATE_FLOORS.items())
        + f"; (b) packs over HTTP, 128 concurrent, RERANK_ENABLED: p50 "
        f"{rr['reranked']['p50_ms']:.1f} ms {rr['reranked']['qps']:.0f} QPS, the "
        f"engine's rerank_ms {rr['rerank_ms']:.2f} a request (top "
        f"{rr['reranked_from']:.0f} rescored); the unreranked rounds of the same "
        f"run p50 {rr['plain']['p50_ms']:.1f} ms {rr['plain']['qps']:.0f} QPS")
    sv = ck["saves"]
    log(f"lifecycle checkpoint ({smi}): save_index of the served index "
        f"({ck['rows']}) under 128 concurrent /retrieve: "
        + "; ".join(
            f"{name} {sv[name]['bytes'] / 1e9:.2f} GB, pinned buffers allocated in "
            f"{sv[name]['pinned_alloc_s']:.2f} s, corpus locks held "
            f"{sv[name]['lock_s']:.3f} s, call returned after "
            f"{sv[name]['call_returned_s']:.2f} s, on disk after "
            f"{sv[name]['to_disk_s']:.2f} s (files {sv[name]['write_s']:.2f} s), "
            f"requests p50 {sv[name]['traffic']['p50_ms']:.1f} ms longest "
            f"{sv[name]['traffic']['max_ms']:.1f} ms" for name in ("blocking", "background"))
        + f"; a fresh DeviceIndexManager restored in {ck['restore_s']:.2f} s, serving "
        f"(first planned batch answered, every known row first) after "
        f"{ck['to_serving_s']:.2f} s (the vocab line below has startup's rebuild from "
        f"a store in this run); device arrays, mirrors and stats equal to the served index's; K1 and K3 on "
        f"the restored tensors |err| "
        f"{max(r['max_abs_err'] for r in ck['kernels']):.3g}")
    gib = lambda b: b / 2**30
    log(f"lifecycle growth, background migration ({smi}), served index under 128 "
        f"concurrent /retrieve: planner (free {gib(gm['free_bytes']):.1f} GiB by "
        f"torch.cuda.mem_get_info) chose {gm['planned']} from {gm['old_capacity']}; "
        f"migration ready {gm['ready_s']:.3f} s after the trigger (allocation and "
        f"tail fill {gm['alloc_fill_s'] * 1e3:.1f} ms, copy {gm['copy_s'] * 1e3:.1f} "
        f"ms, off the lock); index.growth_swap {gm['swap_s'] * 1e3:.2f} ms under the "
        f"lock (host mirrors {gm['mirrors_s'] * 1e3:.2f} ms of it); peak "
        f"{gib(gm['peak_bytes']):.2f} GiB over {gib(gm['held_bytes']):.2f} GiB held; "
        f"requests across it p50 {gm['traffic']['p50_ms']:.1f} ms longest "
        f"{gm['traffic']['max_ms']:.1f} ms; {gm['known_first']} known rows first; K1 "
        f"and K3 on the {gm['kernels'][0]['rows']}-row tensors |err| "
        f"{gm['kernels'][0]['max_abs_err']:.3g}; launches {life['launches']}")

    models = serve["models"]
    if min(models["launches"].values()) <= 0:
        raise RuntimeError(f"qwen3 /retrieve launched no K1 or K3: {models['launches']}")
    enc, mcheck, timed = models["init"], models["check"], models["timed"]
    log(f"models qwen3 ({smi}): {enc['model']} made on the card beside the served "
        f"index ({gib(enc['index_bytes_before']):.2f} GiB held before it) in "
        f"{enc['s']:.1f} s, {enc['bytes'] / 1e9:.2f} GB, {enc['params'] / 1e9:.3f} G "
        f"params; card path against its plain path at depth {mcheck['depth']}: "
        + "; ".join(f"{name} {mcheck[name]['shape']} |err| "
                    f"{mcheck[name]['max_abs_err']:.3g} min cosine "
                    f"{mcheck[name]['min_cos']:.6f}" for name in ("queries", "chunks"))
        + f"; all {enc['layers']} layers: "
        + "; ".join(f"{name} batch {t['batch']} x seq {t['seq']} "
                    f"{t['ms']:.1f} ms (bound {t['bound_ms']:.1f} ms)"
                    for name, t in timed.items())
        + f"; the backfill batch's peak {gib(timed['backfill_batch']['peak_bytes']):.2f} "
        f"GiB over {gib(timed['backfill_batch']['held_bytes']):.2f} GiB held")
    ms = models["served"]
    log(f"models co-resident /retrieve ({smi}): 128 concurrent ids_only over HTTP, "
        + "; ".join(f"EMBEDDINGS_PROVIDER={kind} p50 {ms[kind]['p50_ms']:.1f} ms p99 "
                    f"{ms[kind]['p99_ms']:.1f} ms {ms[kind]['qps']:.0f} QPS, "
                    f"retrieve.embed {ms[kind]['embed_ms']:.2f} ms a dispatch group "
                    f"({ms[kind]['embed_calls']} groups, mean batch "
                    f"{ms[kind]['batches']:.1f})" for kind in ("stub", "qwen3"))
        + f"; {models['known_first']} known rows ingested and embedded by the encoder "
        f"through the backfill ({models['known_rows']['ingest_backfill_s']:.2f} s; "
        f"dense score of each own row >= {models['known_rows']['own_score_min']:.4f}, "
        f"of a rival known row <= {models['known_rows']['rival_score_max']:.4f}), "
        f"each first in the dense lane and fused; launches {models['launches']}")
    mr = models["rerank"]
    log(f"models neural rerank ({smi}): (b) packs over HTTP, 128 concurrent, "
        f"RERANK_ENABLED on {models['reranker_device']}: "
        + "; ".join(f"RERANK_PROVIDER={name} p50 {mr[name]['p50_ms']:.1f} ms "
                    f"{mr[name]['qps']:.0f} QPS, rerank_ms {mr[name]['rerank_ms']:.2f} "
                    f"a request (top {mr[name]['reranked_from']:.0f})"
                    for name in ("lexical", "neural")))

    details["served_shapes"] = check_served_shapes(
        device, serve["dispatched"], serve["corpora"], seed=20)
    details["models_shapes"] = check_served_shapes(
        device, models["dispatched"], models["corpora"], seed=110)
    # the writes phase's shapes at the compacted, ragged row counts
    details["written_shapes"] = check_served_shapes(
        device, writes["dispatched"], writes["corpora"], seed=60)
    on_index = writes["kernels_tombstoned"] + writes["kernels_compacted"]
    log("writes: K1 and K3 against their plain versions on the index's own "
        "tensors: " + "; ".join(
            f"{r['corpus']} {r['rows']} rows ({r['live']} live of {r['count']}) "
            f"batch {r['batch']} |err| {r['max_abs_err']:.3g}" for r in on_index))
    k1_err = max(details["k1"]["max_abs_err"], details["k1_served"]["max_abs_err"],
                 details["k1_ragged_int8"]["max_abs_err"],
                 details["served_shapes"]["k1_max_abs_err"],
                 details["written_shapes"]["k1_max_abs_err"],
                 details["models_shapes"]["k1_max_abs_err"],
                 *(r["max_abs_err"] for r in on_index))

    import tempfile

    offline_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_models_"))
    try:
        details["models_offline"] = off = run_models_offline(device, offline_dir)
    finally:
        shutil.rmtree(offline_dir, ignore_errors=True)
    eb, pm, gn, rg, es = (off["embedder"], off["paraphrase_mrr"], off["gate_neural"],
                          off["rerank_gate"], off["embed_service"])
    log(f"models neural embedder ({smi}): tuned_small_v1.npz loaded on "
        f"{eb['device']} in {eb['load_s']:.2f} s, its bag regenerated there (|err| "
        f"{eb['bag_max_abs_err']:.3g} against the CPU's, vectors {eb['max_abs_err']:.3g}); "
        f"real gate with provider=neural "
        + ", ".join(f"{k} {gn['metrics'][k]:.4f} (floor {floor}; CPU "
                    f"{gn['cpu_metrics'][k]:.4f})" for k, floor in GATE_FLOORS.items())
        + f", the first {GATE_HEAD} ids of every answer the CPU's, "
        f"{gn['same_answers']} of {gn['answers']} answers identical; dense-only "
        f"paraphrase MRR "
        f"{pm['neural']:.4f} against the stub's {pm['stub']:.4f}")
    for gap in gn["gaps"]:
        log(f"models neural real gate, an answer the card gives otherwise ({smi}): "
            f"{gap['query']} rank {gap['rank']}, card {gap['ids']['card']} against CPU "
            f"{gap['ids']['cpu']}; fused (card row - CPU row) on the card "
            f"{gap['fused_gap']['card']!r}, on the CPU {gap['fused_gap']['cpu']!r}; "
            + "; ".join(f"the {lane} lane's last row: card {e['card']}, CPU {e['cpu']} "
                        f"([id, rank, score]), {e['gap']:.3g} apart"
                        for lane, e in gap["lane_edges"].items())
            + f"; rows {json.dumps(gap['rows'])}")
    log(f"models rerank gate ({smi}), two_register_v1.npz on the card: neural_raw "
        f"MRR {rg['neural_mrr']:.4f}, hybrid {rg['hybrid_mrr']:.4f}, lexical "
        f"{rg['lexical_mrr']:.4f}, shuffled {rg['shuffled_mrr']:.4f}; e2e through "
        f"/retrieve neural_raw {rg['e2e_neural_mrr']:.4f} against lexical "
        f"{rg['e2e_lexical_mrr']:.4f}; fixture gate with neural_raw "
        + ", ".join(f"{k} {rg['fixture_metrics'][k]:.4f} (floor {floor})"
                    for k, floor in GATE_FLOORS.items()))
    log(f"models /embed ({smi}): serve/embed_service --provider neural in a child "
        f"process on the card, ready in {es['ready_s']:.1f} s; a backfill of "
        f"{es['rows']} rows through the port's HTTP provider {es['backfill_s']:.2f} s, "
        f"stored vectors against the in-process provider's |err| {es['max_abs_err']:.3g}")

    training_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_training_"))
    try:
        details["training"] = tr = run_training(device, training_dir)
    finally:
        shutil.rmtree(training_dir, ignore_errors=True)
    log(f"training gradients ({smi}), card path against plain on one batch of 32: "
        + "; ".join(f"{name} loss {g['loss']:.5f} |diff| {g['loss_diff']:.3g} (tol "
                    f"{CARD_LOSS_ATOL}), each leaf's max |grad diff| over max(its max "
                    f"|grad|, {GRAD_FLOOR:.4g} x the model's {g['grad_max']:.3g}): max "
                    f"{g['max_held']:.3g} (tol {CARD_GRAD_RTOL}); over its own max: "
                    + ", ".join(f"{leaf} {r:.3g}" for leaf, r in g["rel"].items())
                    for name, g in tr["gradients"].items()))
    pg = tr["paraphrase"]
    log(f"training paraphrase gate ({smi}): {pg['steps']} steps {pg['ms_per_step']:.2f} "
        f"ms a step (bound {pg['bound_ms']:.4f} ms by {pg['bound_by']}), gate "
        f"{pg['s']:.1f} s; tuned dense-only MRR {pg['neural_mrr']:.4f} against the stub's "
        f"{pg['stub_mrr']:.4f} (floors: margin 0.10, MRR 0.50); the first {CPU_STEPS} "
        f"losses on the card " + " ".join(f"{x:.4f}" for x in pg["losses"])
        + " | on the CPU " + " ".join(f"{x:.4f}" for x in pg["cpu_losses"]))
    rt = tr["rerank"]
    log(f"training rerank gate ({smi}), two-register: {rt['steps']} steps "
        f"{rt['ms_per_step']:.2f} ms a step (bound {rt['bound_ms']:.4f} ms by "
        f"{rt['bound_by']}), gate {rt['s']:.1f} s; neural_raw MRR {rt['neural_mrr']:.4f}, "
        f"hybrid {rt['hybrid_mrr']:.4f}, lexical {rt['lexical_mrr']:.4f}; e2e neural_raw "
        f"{rt['e2e_neural_mrr']:.4f} against lexical {rt['e2e_lexical_mrr']:.4f}; fixture "
        + ", ".join(f"{k} {rt['fixture_metrics'][k]:.4f}" for k in GATE_FLOORS)
        + f"; the saved artifact in NeuralReranker on the card scores the fixture pairs "
        f"within {rt['reload_err']:.3g} of the trained model")
    tc = tr["train_cli"]
    log(f"training train_embedder at its CLI defaults ({smi}): d_model 256, 4 layers, "
        f"vocab 32768, max_len 64, batch 32, {tc['steps']} steps over the gate's pairs in "
        f"{tc['s']:.1f} s, {tc['ms_per_step']:.2f} ms a step (bound {tc['bound_ms']:.4f} "
        f"ms by {tc['bound_by']}), loss {tc['first_loss']:.4f} -> {tc['final_loss']:.4f}")
    geo = tr["geometry"]
    gt = geo["timings"]
    log(f"training geometry gate ({smi}): {geo['n']} rows of tuned_small_v1.npz's "
        f"vectors, {geo['queries']} paraphrase queries: texts {gt['texts_s']:.1f} s, "
        f"tokenizing {gt['tokenize_s']:.1f} s, encoder {gt['encode_s']:.1f} s, "
        f"{gt['texts_per_s']:.0f} texts/s; recall@10 ann (K1 over bf16 rows) "
        f"{geo['ann_recall']:.4f} against the exact bf16 scan (floor 0.95), "
        f"{geo['ann_recall_f32']:.4f} against exact f32; int8 {geo['int8_recall']:.4f}, "
        f"int8_eps {geo['int8_eps_recall']:.4f} (floor 0.99), score loss mean "
        f"{geo['int8_score_loss_mean']:.6f}; ivf {geo['ivf_recall']:.4f} "
        f"({geo['ivf_clusters']} clusters, nprobe {geo['ivf_nprobe']}, build "
        f"{geo['ivf_build_s']:.1f} s); phase {geo['s']:.1f} s; K1 launched "
        f"{geo['launches']} times, against its plain version at {geo['k1']['batch']} x "
        f"{geo['k1']['rows']} rows |err| {geo['k1']['max_abs_err']:.3g}, near-tie rows "
        f"{geo['k1']['near_tie_rows']}")
    k1_err = max(k1_err, geo["k1"]["max_abs_err"])

    fused_scan.launches = 0
    range_topk.launches = 0
    details["int8"] = run_int8_served(device, 300_037, 30_011, 128, N_KNOWN)
    int8_launches = {"fused_scan": fused_scan.launches, "tech_topk": range_topk.launches}
    if min(int8_launches.values()) <= 0:
        raise RuntimeError(f"the int8 batch did not launch K1 and K3: {int8_launches}")
    log(f"int8: an index of {details['int8']['rows']} int8 chunks (capacity "
        f"{details['int8']['capacity']}) and {details['int8']['artifact_rows']} "
        f"artifacts served a batch of {details['int8']['batch']} through the engine "
        f"(planned ann, first batch {details['int8']['first_batch_ms']:.1f} ms): "
        f"every known row first; launches {int8_launches}")

    details["vocab"] = vocab = run_vocab(device, *VOCAB_DOCS, VOCAB_HEAD, N_KNOWN, 128)
    log(f"lifecycle vocab ({smi}): build_and_apply over a store of "
        f"{vocab['documents']} documents of real text (windows of consecutive lines "
        f"of the checkout's sources that the port's PRs leave as they are), head {vocab['head']}: "
        f"vocab.learn {vocab['learn_s']:.1f} s, vocab.apply {vocab['apply_s']:.1f} s, "
        f"{vocab['rows_rescattered']} rows re-scattered; every known document first; "
        f"K1 on the re-scattered lex tensor |err| {vocab['kernels']['max_abs_err']:.3g}; "
        f"restart from a checkpoint (activate_from_store, startup's digest check, "
        f"rows bit-equal) {vocab['restart_from_checkpoint_s']:.1f} s; restart without "
        f"one (startup rebuilds {vocab['documents']} rows from the store, the same "
        f"signatures) {vocab['rebuild_from_store_s']:.1f} s, "
        f"{vocab['documents'] / vocab['rebuild_from_store_s']:.0f} rows/s")
    details["cold_tier"] = cold = run_cold_tier(
        device, index, batches, COLD_HOT_ROWS, N_KNOWN, 128)
    cb = cold["batches"]
    log(f"lifecycle cold tier ({smi}): INDEX_MAX_DEVICE_ROWS={cold['hot_rows']}, "
        f"{cold['cold_rows']} rows in {cold['pinned_bytes'] / 1e9:.2f} GB of pinned "
        f"host memory (allocated in {cold['pinned_alloc_s']:.2f} s, filled in "
        f"{cold['install_s']:.2f} s), {cold['blocks']} blocks of up to "
        f"{cold['block_rows']}; "
        + "; ".join(
            f"{name} {tuple(cb[name]['modes'])} batch of 128 "
            f"{np.median(cb[name]['batch_ms']):.1f} ms (all-hot "
            f"{np.median(cb[name]['all_hot_batch_ms']):.1f} ms), "
            f"{cb[name]['bytes_shipped'] / 1e9:.2f} GB shipped at "
            f"{cb[name]['h2d_gbs']:.1f} GB/s, lane positions with another id than "
            f"the uncapped index's {cb[name]['ids_moved']} (largest score "
            f"difference {cb[name]['max_score_diff']:.3g})" for name in cb)
        + f"; a bare pinned copy_ of one block {cold['bare_copy_gbs']:.1f} GB/s, so "
        f"the bound of an unscoped batch is {cold['bound_ms']:.1f} ms; every known "
        f"row (all in the cold tier) first, through the engine too; {cold['deleted']} "
        f"cold rows deleted and {cold['backfilled']} backfilled; K1 and K3 on a "
        f"block's own tensors |err| "
        f"{max(r['max_abs_err'] for r in cold['kernels']):.3g} at "
        f"{[r['rows'] for r in cold['kernels']]} rows; launches {cold['launches']}")

    details["k2"] = check_k2(device, 1_048_576, 128, 1024, "contiguous", seed=4, reps=5)
    details["k2_random"] = check_k2(device, 1_048_576, 128, 1024, "random",
                                    seed=5, reps=5)
    details["k2_ragged"] = check_k2(device, 100_000, 64, 1024, "random",
                                    seed=6, reps=5)
    details["k2_shapes"] = check_k2_shapes(device, 1024, seed=7)
    k2_err = max([details[key]["max_abs_err"]
                  for key in ("k2", "k2_random", "k2_ragged")]
                 + [c["max_abs_err"] for c in details["k2_shapes"]])

    dense_scan.launches = 0
    fused_scan.launches = 0
    details["recall"] = run_recall(device, 1_048_576, 64, 10, hnsw_n=HNSW_N,
                                   sweep_n=1_048_576, sweep_rounds=2)
    recall_launches = {"dense_scan": dense_scan.launches,
                       "fused_scan": fused_scan.launches}
    if min(recall_launches.values()) <= 0:
        raise RuntimeError(f"the recall gate did not launch K1 and K2: {recall_launches}")
    details["ann_recall_table"] = check_recall_table(details["recall"]["gate"], smi)

    fused_scan.launches = 0
    range_topk.launches = 0
    dense_scan.launches = 0
    texts, tokens = known_rows(N_KNOWN)
    ivf_modes, ivf_args, ivf = run_ivf_batch(index, texts, tokens, 128)
    ivf_launches = {"fused_scan": fused_scan.launches,
                    "tech_topk": range_topk.launches,
                    "dense_scan": dense_scan.launches}
    if min(ivf_launches["fused_scan"], ivf_launches["tech_topk"]) <= 0:
        raise RuntimeError(f"the ivf batch did not launch K1 and K3: {ivf_launches}")
    times = []
    for _ in range(4):
        t = time.perf_counter()
        index.collect_packed(index.query_both_packed_async(
            *ivf_args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS,
            chunk_mode=ivf_modes[0], artifact_mode=ivf_modes[1],
            recall_target=0.95, fuse_rrf=True))
        times.append((time.perf_counter() - t) * 1e3)
    ivf["warm_batch_ms"] = times[1:]
    details["ivf"] = ivf
    log(f"ivf: built over {ivf['built_count']} chunks in {ivf['build_s']:.2f} s "
        f"({ivf['n_clusters']} clusters, bucket cap {ivf['bucket_cap']}, "
        f"nprobe {ivf['nprobe']}, overflow {ivf['overflow_count']}); planned "
        f"{ivf_modes}, served ivf; unscoped batch of 128 warm "
        f"{np.median(ivf['warm_batch_ms']):.1f} ms; every known row first "
        f"(fused and dense); launches {ivf_launches}")

    details["parallel"] = par = run_parallel(
        device, index, batches, ivf_args, ivf_modes, 128, N_KNOWN, 1_000_000, 100_000)
    pl, pg, pd = par["local"], par["gang"], par["dist_check"]
    un, sc = pl["unscoped"], pl["scoped"]
    log(f"parallel ({smi}), {pl['mesh']} over [cuda:0, cuda:0] in one process, the "
        f"main path's rows copied in {pl['copy_s']:.1f} s (shards of "
        f"{pl['shard_rows']['chunks']} chunks, {pl['shard_rows']['artifacts']} "
        f"artifact rows): unscoped {tuple(un['modes'])} fused output and every lane "
        f"bit-identical to the unsharded index's; scoped {tuple(sc['modes'])} lexical "
        f"and tech lanes bit-identical, exact dense lanes within {EXACT_ATOL} "
        + ", ".join(f"({name} |err| {v[2]:.3g}, near-tie positions {v[1]} of {v[0]})"
                    for name, v in sc["lanes"].items() if name.endswith("dense"))
        + "; batch of 128 host ms (median of 6, in turns) "
        + "; ".join(f"{name} sharded {np.median(pl[name]['batch_ms']['sharded']):.2f} "
                    f"unsharded {np.median(pl[name]['batch_ms']['unsharded']):.2f}"
                    for name in ("unscoped", "scoped"))
        + "; device ms " + "; ".join(
            f"{name} program sharded {pl[name]['sharded_program_ms']:.2f} (lanes "
            f"{pl[name]['lanes_ms']:.2f}, gather + merge + RRF {pl[name]['merge_ms']:.3f}) "
            f"unsharded {pl[name]['unsharded_program_ms']:.2f}"
            for name in ("unscoped", "scoped"))
        + f"; every known row first, through the index API and through the engine "
        f"({pl['engine_ann']} ann and {pl['engine_ivf']} ivf ids_only requests with "
        f"the unsharded index's answers); ivf from the unsharded build's state: ids "
        f"identical, the chunks' ivf dense lane device ms sharded "
        f"{pl['ivf_lane_ms']['sharded']:.2f} unsharded {pl['ivf_lane_ms']['unsharded']:.2f}; "
        f"the sharded build {pl['ivf']['build_s']:.2f} s "
        f"({pl['ivf']['clusters']} clusters), recall@10 against the exact scan "
        f"{pl['ivf']['recall_sharded_build']:.4f} beside the unsharded build's "
        f"{pl['ivf']['recall_unsharded_build']:.4f}; artifacts grown "
        f"{pl['growth']['old_capacity']} -> {pl['growth']['capacity']} in "
        f"{pl['growth']['insert_s']:.2f} s, answers unchanged; v2 save "
        f"{pl['checkpoint']['save_s']:.1f} s, restore into a fresh sharded index "
        f"{pl['checkpoint']['restore_s']:.1f} s, answers identical; K1/K3 launches per "
        f"shard {pl['launches']}")
    ol = pg["oplog_load"]
    log(f"parallel gang ({smi}): two processes on the one card, {pg['backend']}; "
        f"startup {pg['startup_s']:.1f} s; {ol['rows']} rows loaded through the "
        f"leader's index over the op-log in {ol['s']:.1f} s ({ol['bytes'] / 1e9:.2f} GB, "
        f"{ol['gbs']:.2f} GB/s); ids_only over HTTP, 128 concurrent: gang p50 "
        f"{pg['ids_only']['p50_ms']:.1f} ms p99 {pg['ids_only']['p99_ms']:.1f} ms "
        f"{pg['ids_only']['qps']:.0f} QPS (after the compaction p50 "
        f"{pg['ids_only_after']['p50_ms']:.1f} ms {pg['ids_only_after']['qps']:.0f} QPS) "
        f"beside one process restored from the gang's v3 save p50 "
        f"{pg['ids_only_single']['p50_ms']:.1f} ms p99 "
        f"{pg['ids_only_single']['p99_ms']:.1f} ms {pg['ids_only_single']['qps']:.0f} "
        f"QPS; packs p50 {pg['packs']['p50_ms']:.1f} ms; DELETE of a call of "
        f"{pg['delete']['chunks']} chunks {pg['delete']['ms']:.1f} ms; compaction "
        + ", ".join(f"{k} {v['s'] * 1e3:.0f} ms ({v['rows']} rows)"
                    for k, v in pg["compaction"].items())
        + f"; v3 save {pg['v3_save']['s']:.1f} s, one-process restore "
        f"{pg['v3_restore_s']:.1f} s; {pg['answers_compared']} answers equal to the "
        f"one-process index's, every known row first, no deleted row; the follower "
        f"applied {pg['follower_ops']} ops and exited 0; launches leader "
        f"{pg['launches_leader']} follower {pg['launches_follower']}")
    log(f"parallel dist_check --device cuda --processes {pd['processes']}: PASSED in "
        f"{pd['s']:.1f} s: " + " | ".join(pd["lines"]))
    details["parallel_shapes"] = check_served_shapes(
        device, pl["dispatched"], pl["corpora_before_growth"], seed=120)
    details["parallel_shapes_grown"] = check_served_shapes(
        device, pl["dispatched_grown"], pl["corpora"], seed=140)
    details["k1_shard"] = {
        name: check_k1(device, rows, 128, 1024, 4096, torch.bfloat16, seed=160 + i,
                       reps=5)
        for i, (name, rows) in enumerate((("chunks", pl["shard_rows"]["chunks"]),
                                          ("artifacts", pl["shard_rows"]["artifacts"])))}
    details["k3_shard"] = {
        name: k3_timing(device, rows, 128, 16, 2, seed=170 + i, reps=10)
        for i, (name, rows) in enumerate((("chunks", pl["shard_rows"]["chunks"]),
                                          ("artifacts", pl["shard_rows"]["artifacts"])))}
    log("parallel shard shapes (" + smi + "): " + "; ".join(
        f"{name} {r['n']} rows batch 128: K1 {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
        f"ms by {r['bound_by']}, plain {r['plain_ms']:.3f}), K3 width 32 "
        f"{details['k3_shard'][name]['ms']:.3f} ms (bound "
        f"{details['k3_shard'][name]['bound_ms']:.3f} ms by "
        f"{details['k3_shard'][name]['bound_by']}, plain "
        f"{details['k3_shard'][name]['plain_ms']:.3f})"
        for name, r in details["k1_shard"].items()))
    k1_err = max(k1_err, details["parallel_shapes"]["k1_max_abs_err"],
                 details["parallel_shapes_grown"]["k1_max_abs_err"],
                 *(r["max_abs_err"] for r in details["k1_shard"].values()))
    parallel_launches = {
        kernel: sum(t.get(kernel, 0) for launches in (
            pl["launches"], pg["launches_leader"], pg["launches_follower"])
            for t in launches.values())
        for kernel in ("fused_scan", "tech_topk")}
    if min(parallel_launches.values()) <= 0:
        raise RuntimeError(f"the parallel phase did not launch K1 and K3: {parallel_launches}")
    for launches in (pl["launches"], pg["launches_leader"], pg["launches_follower"]):
        if not launches or min(t.get(kernel, 0) for t in launches.values()
                               for kernel in ("fused_scan", "tech_topk")) <= 0:
            raise RuntimeError(f"a shard launched no K1 or K3: {launches}")

    details["growth_sync"] = gs = run_sync_growth(device, index, batches, 128)
    sp = gs["split"]
    log(f"lifecycle growth, GROWTH_MIGRATION_ENABLED=0 ({smi}), the index-API phase's "
        f"index under a thread serving its unscoped batch of 128: index.grow "
        f"{gs['old_capacity']} -> {gs['capacity']} {gs['grow_s'] * 1e3:.1f} ms under "
        f"the lock; the same steps one by one on arrays of these shapes: allocation "
        f"{sp['allocation_s'] * 1e3:.1f} ms, fill {sp['fill_s'] * 1e3:.1f} ms, copy "
        f"{sp['copy_s'] * 1e3:.1f} ms, host mirrors {sp['host_mirrors_s'] * 1e3:.2f} "
        f"ms; peak {gib(gs['peak_bytes']):.2f} GiB over {gib(gs['held_bytes']):.2f} "
        f"GiB held; batches p50 {gs['batch_p50_ms']:.1f} ms, longest across the "
        f"growth {gs['longest_batch_ms']:.1f} ms; every known row first; K1 and K3 "
        f"on the {gs['kernels'][0]['rows']}-row tensors |err| "
        f"{gs['kernels'][0]['max_abs_err']:.3g}")
    k1_err = max(k1_err, vocab["kernels"]["max_abs_err"], gs["kernels"][0]["max_abs_err"],
                 *(r["max_abs_err"] for r in ck["kernels"] + cold["kernels"] + gm["kernels"]))
    lifecycle_launches = {name: life["launches"][name] + cold["launches"][name]
                          for name in ("fused_scan", "tech_topk")}

    index.cancel_migrations()
    del index, batches, ivf_args
    held = release_card()
    log(f"model_axis: {held / 2**30:.2f} GiB still allocated on the card by this "
        "process; the phase runs in a child process")
    details["model_axis"] = ma = run_model_axis_child(device)
    if min(ma["launches"].values()) <= 0:
        raise RuntimeError(f"the model_axis phase did not launch K1 and K3: {ma['launches']}")
    report_model_axis(ma, smi)
    k1_err = max(k1_err, ma["serving"]["shapes"]["k1_max_abs_err"])
    log("harness: the phase runs in a child process")
    details["harness"] = hv = run_harness_child(device)
    if min(hv["launches"].values()) <= 0:
        raise RuntimeError(f"the harness phase did not launch K1 and K3: {hv['launches']}")
    details["harness_shapes"] = report_harness(device, hv, smi)
    k1_err = max(k1_err, *(r["k1_max_abs_err"] for r in details["harness_shapes"]))
    log("probes: the phase runs in a child process")
    details["probes"] = pv = run_probes_child(device)
    if min(pv["launches"].values()) <= 0:
        raise RuntimeError(f"the probes phase did not launch K1 and K3: {pv['launches']}")
    details["probes_shapes"] = report_probes(device, pv, smi)
    k1_err = max(k1_err, *(r["k1_max_abs_err"] for r in details["probes_shapes"]))

    k1, k3, k2 = details["k1"], details["k3"], details["k2"]

    def by_shard(kernel):
        """The parallel phase's launches per shard: "<where> <corpus>/<shard>"
        -> n, and each shard shape's time beside its bound."""
        out = {f"{where} {shard}": t.get(kernel, 0) for where, launches in (
            ("one process", pl["launches"]), ("gang leader", pg["launches_leader"]),
            ("gang follower", pg["launches_follower"]),
            (f"model_axis {MODEL_AXIS_SPEC}", ma["serving"]["launches_by_shard"]))
            for shard, t in launches.items()}
        timed = details["k1_shard"] if kernel == "fused_scan" else details["k3_shard"]
        out["shapes"] = {name: {"rows": r["n"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
                         for name, r in timed.items()}
        return out

    kernels = [
        {"name": "fused_scan", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/fused_scan.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_fused.py:99",
         "launches": (serve["launches"]["fused_scan"] + writes["launches"]["fused_scan"]
                      + lifecycle_launches["fused_scan"]
                      + models["launches"]["fused_scan"] + geo["launches"]
                      + parallel_launches["fused_scan"] + ma["launches"]["fused_scan"]
                      + hv["launches"]["fused_scan"] + pv["launches"]["fused_scan"]),
         "launches_by_phase": {"serve": serve["launches"]["fused_scan"],
                               "writes": writes["launches"]["fused_scan"],
                               "lifecycle": lifecycle_launches["fused_scan"],
                               "models": models["launches"]["fused_scan"],
                               "training": geo["launches"],
                               "parallel": parallel_launches["fused_scan"],
                               "model_axis": ma["launches"]["fused_scan"],
                               "harness": hv["launches"]["fused_scan"],
                               "probes": pv["launches"]["fused_scan"]},
         "launches_by_shard": by_shard("fused_scan"),
         "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         # 1,048,576 rows, batch 128: each lexical query kind's route, the
         # pieces a K slab K1 counted, its time and bound
         "routes": {kind: {key: details[name][key] for key in (
             "route", "pieces", "ms", "lex_only_ms", "bound_ms", "bound_by", "max_abs_err")}
             for kind, name in (("f32", "k1"), ("served", "k1_served"))}},
        {"name": "tech_topk", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/tech_keys.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_tech.py:76",
         "launches": (serve["launches"]["tech_topk"] + writes["launches"]["tech_topk"]
                      + lifecycle_launches["tech_topk"]
                      + models["launches"]["tech_topk"]
                      + parallel_launches["tech_topk"] + ma["launches"]["tech_topk"]
                      + hv["launches"]["tech_topk"] + pv["launches"]["tech_topk"]),
         "launches_by_phase": {"serve": serve["launches"]["tech_topk"],
                               "writes": writes["launches"]["tech_topk"],
                               "lifecycle": lifecycle_launches["tech_topk"],
                               "models": models["launches"]["tech_topk"],
                               "parallel": parallel_launches["tech_topk"],
                               "model_axis": ma["launches"]["tech_topk"],
                               "harness": hv["launches"]["tech_topk"],
                               "probes": pv["launches"]["tech_topk"]},
         "launches_by_shard": by_shard("tech_topk"),
         "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
        {"name": "dense_scan", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/dense_scan.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_topk.py:84",
         "launches": recall_launches["dense_scan"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
    ]
    stamps = sorted(details["set_at_s"].items(), key=lambda kv: kv[1])
    log("phases (wall s, each entry since the one before; " + smi + "): "
        + ", ".join(f"{key} {at - before:.1f}" for (key, at), (_k, before)
                    in zip(stamps, [("start", 0.0)] + stamps[:-1]))
        + f"; total {time.perf_counter() - details.t0:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # the port runs without JAX and without the JAX package: make any
    # import of either fail loudly
    sys.modules["jax"] = None  # type: ignore[assignment]
    sys.modules["cadence_rag_tpu"] = None  # type: ignore[assignment]
    sys.exit(main())
