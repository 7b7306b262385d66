#!/usr/bin/env python3
"""Drive the PyTorch port's /retrieve path once on one CUDA card.

    python3 chip_smoke.py [--details PATH]

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
             (a) unique ids_only /retrieve, 2 cold then 20 warm rounds,
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
             The kernels line's K1 and K3 launches are this phase's.
7. K2      — ``dense_scan`` against its plain version at batch 128 x 1M rows
             (a contiguous and a random 5% mask) and at a ragged 100,000
             rows, batch 64, with CUDA-event times beside the plain version
             and ``torch.matmul`` of the bf16 product; then every block
             size at 1M rows and ragged / aligned row counts at batch 1-300.
8. recall  — the port's ANN recall gate in-process: modes ann, pallas (K2)
             and ivf at 1M rows, 64 queries, k 10, densities 1.0 and 0.003
             contiguous and 0.05 random; hnsw at 16,384 rows unfiltered;
             recall under 0.95 fails (ivf under a filter is printed, not
             held). Then the filtered-recall sweep at 1M rows. K2 must
             have launched.
9. ivf     — ``build_ivf`` on phase 5's chunks, then one unscoped batch of
             128 planned with ``dense_ivf_enabled``: the planner must choose
             ivf, IVF must serve the chunks' dense lane, and every known
             row must come first (host RRF, as device RRF is off).

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``. ``--details PATH`` also writes every
measurement (and ptxas's register report) as JSON. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import re
import socket
import subprocess
import sys
import threading
import time
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
def k1_inputs(device, n, batch, dim, lex_dim, emb_dtype, seed):
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
    lex = torch.randint(-4, 5, (n, lex_dim), generator=g, device=device,
                        dtype=torch.int8)
    # sparse idf-weighted queries, as ops/pack._densify rebuilds them
    q_lex = torch.zeros((batch, lex_dim), device=device)
    q_lex.scatter_add_(
        1, torch.randint(0, lex_dim, (batch, 64), generator=g, device=device),
        torch.randn((batch, 64), generator=g, device=device) * 0.5)
    # a real filter: half the calls, a date window on odd queries, 1% of
    # rows invalid, 2% of rows without embeddings
    call_idx = torch.randint(0, N_CALLS, (n,), generator=g, device=device,
                             dtype=torch.int32)
    started = torch.randint(1_600_000_000, 1_750_000_000, (n,), generator=g,
                            device=device, dtype=torch.int32)
    started[torch.rand((n,), generator=g, device=device) < 0.01] = INT32_MIN
    allowed = torch.rand((batch, N_CALLS), generator=g, device=device) < 0.5
    dmin = torch.full((batch,), INT32_MIN + 1, dtype=torch.int32, device=device)
    dmin[1::2] = 1_650_000_000
    dmax = torch.full((batch,), INT32_MAX, dtype=torch.int32, device=device)
    mask = filter_mask(call_idx, started, allowed, dmin, dmax)
    has_emb = torch.rand((n,), generator=g, device=device) > 0.02
    return q_emb, q_lex, emb, lex, mask, has_emb


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


def check_k1(device, n, batch, dim, lex_dim, emb_dtype, seed, reps, dense=True):
    """``fused_scan`` against ``fused_scan_plain`` at one shape, both lanes
    (or the lexical lane alone, ``dense`` False, as ``exact`` mode runs
    it); with ``reps`` > 0 (dense only) also timed."""
    from cadence_rag_tpu_torch.ops.fused_scan import (
        fused_scan, fused_scan_plain, n_candidates,
    )
    from cadence_rag_tpu_torch.ops.lexical import LEX_MATCH_THRESHOLD

    args = k1_inputs(device, n, batch, dim, lex_dim, emb_dtype, seed)
    q_emb, q_lex, emb, lex, mask, has_emb = args
    got = fused_scan(*args, dense=dense)
    torch.cuda.synchronize()
    want = fused_scan_plain(*args, dense=dense)
    nc = n_candidates(n)
    if got[2].shape != (batch, nc) or want[2].shape != (batch, nc):
        raise RuntimeError(f"candidate shape {tuple(got[2].shape)} != {(batch, nc)}")
    lexical = check_lane(
        got[2], got[3], want[2], want[3], (q_lex.float(), lex, 1.0, mask, n),
        LEX_ATOL, LEX_MATCH_THRESHOLD)
    if not dense:
        del got, want, args
        torch.cuda.empty_cache()
        return {"n": n, "batch": batch, "emb_dtype": str(emb_dtype), "dense": None,
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
                "lex": lexical,
                "max_abs_err": max(dense["max_abs_err"], lexical["max_abs_err"])}
    ms = cuda_ms(lambda: fused_scan(*args, dense=True), reps)
    plain_ms = cuda_ms(lambda: fused_scan_plain(*args, dense=True), 1)
    lex_only_ms = cuda_ms(lambda: fused_scan(*args, dense=False), reps)
    # useful work; the tensor work with the lexical query's three bf16
    # pieces counted; the bytes the call must read from device memory
    gflop = 2.0 * batch * n * (dim + lex_dim) / 1e9
    tensor_gflop = 2.0 * batch * n * (dim + 3 * lex_dim) / 1e9
    gbytes = (n * (dim * emb.element_size() + lex_dim + 1) + batch * n) / 1e9
    result = {
        "n": n, "batch": batch, "dim": dim, "lex_dim": lex_dim,
        "emb_dtype": str(emb_dtype), "dense": dense, "lex": lexical,
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
    log(f"K1 fused_scan n={n} batch={batch} {emb_dtype}: kernel {ms:.3f} ms "
        f"({gflop / ms:.2f} TFLOP/s useful; {tensor_gflop / ms:.2f} TFLOP/s of "
        f"bf16 tensor work with the 3-piece split, {result['tensor_share']:.1%} "
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


def check_k3(device, n, batch, slots, seed, reps):
    """Every density x k at batch x n, then a ragged n, batch 1, batch 200
    and two structures per query; then times at chip_smoke's traffic
    ("smoke"), k 50, with one structure per query (16 wide) and two (32
    wide, the main path's chunk queries). The kernels line reports the
    32-wide times."""
    from cadence_rag_tpu_torch.ops.tech_keys import (
        MAX_K, n_candidates, range_topk, range_topk_plain, tech_topk_keys,
    )
    from cadence_rag_tpu_torch.ops.techlane import tech_match
    from cadence_rag_tpu_torch.ops.topk import topk_from_keys

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
    timing = {}
    nc = n_candidates(n, 50)
    for cap in (1, 2):
        q, tech, started, mask = k3_inputs(device, n, batch, slots, "smoke", seed,
                                           capacity=cap)
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
        timing[cap * slots] = {
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
    (``corpora``: {corpus: rows, dim, lex_dim, slots, emb_dtype})."""
    k1_cases, k3_cases = served_cases(dispatched)
    k1, k3 = [], []
    for i, (corpus, dense, batch) in enumerate(k1_cases):
        c = corpora[corpus]
        got = check_k1(device, c["rows"], batch, c["dim"], c["lex_dim"],
                       c["emb_dtype"], seed=seed + i, reps=0, dense=dense)
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
                         "build_s": build_s})
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
              warm_rounds=20, bench_iters=10, profile=True, window_ms=5):
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
    the real gate on ``device``. -> summary"""
    import shutil
    import tempfile

    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.evals.synth import (
        bulk_store_rows, install_synthetic_corpus,
    )
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
                 "log_level": "WARNING"}
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
        summary["split_packs"] = engine_split(reqs("evidence_pack_json"), 5)
        summary["split_scoped"] = engine_split(lambda r: [
            RetrieveRequest.model_validate(body) for body in scoped(10_000 + r)], 5)
        summary["engine_qps"] = {
            f"{style} {'serial' if depth is None else f'depth {depth}'}":
                engine_qps(reqs(style), bench_iters, depth)
            for style in ("ids_only", "evidence_pack_json")
            for depth in (None, 2, 3)}
    finally:
        if stop is not None:
            stop()
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

    outcome = run_gate(device=device)
    summary["gate"] = outcome["metrics"]
    low = {k: outcome["metrics"][k] for k, floor in GATE_FLOORS.items()
           if outcome["metrics"][k] < floor}
    if low or outcome["failures"]:
        raise RuntimeError(f"real gate under its floors: {low} {outcome['failures']}")
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--details", type=Path, default=None,
                        help="write every measurement as JSON to this file")
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
    details = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__}

    t0 = time.perf_counter()
    build.load()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_report(build.LOG_PATH.read_text())
    details.update(build_s=build_s, nvcc_s=build.last_build_seconds, ptxas=ptxas)
    log(f"build: {build_s:.1f} s (nvcc {build.last_build_seconds:.1f} s) -> "
        f"{build.LIB_PATH}; ptxas (registers at entry, spill stores/loads B): "
        + " | ".join(f"{r['kernel']} {r['registers']} regs, spills "
                     f"{r['spill_stores']}/{r['spill_loads']}" for r in ptxas))

    details["k1"] = check_k1(device, 1_048_576, 128, 1024, 4096,
                             torch.bfloat16, seed=1, reps=5)
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

    serve = run_serve(device, 1_000_000, 100_000)
    details["serve"] = serve
    if min(serve["launches"].values()) <= 0:
        raise RuntimeError(f"the served path did not launch K1 and K3: {serve['launches']}")
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
    log("gate (real, fixtures, on the card): " + ", ".join(
        f"{k} {serve['gate'][k]:.4f} (floor {floor})" for k, floor in GATE_FLOORS.items()))
    details["served_shapes"] = check_served_shapes(
        device, serve["dispatched"], serve["corpora"], seed=20)
    k1_err = max(details["k1"]["max_abs_err"], details["k1_ragged_int8"]["max_abs_err"],
                 details["served_shapes"]["k1_max_abs_err"])

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
    details["recall"] = run_recall(device, 1_048_576, 64, 10, hnsw_n=16_384,
                                   sweep_n=1_048_576, sweep_rounds=2)
    recall_launches = {"dense_scan": dense_scan.launches,
                       "fused_scan": fused_scan.launches}
    if min(recall_launches.values()) <= 0:
        raise RuntimeError(f"the recall gate did not launch K1 and K2: {recall_launches}")

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

    k1, k3, k2 = details["k1"], details["k3"], details["k2"]
    kernels = [
        {"name": "fused_scan", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/fused_scan.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_fused.py:99",
         "launches": serve["launches"]["fused_scan"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "tech_topk", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/tech_keys.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_tech.py:76",
         "launches": serve["launches"]["tech_topk"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
        {"name": "dense_scan", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/dense_scan.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_topk.py:84",
         "launches": recall_launches["dense_scan"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
    ]
    if opts.details is not None:
        opts.details.parent.mkdir(parents=True, exist_ok=True)
        opts.details.write_text(json.dumps(details, indent=1, default=str))
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
