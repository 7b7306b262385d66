#!/usr/bin/env python3
"""Drive the PyTorch port's /retrieve device path once on one CUDA card.

    python3 chip_smoke.py [--details PATH]

Phases, each printing one line; any failure exits nonzero without the
final result line:

1. device  — require CUDA; print the card and ``nvidia-smi``'s name and
             power limit.
2. build   — build the kernels from ``cadence_rag_tpu_torch/csrc`` with nvcc.
3. K1      — ``fused_scan`` against its plain PyTorch version at the main
             path's shapes (batch 128, 1,048,576 rows, 1024-d bf16, 4096-wide
             int8, a real filter mask, rows without embeddings) and at a
             ragged row count with int8 embeddings.
4. K3      — ``tech_keys`` against its plain version at batch 128 x 1M rows,
             16 slots: keys and top-k ids identical, ties included.
5. main    — a port ``DeviceIndexManager`` with 1M synthetic chunks and 100k
             artifacts plus known rows; 128 planned queries naming them go
             through ``query_both_packed_async`` -> ``collect_packed`` with
             device RRF, unscoped (chunks served "ann") and scoped ("exact").
             Each known row must come first; K1 and K3 must have launched.

The second-to-last line is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``. ``--details PATH`` also writes every
measurement (and ptxas's register report) as JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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
KNOWN_ID0 = 50_000_000
KNOWN_STARTED = 1_760_000_000    # after every synthetic row: newest call
# K1 tolerances: f32 sums of exact products taken in another order
DENSE_ATOL = 1e-4                # 1024-term sums of |score| <= 1
LEX_ATOL = 1e-3                  # 4096-term sums, |score| up to ~1e2


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


def check_lane(kv, ki, pv, pi, lane, atol, threshold=None):
    """Kernel vs plain candidates of one lane; every kernel candidate is
    proven, not only counted:

    - values agree within ``atol`` where both are finite; a lexical
      candidate may flip between -inf and a score at the match threshold
      (the f32 sum landing on the other side of 1e-3);
    - each finite kernel candidate's row lies in its own group (block
      c // 128, rows ``w*128 + c % 128``) and passes the lane's mask;
    - where the kernel's row differs from the plain version's (or only the
      kernel found one), that row's score is recomputed from the inputs:
      it must equal the kernel's value and lie within ``atol`` of the plain
      winner, so the swap is a true near-tie;
    - the lane's top-50 rows are rescored from the inputs the same way.

    ``lane`` = (q, table, scale, keep (B, N) bool, n)."""
    from cadence_rag_tpu_torch.ops.fused_scan import (
        BLOCK_ROWS, GROUPS, candidate_topk,
    )

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
    in_group = ((rows >= 0) & (rows < n) & (rows // BLOCK_ROWS == cand // GROUPS)
                & (rows % GROUPS == cand % GROUPS))
    if not bool((in_group | ~finite_k).all()):
        raise RuntimeError(f"{int((~in_group & finite_k).sum())} kernel "
                           "candidates name a row outside their group")
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
    # the lane's final top-50, as the main path takes it
    k_vals, k_pos = candidate_topk(kv, ki, 50)
    p_vals, p_pos = candidate_topk(pv, pi, 50)
    fin = torch.isfinite(p_vals)
    if not torch.equal(fin, torch.isfinite(k_vals)) or float(
            (k_vals[fin] - p_vals[fin]).abs().max()) > atol:
        raise RuntimeError("K1 top-50 values disagree with the plain version")
    b_idx, j_idx = torch.isfinite(k_vals).nonzero(as_tuple=True)
    top_rows = k_pos[b_idx, j_idx]
    top_err = float((row_scores(q, table, scale, b_idx, top_rows)
                     - k_vals[b_idx, j_idx]).abs().max())
    if top_err > atol or not bool(keep[b_idx, top_rows].all()):
        raise RuntimeError(f"K1 top-50 rows rescore {top_err} from their "
                           f"values (tol {atol}) or fail the lane's mask")
    return {"max_abs_err": max_err, "rescore_err": max(rescore_err, top_err),
            "near_tie_rows": n_differ, "threshold_flips": n_flips,
            "top50_id_diffs": int((k_pos != p_pos).sum())}


def check_k1(device, n, batch, dim, lex_dim, emb_dtype, seed, reps):
    from cadence_rag_tpu_torch.ops.fused_scan import (
        fused_scan, fused_scan_plain, n_candidates,
    )
    from cadence_rag_tpu_torch.ops.lexical import LEX_MATCH_THRESHOLD

    args = k1_inputs(device, n, batch, dim, lex_dim, emb_dtype, seed)
    q_emb, q_lex, emb, lex, mask, has_emb = args
    got = fused_scan(*args, dense=True)
    torch.cuda.synchronize()
    want = fused_scan_plain(*args, dense=True)
    nc = n_candidates(n)
    if got[0].shape != (batch, nc) or want[0].shape != (batch, nc):
        raise RuntimeError(f"candidate shape {tuple(got[0].shape)} != {(batch, nc)}")
    scale = 1.0 / 127.0 if emb_dtype == torch.int8 else 1.0
    dense = check_lane(
        got[0], got[1], want[0], want[1],
        (q_emb.to(torch.bfloat16).float(), emb, scale,
         mask & has_emb[None, :], n), DENSE_ATOL)
    lexical = check_lane(
        got[2], got[3], want[2], want[3], (q_lex.float(), lex, 1.0, mask, n),
        LEX_ATOL, LEX_MATCH_THRESHOLD)
    del got, want
    ms = cuda_ms(lambda: fused_scan(*args, dense=True), reps)
    plain_ms = cuda_ms(lambda: fused_scan_plain(*args, dense=True), 1)
    lex_only_ms = cuda_ms(lambda: fused_scan(*args, dense=False), reps)
    gflop = 2.0 * batch * n * (dim + lex_dim) / 1e9
    result = {
        "n": n, "batch": batch, "dim": dim, "lex_dim": lex_dim,
        "emb_dtype": str(emb_dtype), "dense": dense, "lex": lexical,
        "max_abs_err": max(dense["max_abs_err"], lexical["max_abs_err"]),
        "ms": ms, "plain_ms": plain_ms, "lex_only_ms": lex_only_ms,
        "tflops": gflop / ms,
    }
    log(f"K1 fused_scan n={n} batch={batch} {emb_dtype}: kernel {ms:.3f} ms "
        f"({gflop / ms:.2f} TFLOP/s), lexical-only {lex_only_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms; max |err| dense {dense['max_abs_err']:.3g} "
        f"(tol {DENSE_ATOL}) lex {lexical['max_abs_err']:.3g} (tol {LEX_ATOL}); "
        f"rows rescored from the inputs within {max(dense['rescore_err'], lexical['rescore_err']):.3g}; "
        f"near-tie rows {dense['near_tie_rows']}/{lexical['near_tie_rows']} "
        f"of {batch * nc}, threshold flips {lexical['threshold_flips']}, "
        f"top-50 id diffs {dense['top50_id_diffs']}/{lexical['top50_id_diffs']}")
    del args
    torch.cuda.empty_cache()
    return result


# -- K3 -----------------------------------------------------------------------
def check_k3(device, n, batch, slots, seed, reps):
    from cadence_rag_tpu_torch.ops.tech_keys import tech_keys, tech_keys_plain
    from cadence_rag_tpu_torch.ops.topk import topk_from_keys

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tech = torch.randint(1, 5000, (n, slots), generator=g, device=device,
                         dtype=torch.int32)
    # every row of a call shares its start second: ties are the normal case
    call_start = torch.randint(1_600_000_000, 1_750_000_000, (N_CALLS,),
                               generator=g, device=device, dtype=torch.int32)
    started = call_start[torch.randint(0, N_CALLS, (n,), generator=g,
                                       device=device)]
    started[torch.rand((n,), generator=g, device=device) < 0.01] = INT32_MIN
    # slot-aligned query structures copied from random rows, some columns empty
    src = torch.randint(0, n, (batch,), generator=g, device=device)
    q = tech[src].clone()
    q[torch.rand(q.shape, generator=g, device=device) < 0.5] = 0
    mask = (torch.rand((batch, n), generator=g, device=device) < 0.9) & (
        started != INT32_MIN)[None, :]
    got = tech_keys(q, tech, started, mask)
    want = tech_keys_plain(q, tech, started, mask)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"K3 keys differ from the plain version at {bad} entries")
    k_vals, k_ids = topk_from_keys(got, 50)
    p_vals, p_ids = topk_from_keys(want, 50)
    if not (torch.equal(k_ids, p_ids) and torch.equal(k_vals, p_vals)):
        raise RuntimeError("K3 top-50 ids differ from the plain version")
    matches = int(torch.isfinite(p_vals).sum())
    ms = cuda_ms(lambda: tech_keys(q, tech, started, mask), reps)
    plain_ms = cuda_ms(lambda: tech_keys_plain(q, tech, started, mask), 1)
    topk_ms = cuda_ms(lambda: topk_from_keys(got, 50), reps)
    log(f"K3 tech_keys n={n} batch={batch} slots={slots}: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, top-50 over the keys {topk_ms:.3f} ms; keys "
        f"and top-50 ids identical ({matches} finite of {batch * 50})")
    del tech, started, q, mask, got, want
    torch.cuda.empty_cache()
    return {"n": n, "batch": batch, "slots": slots, "ms": ms,
            "plain_ms": plain_ms, "topk_ms": topk_ms, "max_abs_err": 0.0,
            "finite_top50": matches}


# -- main path ----------------------------------------------------------------
KNOWN_TEXT = ("incident {i}: kafka consumer lag on broker-{i} after the "
              "gateway upgrade to v3.{i}.7 caused ECONNRESET storms")


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
    texts = [KNOWN_TEXT.format(i=i) for i in range(n_known)]
    tokens = [[f"broker-{i}", f"v3.{i}.7"] for i in range(n_known)]
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
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import tech_keys

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
    ptxas = [ln.strip() for ln in build.LOG_PATH.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    details.update(build_s=build_s, nvcc_s=build.last_build_seconds, ptxas=ptxas)
    log(f"build: {build_s:.1f} s (nvcc {build.last_build_seconds:.1f} s) -> "
        f"{build.LIB_PATH}; ptxas: " + " | ".join(ptxas))

    details["k1"] = check_k1(device, 1_048_576, 128, 1024, 4096,
                             torch.bfloat16, seed=1, reps=5)
    details["k1_ragged_int8"] = check_k1(device, 300_037, 128, 1024, 4096,
                                         torch.int8, seed=2, reps=3)
    details["k3"] = check_k3(device, 1_048_576, 128, 16, seed=3, reps=10)

    fused_scan.launches = 0
    tech_keys.launches = 0
    index, batches, summary = run_main_path(
        device, 1_000_000, 100_000, batch=128, n_known=16)
    launches = {"fused_scan": fused_scan.launches, "tech_keys": tech_keys.launches}
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

    kernels = [
        {"name": "fused_scan", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/fused_scan.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_fused.py:99",
         "launches": launches["fused_scan"],
         "max_abs_err": details["k1"]["max_abs_err"],
         "ms": details["k1"]["ms"], "plain_ms": details["k1"]["plain_ms"]},
        {"name": "tech_keys", "route": "cuda",
         "source": "cadence_rag_tpu_torch/csrc/tech_keys.cu",
         "replaces": "cadence_rag_tpu/ops/pallas_tech.py:76",
         "launches": launches["tech_keys"],
         "max_abs_err": details["k3"]["max_abs_err"],
         "ms": details["k3"]["ms"], "plain_ms": details["k3"]["plain_ms"]},
    ]
    if opts.details is not None:
        opts.details.parent.mkdir(parents=True, exist_ok=True)
        opts.details.write_text(json.dumps(details, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # the port runs without JAX: make any import of it fail loudly
    os.environ.pop("CADENCE_FORCE_PLATFORM", None)
    sys.modules["jax"] = None  # type: ignore[assignment]
    sys.exit(main())
