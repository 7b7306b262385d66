"""ANN recall gate: recall@k of an approximate dense path vs the exact scan.

Counterpart of ``cadence_rag_tpu/evals/ann_recall_gate.py``: the same CLI,
corpus geometry, query construction, recall count and floor, over the
port's dense paths. Modes:

- ``exact``  — the masked exact scan itself (recall 1 by construction);
- ``ann``    — the serving ann lane: kernel K1's dense candidates (one
               winner per strided 8-row group) and their exact top-k;
- ``pallas`` — kernel K2 (``ops/dense_scan.cosine_topk``, block_n 1024):
               one winner per CONTIGUOUS 8-row group, then an exact top-k;
- ``ivf``    — the probed-cluster index of ``ops/ivf.py`` (sqrt(N)
               clusters, 8% probed); its probes ignore the mask, so its
               filtered recall is reported, not a property of the index;
- ``hnsw``   — the native HNSW graph (``native/hnsw.py``, a
               CPU cross-check, unfiltered only).

The corpus is ``max(64, N/64)`` unit centers with 0.02 noise per row,
stored bf16, generated on the device from a ``torch.Generator``; masks and
queries come from numpy as in the reference. ``recall_from_arrays`` takes
the arrays themselves, so the same numpy inputs can be handed to this
gate and to the JAX package's mode functions. Where K2 differs from the
reference kernel: it accepts a corpus that is not a multiple of block_n,
so ``--mode pallas`` runs at the default n = 100,000.

Usage: python -m cadence_rag_tpu_torch.evals.ann_recall_gate [--n 100000]
       [--queries 64] [--k 10] [--min-recall 0.95]
       [--mode exact|ann|pallas|ivf|hnsw] [--densities 1.0,0.05,0.003]
       [--mask-shape contiguous|random] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..engine.planner import recall_target_for_ef_search
from ..ops.dense_scan import cosine_topk
from ..ops.ivf import build_buckets, ivf_topk, kmeans
from .filtered_recall_sweep import (
    _make_mask, ann_topk, batch_mask, exact_topk, gen_docs,
)

MODES = ("exact", "ann", "pallas", "ivf", "hnsw")
PALLAS_BLOCK_N = 1024
IVF_SEED = 7

# (q (B, dim) f32 tensor, mask (B, N) bool tensor) -> positions (B, >=k)
TopkFn = Callable[[torch.Tensor, torch.Tensor], np.ndarray]


def make_queries(docs: torch.Tensor, n_queries: int, *, seed: int,
                 density: float, mask_shape: str):
    """-> (queries (Q, dim) f32 numpy, mask_row (N,) bool numpy): queries
    are documents inside the mask plus 0.012 noise, renormalized."""
    n, dim = docs.shape
    rng = np.random.default_rng(seed + 1)
    mask_row = _make_mask(n, density, mask_shape, rng)
    valid = np.flatnonzero(mask_row)
    pick = rng.choice(valid, size=n_queries, replace=len(valid) < n_queries)
    base = docs[torch.from_numpy(pick).to(docs.device)].float().cpu().numpy()
    queries = base + 0.012 * rng.standard_normal((n_queries, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return queries, mask_row


def ivf_index(docs: torch.Tensor, init_idx: Optional[np.ndarray] = None):
    """The gate's IVF over ``docs``: sqrt(N) clusters (>= 16), 10 k-means
    iterations, buckets of twice the mean size, 8% of clusters probed.
    ``init_idx`` fixes the initial centroid rows (else a generator seeded
    7). -> (centroids, buckets, overflow, nprobe)"""
    n = docs.shape[0]
    n_clusters = max(16, int(np.sqrt(n)))
    gen = torch.Generator(device=docs.device)
    gen.manual_seed(IVF_SEED)
    centroids, assign = kmeans(
        docs, n_clusters=n_clusters, iters=10, generator=gen,
        init_idx=None if init_idx is None else torch.from_numpy(
            np.asarray(init_idx, dtype=np.int64)))
    buckets, overflow = build_buckets(
        assign.cpu().numpy(), n_clusters, int(2.0 * n / n_clusters))
    if len(overflow) == 0:
        overflow = np.full(8, -1, dtype=np.int32)
    dev = docs.device
    return (centroids, torch.from_numpy(buckets).to(dev),
            torch.from_numpy(overflow).to(dev), max(4, int(n_clusters * 0.08)))


def mode_topk(mode: str, docs: torch.Tensor, *, k: int, ef_search: int = 80,
              ivf_init_idx: Optional[np.ndarray] = None) -> TopkFn:
    """The approximate top-k of ``mode`` over ``docs``, built once (the IVF
    clustering, the HNSW graph) and reused for every batch."""
    if mode == "exact":
        return lambda q, m: exact_topk(q, docs, m, k)[1].cpu().numpy()
    if mode == "ann":
        return lambda q, m: ann_topk(q, docs, m, k)[1].cpu().numpy()
    if mode == "pallas":
        return lambda q, m: cosine_topk(
            q, docs, m, k, block_n=PALLAS_BLOCK_N)[1].cpu().numpy()
    if mode == "ivf":
        centroids, buckets, overflow, nprobe = ivf_index(docs, ivf_init_idx)
        return lambda q, m: ivf_topk(
            q, docs, centroids, buckets, overflow, m, k=k,
            nprobe=nprobe)[1].cpu().numpy()
    if mode == "hnsw":
        from ..native.hnsw import HnswIndex

        index = HnswIndex(docs.float().cpu().numpy(), m=16, ef_construction=64)
        return lambda q, m: index.search(
            q.cpu().numpy(), k=k, ef_search=ef_search)[1]
    raise ValueError(f"unknown mode {mode!r} (one of {', '.join(MODES)})")


def recall_from_arrays(
    docs, queries: np.ndarray, mask_row: np.ndarray, mode: str, *,
    k: int = 10, ef_search: int = 80, batch: int = 16,
    topk_fn: Optional[TopkFn] = None,
    ivf_init_idx: Optional[np.ndarray] = None,
) -> Dict:
    """recall@k of ``mode`` against the masked exact scan.

    ``docs`` is an (N, dim) tensor (its device runs the gate) or a numpy
    array (run on the CPU); either way the rows are stored bf16.
    ``queries`` (Q, dim) f32 and ``mask_row`` (N,) bool are numpy; every
    query shares the mask. ``topk_fn`` reuses a ``mode_topk`` built
    earlier. -> {"recall_at_k", "hits", "total", "mode_ms"} where mode_ms
    is the host time of the mode's calls (synchronize to readback)."""
    if not isinstance(docs, torch.Tensor):
        docs = torch.from_numpy(np.asarray(docs, dtype=np.float32))
    docs = docs.to(torch.bfloat16)
    dev = docs.device
    if mode == "hnsw" and not mask_row.all():
        raise ValueError(
            "hnsw mode is the unfiltered CPU cross-check; its search has no "
            "mask plumbing — gate filtered recall with ann/ivf")
    if topk_fn is None:
        topk_fn = mode_topk(mode, docs, k=k, ef_search=ef_search,
                            ivf_init_idx=ivf_init_idx)
    valid = int(mask_row.sum())
    kk = min(k, valid)
    hits = total = 0
    mode_s = 0.0
    for start in range(0, queries.shape[0], batch):
        q = torch.from_numpy(np.ascontiguousarray(
            queries[start : start + batch], dtype=np.float32)).to(dev)
        mask = batch_mask(mask_row, q.shape[0], dev)
        exact_idx = exact_topk(q, docs, mask, k)[1].cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ann_idx = topk_fn(q, mask)
        mode_s += time.perf_counter() - t0
        for row in range(exact_idx.shape[0]):
            hits += len(set(map(int, exact_idx[row, :kk]))
                        & set(map(int, ann_idx[row, :kk])))
            total += kk
    return {"recall_at_k": round(hits / max(total, 1), 4), "hits": hits,
            "total": total, "mode_ms": mode_s * 1e3}


def measure_recall(
    n: int = 100_000,
    n_queries: int = 64,
    k: int = 10,
    mode: str = "ann",
    ef_search: int = 80,
    seed: int = 0,
    batch: int = 16,
    density: float = 1.0,
    mask_shape: str = "contiguous",
    device="cuda",
) -> Dict:
    docs = gen_docs(n, n_centers=max(64, n // 64), seed=seed,
                    device=resolve_device(device))
    queries, mask_row = make_queries(docs, n_queries, seed=seed,
                                     density=density, mask_shape=mask_shape)
    got = recall_from_arrays(docs, queries, mask_row, mode, k=k,
                             ef_search=ef_search, batch=batch)
    return {
        "n": n, "k": k, "queries": n_queries, "mode": mode,
        "ef_search": ef_search,
        "recall_target": round(recall_target_for_ef_search(ef_search), 4),
        "density": density, "mask_shape": mask_shape,
        "recall_at_k": got["recall_at_k"],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description="ANN recall gate")
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--queries", type=int, default=64)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--min-recall", type=float, default=0.95)
    parser.add_argument("--mode", choices=list(MODES), default="ann")
    parser.add_argument("--ef-search", type=int, default=80)
    parser.add_argument(
        "--densities", default="1.0",
        help="comma list of mask densities to gate (1.0 = unfiltered)",
    )
    parser.add_argument(
        "--mask-shape", choices=["contiguous", "random"], default="contiguous",
        help="contiguous = the worst case (date/call filters)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cpu, cuda, cuda:N)")
    args = parser.parse_args()
    failed = False
    for density in (float(x) for x in args.densities.split(",")):
        result = measure_recall(
            n=args.n, n_queries=args.queries, k=args.k,
            mode=args.mode, ef_search=args.ef_search,
            density=density, mask_shape=args.mask_shape, device=args.device,
        )
        print(json.dumps(result))
        if result["recall_at_k"] < args.min_recall:
            failed = True
            print(
                f"GATE FAILED: recall@{args.k} {result['recall_at_k']} < "
                f"{args.min_recall} at density {density}",
                file=sys.stderr,
            )
    if failed:
        sys.exit(1)
    print("GATE PASSED")


if __name__ == "__main__":
    main()
