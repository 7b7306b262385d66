"""Filtered-ANN recall sweep: the ann lane's recall under selective masks.

Counterpart of ``cadence_rag_tpu/evals/filtered_recall_sweep.py``, which
imports jax at its top and is therefore re-implemented here. It measures
recall@k of the approximate dense lane against the masked exact scan
across (mask shape x density), at the serving path's (B, N) shapes:

- RANDOM masks scatter the valid rows, so the true top-k land in random
  groups and collisions do not depend on density;
- CONTIGUOUS masks (date windows; a call's rows are inserted together)
  concentrate the valid rows in a few blocks.

The port has no ``lax.approx_max_k``: its approximate lane is the serving
ann lane, kernel K1's dense candidates (one winner per strided 8-row group,
then an exact top-k; ``ops/fused_scan.py``). Each row still carries its
``recall_target``, which changes nothing in the port (engine/planner.py).
The corpus is clustered unit vectors generated on the device from a
``torch.Generator``, with the reference's geometry; masks and queries come
from numpy, as in the reference. Times are the host clock around each
call, from a ``torch.cuda.synchronize()`` to its readback.

Usage:
  python -m cadence_rag_tpu_torch.evals.filtered_recall_sweep
      [--n 1048576] [--batch 32] [--k 10] [--device cuda]
      [--densities 0.003,0.01,0.05,0.25,1.0]
      [--targets 0.95] [--mask-shapes contiguous,random]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.fused_scan import fused_topk
from ..ops.topk import dense_scores, masked_topk_exact

DIM = 1024
# rows per generation slab: bounds the f32 staging (131072 x 1024 x 4 B)
GEN_ROWS = 131072
# width of the all-zero lexical plane the ann lane's scan is handed (K1
# takes multiples of 32; its dense half does not depend on the lexical one)
LEX_PAD = 32


def gen_docs(n: int, *, n_centers: int, seed: int, device) -> torch.Tensor:
    """Clustered unit vectors: n_centers unit centers, each row a center
    plus 0.02 Gaussian noise, renormalized, stored bf16 -> (n, DIM)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    centers = torch.randn((n_centers, DIM), generator=g, device=dev)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    assign = torch.randint(0, n_centers, (n,), generator=g, device=dev)
    docs = torch.empty((n, DIM), dtype=torch.bfloat16, device=dev)
    for r0 in range(0, n, GEN_ROWS):
        r1 = min(n, r0 + GEN_ROWS)
        x = centers[assign[r0:r1]] + 0.02 * torch.randn(
            (r1 - r0, DIM), generator=g, device=dev)
        docs[r0:r1] = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(
            torch.bfloat16)
    return docs


def _make_mask(n: int, density: float, shape: str, rng) -> np.ndarray:
    """One (N,) validity row; every query in a batch shares the
    span/selection so the exact/approx comparison is apples-to-apples."""
    if density >= 1.0:
        return np.ones(n, dtype=bool)
    m = max(1, int(round(n * density)))
    row = np.zeros(n, dtype=bool)
    if shape == "contiguous":
        start = int(rng.integers(0, n - m + 1))
        row[start : start + m] = True
    else:
        row[rng.choice(n, size=m, replace=False)] = True
    return row


def batch_mask(mask_row: np.ndarray, batch: int, device) -> torch.Tensor:
    """The shared (N,) row as a contiguous (B, N) bool tensor on ``device``."""
    row = torch.from_numpy(np.ascontiguousarray(mask_row)).to(device)
    return row[None, :].expand(batch, -1).contiguous()


def exact_topk(q: torch.Tensor, docs: torch.Tensor, mask: torch.Tensor, k: int):
    """The masked exact scan (query rounded to bf16, f32 scores)."""
    return masked_topk_exact(dense_scores(q, docs), mask, k)


def ann_topk(q: torch.Tensor, docs: torch.Tensor, mask: torch.Tensor, k: int):
    """The serving ann lane: K1's dense candidates and their exact top-k,
    with an all-zero lexical plane and every row holding an embedding."""
    n, batch = docs.shape[0], q.shape[0]
    zeros_q = torch.zeros((batch, LEX_PAD), dtype=torch.float32, device=q.device)
    zeros_lex = torch.zeros((n, LEX_PAD), dtype=torch.int8, device=docs.device)
    has_emb = torch.ones(n, dtype=torch.bool, device=docs.device)
    return fused_topk(q, zeros_q, docs, zeros_lex, mask, has_emb,
                      k_dense=k, k_lex=1, dense=True)["dense"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_ids(fn, device, *args) -> tuple:
    """-> (positions as numpy, host seconds from a synchronize to the
    readback)."""
    _sync(device)
    t0 = time.perf_counter()
    ids = fn(*args)[1].cpu().numpy()
    return ids, time.perf_counter() - t0


def run_sweep(
    n: int,
    batch: int,
    k: int,
    densities,
    targets,
    mask_shapes,
    seed: int = 0,
    rounds: int = 4,
    device="cuda",
):
    dev = resolve_device(device)
    docs = gen_docs(n, n_centers=4096, seed=seed, device=dev)
    rng = np.random.default_rng(seed + 1)
    results = []
    for shape in mask_shapes:
        for density in densities:
            hits = {t: 0 for t in targets}
            total = 0
            t_exact = 0.0
            t_approx = {t: 0.0 for t in targets}
            for r in range(rounds):
                mask_np = _make_mask(n, density, shape, rng)
                valid = np.flatnonzero(mask_np)
                # queries perturbed from docs INSIDE the mask — a filtered
                # retrieval looks for documents in the filtered set
                pick = rng.choice(valid, size=batch, replace=len(valid) < batch)
                noise = 0.012 * rng.standard_normal((batch, DIM)).astype(np.float32)
                base = docs[torch.from_numpy(pick).to(dev)].float()
                q = base + torch.from_numpy(noise).to(dev)
                q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
                mask = batch_mask(mask_np, batch, dev)
                if r == 0:
                    # warm both paths (first launch, allocator) outside the
                    # timed window
                    exact_topk(q, docs, mask, k)
                    ann_topk(q, docs, mask, k)
                exact_idx, dt = _timed_ids(exact_topk, dev, q, docs, mask, k)
                t_exact += dt
                kk = min(k, len(valid))
                for t in targets:
                    # the port's ann lane has no recall knob: every target
                    # runs the same scan
                    idx, dt = _timed_ids(ann_topk, dev, q, docs, mask, k)
                    t_approx[t] += dt
                    for row in range(batch):
                        hits[t] += len(
                            set(map(int, exact_idx[row, :kk]))
                            & set(map(int, idx[row, :kk]))
                        )
                total += batch * kk
            for t in targets:
                rec = {
                    "n": n, "k": k, "batch": batch, "mask": shape,
                    "density": density,
                    "recall_target": t,
                    "recall_at_k": round(hits[t] / max(total, 1), 4),
                    "approx_ms": round(t_approx[t] / rounds * 1e3, 2),
                    "exact_ms": round(t_exact / rounds * 1e3, 2),
                }
                results.append(rec)
                print(json.dumps(rec), flush=True)
    return results


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=1_048_576)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--densities", default="0.003,0.01,0.05,0.25,1.0")
    p.add_argument("--targets", default="0.95")
    p.add_argument("--mask-shapes", default="contiguous,random")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu, cuda, cuda:N)")
    args = p.parse_args()
    run_sweep(
        n=args.n, batch=args.batch, k=args.k,
        densities=[float(x) for x in args.densities.split(",")],
        targets=[float(x) for x in args.targets.split(",")],
        mask_shapes=args.mask_shapes.split(","),
        seed=args.seed, rounds=args.rounds, device=args.device,
    )


if __name__ == "__main__":
    main()
