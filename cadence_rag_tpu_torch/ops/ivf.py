"""IVF (inverted-file) dense index: k-means build and probed query.

Counterpart of ``cadence_rag_tpu/ops/ivf.py`` (``kmeans``,
``build_buckets``, ``ivf_topk``), re-implemented because that module
imports jax at its top. The JAX module has no Pallas kernel; this one is
plain torch, and its matrix products are f32 ``torch.matmul`` as the JAX
package leaves them to XLA.

- build: spherical k-means on the device — assignment is an (N, dim) x
  (dim, C) product and an argmax, update a scatter-add; then the host packs
  positions into fixed-size buckets, spilling the excess to an overflow
  tail that every query scans;
- query: score the C centroids, probe the top ``nprobe`` clusters, gather
  only those buckets' rows (plus the overflow tail) and score them exactly.

Parity details kept from the reference:

- ``kmeans`` scores ``emb @ centroids.astype(emb.dtype)`` in f32: the
  centroids are rounded to the rows' dtype and widened, and the product is
  an f32 matmul by row slabs (a bf16 matmul would round its output to bf16
  and flip argmax ties). Empty clusters keep their centroid. The initial
  rows come from a ``torch.Generator`` (``jax.random.choice`` cannot be
  reproduced), or from ``init_idx``, which the tests fill with JAX's.
- ``ivf_topk`` scores centroids and gathered rows with the f32 query (no
  bf16 rounding, unlike ``dense_scores``); int8 rows take the 1/127 scale;
  positions are -1 where a score is not finite; the output is padded to
  (B, k) with -inf / -1 when the probed set is smaller than k; ties keep
  ``lax.top_k``'s lowest-index-first order. The per-query gather is grouped
  to about 1 GB of gathered rows, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .topk import INT8_SCALE, NEG_INF, ROW_CHUNK, topk_lowest_index_first

# bytes of gathered rows per query group in ivf_topk (ivf.py:175)
GATHER_BYTES = 1 << 30


def _assign(emb: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmax over clusters of ``emb @ centroids.astype(emb.dtype)`` in f32,
    by row slabs -> (N,) int64."""
    c = centroids.to(emb.dtype).float().T
    out = torch.empty(emb.shape[0], dtype=torch.int64, device=emb.device)
    for r0 in range(0, emb.shape[0], ROW_CHUNK):
        r1 = min(emb.shape[0], r0 + ROW_CHUNK)
        out[r0:r1] = torch.argmax(emb[r0:r1].float() @ c, dim=1)
    return out


def kmeans(
    emb: torch.Tensor, *, n_clusters: int, iters: int = 10,
    generator: Optional[torch.Generator] = None,
    init_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means over unit rows (bf16, or f32 such as dequantized
    int8). -> (centroids (C, dim) f32, assignments (N,) int32). The initial
    centroids are the rows ``init_idx`` (distinct), else ``n_clusters``
    distinct rows drawn with ``generator``."""
    n, dim = emb.shape
    dev = emb.device
    if init_idx is None:
        init_idx = torch.randperm(n, generator=generator,
                                  device=generator.device if generator else "cpu")
        init_idx = init_idx[:n_clusters]
    centroids = emb[init_idx.to(dev)].float()
    for _ in range(iters):
        assign = _assign(emb, centroids)
        sums = torch.zeros((n_clusters, dim), dtype=torch.float32, device=dev)
        for r0 in range(0, n, ROW_CHUNK):
            r1 = min(n, r0 + ROW_CHUNK)
            sums.index_add_(0, assign[r0:r1], emb[r0:r1].float())
        counts = torch.bincount(assign, minlength=n_clusters)
        norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
        fresh = sums / torch.clamp(norms, min=1e-6)
        centroids = torch.where((counts == 0)[:, None], centroids, fresh)
    return centroids, _assign(emb, centroids).to(torch.int32)


def build_buckets(
    assignments: np.ndarray, n_clusters: int, bucket_cap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack positions into padded per-cluster buckets in position order.
    -> (buckets (C, cap) int32 with -1 padding, overflow (V,) int32: the
    positions beyond their bucket's capacity, ascending). The same output
    as the reference's loop, computed with a stable sort."""
    assign = np.asarray(assignments).astype(np.int64)
    order = np.argsort(assign, kind="stable")
    sorted_c = assign[order]
    first = np.searchsorted(sorted_c, np.arange(n_clusters))
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size) - first[sorted_c]
    fits = rank < bucket_cap
    buckets = np.full((n_clusters, bucket_cap), -1, dtype=np.int32)
    pos = np.flatnonzero(fits)
    buckets[assign[pos], rank[pos]] = pos
    return buckets, np.flatnonzero(~fits).astype(np.int32)


def ivf_topk(
    q_emb: torch.Tensor,       # (B, dim) f32
    emb: torch.Tensor,         # (N, dim) storage dtype
    centroids: torch.Tensor,   # (C, dim) f32
    buckets: torch.Tensor,     # (C, cap) int32, -1 padded
    overflow: torch.Tensor,    # (V,) int32, -1 padded (always scanned)
    mask: torch.Tensor,        # (B, N) bool
    *,
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores (B, k) f32, positions (B, k) int64); positions -1 where no
    hit."""
    vals, pos, _idx = ivf_shard_topk(q_emb, emb, centroids, buckets, overflow,
                                     mask, k=k, nprobe=nprobe, row0=0)
    return vals, pos


def ivf_shard_topk(
    q_emb: torch.Tensor, emb: torch.Tensor, centroids: torch.Tensor,
    buckets: torch.Tensor, overflow: torch.Tensor, mask: torch.Tensor,
    *, k: int, nprobe: int, row0: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ivf_topk`` over one shard: ``emb`` and ``mask`` hold the rows
    ``[row0, row0 + emb.shape[0])`` of the corpus. The probed candidates
    keep the whole corpus's layout, those outside the shard are masked, and
    the positions are the corpus's. -> (scores, positions, each answer's
    index in the candidate list: the sharded merge's tie order)"""
    q = q_emb.float()
    batch, dim = q.shape
    nprobe = min(nprobe, centroids.shape[0])
    _, probe = topk_lowest_index_first(q @ centroids.float().T, nprobe)
    n_cand = nprobe * buckets.shape[1] + overflow.shape[0]
    k_eff = min(k, n_cand)
    bytes_per_query = n_cand * dim * emb.element_size()
    group = max(1, min(batch, GATHER_BYTES // max(bytes_per_query, 1)))
    dev = emb.device
    rows = emb.shape[0]
    out_vals = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=dev)
    out_pos = torch.full((batch, k), -1, dtype=torch.int64, device=dev)
    out_idx = torch.full((batch, k), n_cand, dtype=torch.int64, device=dev)
    tail = overflow.to(dev, torch.int64)
    for b0 in range(0, batch, group):
        b1 = min(batch, b0 + group)
        cand = buckets[probe[b0:b1]].reshape(b1 - b0, -1).to(torch.int64)
        cand = torch.cat([cand, tail[None, :].expand(b1 - b0, -1)], dim=1)
        local = cand - row0
        valid = (cand >= 0) & (local >= 0) & (local < rows)
        safe = torch.where(valid, local, torch.zeros_like(local))
        scores = torch.bmm(emb[safe].float(), q[b0:b1, :, None])[:, :, 0]
        if emb.dtype == torch.int8:
            scores = scores * INT8_SCALE
        keep = valid & torch.gather(mask[b0:b1], 1, safe)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
        top_vals, top_i = topk_lowest_index_first(scores, k_eff)
        top_pos = torch.gather(safe, 1, top_i) + row0
        out_vals[b0:b1, :k_eff] = top_vals
        out_pos[b0:b1, :k_eff] = torch.where(
            torch.isfinite(top_vals), top_pos, torch.full_like(top_pos, -1))
        out_idx[b0:b1, :k_eff] = top_i
    return out_vals, out_pos, out_idx
