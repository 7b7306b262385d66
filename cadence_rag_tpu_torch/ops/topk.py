"""Dense cosine scores and the tie-safe exact top-k.

Counterpart of ``cadence_rag_tpu/ops/topk.py``. ``lax.top_k`` puts the
lowest index first among equal values, and the port relies on that order
(the tech lane's ``call_started_at DESC, id ASC``, the exact dense lane, the
candidate top-k after kernel K1). ``torch.topk`` promises no tie order, so
every top-k here ranks a unique int64 key instead of the value itself:

    key = sortable_i32(value) << 32 | (0xFFFFFFFF - index)

``sortable_i32`` maps float32 bits to an int32 with the same order as the
floats (IEEE total order: -0.0 < +0.0, as ``lax.top_k`` orders them), so
the largest key is the largest value and, among equal values, the lowest
index. Kernel K3 (``ops/tech_keys.py``) writes the same keys directly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = float("-inf")
LOW_MASK = 0xFFFFFFFF

# rows per f32 matmul slab in dense_scores: bounds the widened copy of a
# bf16/int8 slab (65536 x 1024 f32 = 256 MB) at 1M-row corpora
ROW_CHUNK = 65536
# 1/127 rounded to f32, as a Python float: multiplying an f32 tensor by it
# is one f32 multiply, with no host-to-device upload of a constant
INT8_SCALE = float(np.float32(1.0 / 127.0))


def sortable_i32(values: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with the floats' order (an involution on bits)."""
    bits = values.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def from_sortable_i32(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of ``sortable_i32``."""
    return (keys ^ ((keys >> 31) & 0x7FFFFFFF)).view(torch.float32)


def order_keys(values: torch.Tensor) -> torch.Tensor:
    """(..., N) float32 -> (..., N) int64 keys: value desc, index asc."""
    n = values.shape[-1]
    low = LOW_MASK - torch.arange(n, dtype=torch.int64, device=values.device)
    return (sortable_i32(values).to(torch.int64) << 32) | low


def topk_from_keys(keys: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``order_keys`` output -> (values f32, indices int64)."""
    top, _ = torch.topk(keys, k, dim=-1, largest=True, sorted=True)
    idx = LOW_MASK - (top & LOW_MASK)
    vals = from_sortable_i32((top >> 32).to(torch.int32))
    return vals, idx


def topk_lowest_index_first(
    values: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis with ``lax.top_k``'s tie order."""
    return topk_from_keys(order_keys(values.float()), k)


def dense_scores(q_emb: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(B, dim) x (N, dim) -> (B, N) f32 cosine scores.

    As ``topk.dense_scores``: the query is rounded to bf16 (the storage
    dtype, or the widened type for int8 storage); int8 rows are widened and
    the 1/127 scale restores cosine units. Products of bf16 values are
    exact in f32, so the f32 matmul over widened slabs accumulates exactly
    what the JAX lane's ``preferred_element_type=f32`` product does."""
    q = q_emb.to(torch.bfloat16).float()
    n = emb.shape[0]
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=emb.device)
    for r0 in range(0, n, ROW_CHUNK):
        r1 = min(n, r0 + ROW_CHUNK)
        torch.matmul(q, emb[r0:r1].float().T, out=out[:, r0:r1])
    if emb.dtype == torch.int8:
        out.mul_(INT8_SCALE)
    return out


def masked_topk_exact(
    scores: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (B, N) scores under a (B, N) validity mask."""
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return topk_lowest_index_first(masked, k)
