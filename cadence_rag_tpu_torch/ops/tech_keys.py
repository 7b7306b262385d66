"""Kernel K3: the tech lane's order keys (``csrc/tech_keys.cu``).

Replaces ``cadence_rag_tpu/ops/pallas_tech.py`` (``tech_keys``,
``tech_topk_pallas``). Where the TPU kernel writes a (B, N) f32 recency
plane and leaves the order to ``approx_max_k``, this kernel writes the
int64 keys of ``ops/topk.order_keys`` for that plane directly —
``(recency desc, row asc)``, the reference's ``call_started_at DESC, id
ASC`` — so ``torch.topk`` over them is exact and tie-safe in one step.

``tech_keys`` launches the kernel for CUDA tensors and runs
``tech_keys_plain`` only for CPU tensors. ``tech_keys.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from .techlane import tech_key_plane
from .topk import order_keys, topk_from_keys

MAX_SLOTS = 32


def tech_keys_plain(
    q_tokens: torch.Tensor,     # (B, S*C) int32
    doc_tokens: torch.Tensor,   # (N, S) int32
    started_sec: torch.Tensor,  # (N,) int32
    mask: torch.Tensor,         # (B, N) bool
) -> torch.Tensor:
    """-> (B, N) int64 order keys of the plain f32 recency plane."""
    return order_keys(tech_key_plane(doc_tokens, started_sec, q_tokens, mask))


def tech_keys(
    q_tokens: torch.Tensor,
    doc_tokens: torch.Tensor,
    started_sec: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """-> (B, N) int64 order keys (kernel on CUDA, plain on CPU)."""
    if doc_tokens.device.type == "cpu":
        return tech_keys_plain(q_tokens, doc_tokens, started_sec, mask)
    if doc_tokens.device.type != "cuda":
        raise ValueError(f"tech_keys: unsupported device {doc_tokens.device}")
    n, slots = doc_tokens.shape
    batch, q_width = q_tokens.shape
    q_tokens = q_tokens.to(torch.int32).contiguous()
    for name, t in (("q_tokens", q_tokens), ("doc_tokens", doc_tokens),
                    ("started_sec", started_sec), ("mask", mask)):
        if t.device != doc_tokens.device or not t.is_contiguous():
            raise ValueError(f"tech_keys: {name} must be contiguous on {doc_tokens.device}")
    if (doc_tokens.dtype != torch.int32 or started_sec.dtype != torch.int32
            or mask.dtype != torch.bool):
        raise TypeError("tech_keys: doc_tokens/started_sec int32, mask bool")
    if tuple(mask.shape) != (batch, n) or tuple(started_sec.shape) != (n,):
        raise ValueError("tech_keys: mask must be (B, N), started_sec (N,)")
    if slots > MAX_SLOTS or q_width % slots or n >= 2**31:
        raise ValueError(f"tech_keys: slots {slots} (max {MAX_SLOTS}), "
                         f"query width {q_width} must be a multiple of slots")
    lib = build.load()
    keys = torch.empty((batch, n), dtype=torch.int64, device=doc_tokens.device)
    err = lib.ck_tech_keys(
        q_tokens.data_ptr(), q_width, doc_tokens.data_ptr(), slots,
        started_sec.data_ptr(), mask.data_ptr(), n, batch, keys.data_ptr(),
        build.stream_handle(doc_tokens.device),
    )
    build.check(err, "tech_keys")
    tech_keys.launches += 1
    return keys


tech_keys.launches = 0


def tech_topk_keys(
    doc_tokens: torch.Tensor,
    started_sec: torch.Tensor,
    q_tokens: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tech lane: -> (f32 recency keys, positions); -inf = no match."""
    return topk_from_keys(tech_keys(q_tokens, doc_tokens, started_sec, mask), k)
