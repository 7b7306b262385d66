"""Kernel K3: the tech lane's top-k (``csrc/tech_keys.cu``).

Replaces ``cadence_rag_tpu/ops/pallas_tech.py`` (``tech_keys``,
``tech_topk_pallas``). Where the TPU kernel writes a (B, N) f32 recency
plane and leaves the order to ``approx_max_k``, the lane here is exact and
tie-safe: its answer is the top-k of the int64 keys of ``ops/topk.
order_keys`` over that plane — ``(recency desc, row asc)``, the reference's
``call_started_at DESC, id ASC`` — values and rows in the same order, the
-inf entries (and their rows) included when a query matches fewer than k
rows. ``tech_keys_plain`` builds that key plane and is the definition.

On a CUDA tensor ``tech_topk_keys`` launches the kernel, which never writes
the plane: for each range of ``RANGE_ROWS`` rows it writes that range's k
largest keys, and one ``torch.topk`` over those (B, ranges * k) candidates
gives the lane, exactly (the keys are unique, and the global top-k lies in
the union of the ranges' top-ks). On a CPU tensor it runs the plain
version. ``range_topk`` is the kernel's wrapper; ``range_topk.launches``
counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from .techlane import tech_key_plane
from .topk import order_keys, topk_from_keys

RANGE_ROWS = 1024        # rows per CTA: one top-k per range
MAX_K = 64               # the engine asks for 50 (engine/retrieve.py TECH_TOPK)
SLOTS = (8, 16, 32)      # slot counts the kernel is built for
MAX_QUERY_WIDTH = 256    # slots * capacity
INT64_MIN = -(2**63)     # padding: below every key


def tech_keys_plain(
    q_tokens: torch.Tensor,     # (B, S*C) int32
    doc_tokens: torch.Tensor,   # (N, S) int32
    started_sec: torch.Tensor,  # (N,) int32
    mask: torch.Tensor,         # (B, N) bool
) -> torch.Tensor:
    """-> (B, N) int64 order keys of the plain f32 recency plane."""
    return order_keys(tech_key_plane(doc_tokens, started_sec, q_tokens, mask))


def tech_topk_plain(
    doc_tokens: torch.Tensor,
    started_sec: torch.Tensor,
    q_tokens: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain lane: top-k of the whole key plane."""
    return topk_from_keys(tech_keys_plain(q_tokens, doc_tokens, started_sec, mask), k)


def n_candidates(n: int, k: int) -> int:
    """Candidates per query: k per range of ``RANGE_ROWS`` rows."""
    return -(-n // RANGE_ROWS) * k


def range_topk_plain(
    q_tokens: torch.Tensor,
    doc_tokens: torch.Tensor,
    started_sec: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """What the kernel writes: (B, ranges * k) int64, each range's k
    largest order keys (in no promised order within the range), a range of
    fewer than k rows padded with INT64_MIN."""
    keys = tech_keys_plain(q_tokens, doc_tokens, started_sec, mask)
    batch, n = keys.shape
    ranges = -(-n // RANGE_ROWS)
    padded = torch.full((batch, ranges * RANGE_ROWS), INT64_MIN,
                        dtype=torch.int64, device=keys.device)
    padded[:, :n] = keys
    top, _ = torch.topk(padded.view(batch, ranges, RANGE_ROWS), k, dim=-1)
    return top.reshape(batch, ranges * k)


def _check_cuda_inputs(q_tokens, doc_tokens, started_sec, mask, k) -> None:
    n, slots = doc_tokens.shape
    batch, q_width = q_tokens.shape
    for name, t in (("q_tokens", q_tokens), ("doc_tokens", doc_tokens),
                    ("started_sec", started_sec), ("mask", mask)):
        if t.device != doc_tokens.device or not t.is_contiguous():
            raise ValueError(f"tech_topk: {name} must be contiguous on {doc_tokens.device}")
    if (doc_tokens.dtype != torch.int32 or started_sec.dtype != torch.int32
            or mask.dtype != torch.bool):
        raise TypeError("tech_topk: doc_tokens/started_sec int32, mask bool")
    if tuple(mask.shape) != (batch, n) or tuple(started_sec.shape) != (n,):
        raise ValueError("tech_topk: mask must be (B, N), started_sec (N,)")
    if slots not in SLOTS or q_width % slots or q_width > MAX_QUERY_WIDTH:
        raise ValueError(f"tech_topk: slots {slots} (takes {SLOTS}); query width "
                         f"{q_width} a multiple of slots, at most {MAX_QUERY_WIDTH}")
    if doc_tokens.data_ptr() % 16 or n >= 2**31:
        raise ValueError("tech_topk: doc_tokens 16-byte aligned, rows < 2^31")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"tech_topk: k {k} must lie in [1, min({MAX_K}, rows {n})]")


def range_topk(
    q_tokens: torch.Tensor,
    doc_tokens: torch.Tensor,
    started_sec: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """Kernel K3 -> (B, ranges * k) int64 candidates (``range_topk_plain``
    on CPU tensors)."""
    if doc_tokens.device.type == "cpu":
        return range_topk_plain(q_tokens, doc_tokens, started_sec, mask, k)
    if doc_tokens.device.type != "cuda":
        raise ValueError(f"tech_topk: unsupported device {doc_tokens.device}")
    q_tokens = q_tokens.to(torch.int32).contiguous()
    if q_tokens.shape[1] == 0:
        # no structure columns: nothing matches, as in the plain compare
        q_tokens = torch.zeros((q_tokens.shape[0], doc_tokens.shape[1]),
                               dtype=torch.int32, device=q_tokens.device)
    _check_cuda_inputs(q_tokens, doc_tokens, started_sec, mask, k)
    n, slots = doc_tokens.shape
    batch, q_width = q_tokens.shape
    nc = n_candidates(n, k)
    cand = torch.empty((batch, nc), dtype=torch.int64, device=doc_tokens.device)
    if batch:
        err = build.load().ck_tech_topk(
            q_tokens.data_ptr(), q_width, doc_tokens.data_ptr(), slots,
            started_sec.data_ptr(), mask.data_ptr(), n, batch, k,
            cand.data_ptr(), nc, build.stream_handle(doc_tokens.device),
        )
        build.check(err, "tech_topk")
        range_topk.launches += 1
        build.count_launch("tech_topk")
    return cand


range_topk.launches = 0


def tech_topk_keys(
    doc_tokens: torch.Tensor,
    started_sec: torch.Tensor,
    q_tokens: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tech lane -> (f32 recency values (B, k), rows int64 (B, k));
    -inf = no match. On CUDA: the kernel's per-range top-ks (k <=
    ``MAX_K``), then one ``torch.topk``; on CPU: ``tech_topk_plain``."""
    if doc_tokens.device.type == "cpu":
        return tech_topk_plain(doc_tokens, started_sec, q_tokens, mask, k)
    return topk_from_keys(range_topk(q_tokens, doc_tokens, started_sec, mask, k), k)
