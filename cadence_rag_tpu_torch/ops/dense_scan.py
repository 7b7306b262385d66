"""Kernel K2: the dense cosine scan (``csrc/dense_scan.cu``).

Replaces ``cadence_rag_tpu/ops/pallas_topk.py`` (``pallas_candidates``,
``pallas_cosine_topk``). One pass over the corpus scores the dense lane
alone and keeps one winner per group of ``width = block_n // 128``
CONTIGUOUS rows — group g of block b is the rows ``b*block_n + g*width +
off`` — with the lowest offset winning a tie and an all-masked group
carrying -inf and its first row, as ``jnp.argmax`` does. An exact top-k over
the (B, ~N/width) candidates follows, as ``lax.top_k`` follows the
``pallas_call``. K1 (``ops/fused_scan.py``) partitions its blocks into
strided groups instead; the two are different candidate sets.

What the port defines where the reference does not:

- a ragged last block of r rows has ``ceil(r / width)`` groups (the TPU
  kernel asserts ``n % block_n == 0``, so the JAX gate's ``pallas`` mode
  fails at its own default n = 100,000);
- the default ``block_n`` is 1024 (the code's default; the reference's
  docstring says 2048), so a group is 8 contiguous rows;
- the query is cast to the rows' dtype and widened, as the TPU kernel does,
  but int8 rows raise ``TypeError``: the cast would zero a unit query.

``dense_scan`` launches the kernel for CUDA tensors (bf16 rows) and runs
``dense_scan_plain`` only for CPU tensors; the plain version also takes f32
rows. ``dense_scan.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from .topk import NEG_INF, ROW_CHUNK, dense_scores, topk_lowest_index_first

LANE = 128
DEFAULT_BLOCK_N = 1024
MIN_BLOCK_N = 256
MAX_BLOCK_N = 2048


def _width(block_n: int) -> int:
    if block_n % LANE or not MIN_BLOCK_N <= block_n <= MAX_BLOCK_N:
        raise ValueError(
            f"dense_scan: block_n {block_n} must be a multiple of {LANE} in "
            f"[{MIN_BLOCK_N}, {MAX_BLOCK_N}]")
    return block_n // LANE


def n_candidates(n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """Candidates per query: 128 per full block, ceil(r / width) for a
    ragged last block of r rows (groups with no row are not emitted)."""
    width = _width(block_n)
    return (n // block_n) * LANE + -(-(n % block_n) // width)


def _check_rows(rows: torch.Tensor, allowed: Tuple[torch.dtype, ...]) -> None:
    if rows.dtype == torch.int8:
        raise TypeError(
            "dense_scan: int8 rows — the TPU kernel casts the query to the "
            "storage dtype, which zeroes a unit query; use the serving "
            "lanes (K1 or the exact scan) for int8 indexes")
    if rows.dtype not in allowed:
        raise TypeError(f"dense_scan: rows dtype {rows.dtype} "
                        f"(takes {', '.join(map(str, allowed))})")


def group_reduce(
    scores: torch.Tensor, row0: int, block_n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n) masked scores of rows row0.. -> per-group (values f32, rows
    int32): a strict '>' fold over the offsets in order, so the lowest
    offset wins a tie and an all -inf group keeps its first row."""
    width = _width(block_n)
    batch, n = scores.shape
    n_blocks = -(-n // block_n)
    pad = n_blocks * block_n - n
    if pad:
        scores = torch.cat([scores, torch.full(
            (batch, pad), NEG_INF, dtype=scores.dtype, device=scores.device
        )], dim=1)
    groups = scores.view(batch, n_blocks * LANE, width)
    best = groups[:, :, 0].clone()
    best_off = torch.zeros(best.shape, dtype=torch.int64, device=scores.device)
    for off in range(1, width):
        cell = groups[:, :, off]
        better = cell > best
        best = torch.where(better, cell, best)
        best_off = torch.where(better, torch.full_like(best_off, off), best_off)
    first = row0 + torch.arange(
        n_blocks * LANE, dtype=torch.int64, device=scores.device) * width
    nc = n_candidates(n, block_n)
    return (best[:, :nc],
            (first[None, :nc] + best_off[:, :nc]).to(torch.int32))


def dense_scan_plain(
    q_emb: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
    *, block_n: int = DEFAULT_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: slabs of rows (aligned to the blocks), full masked
    score planes, ``group_reduce``. bf16 rows score through
    ``ops/topk.dense_scores`` (query rounded to bf16, f32 sums); f32 rows
    score the f32 query, as the TPU kernel's cast to f32 leaves it."""
    _check_rows(rows, (torch.bfloat16, torch.float32))
    _width(block_n)
    n = rows.shape[0]
    slab = block_n * max(1, ROW_CHUNK // block_n)
    vals, idx = [], []
    for r0 in range(0, n, slab):
        r1 = min(n, r0 + slab)
        if rows.dtype == torch.bfloat16:
            s = dense_scores(q_emb, rows[r0:r1])
        else:
            s = q_emb.float() @ rows[r0:r1].T
        s = torch.where(mask[:, r0:r1], s, torch.full_like(s, NEG_INF))
        v, i = group_reduce(s, r0, block_n)
        vals.append(v)
        idx.append(i)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def _check_cuda_inputs(q_emb, rows, mask) -> None:
    n, dim = rows.shape
    batch = q_emb.shape[0]
    for name, t in {"q_emb": q_emb, "rows": rows, "mask": mask}.items():
        if t.device != rows.device:
            raise ValueError(f"dense_scan: {name} is on {t.device}, rows on {rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"dense_scan: {name} must be contiguous")
    _check_rows(rows, (torch.bfloat16,))
    if mask.dtype != torch.bool or tuple(mask.shape) != (batch, n):
        raise ValueError(f"dense_scan: mask {mask.dtype} {tuple(mask.shape)} "
                         f"must be bool ({batch}, {n})")
    if tuple(q_emb.shape) != (batch, dim) or dim % 32 or rows.data_ptr() % 16:
        raise ValueError(f"dense_scan: q_emb {tuple(q_emb.shape)}, rows "
                         f"{tuple(rows.shape)}: dim a multiple of 32, rows "
                         "16-byte aligned")
    if n >= 2**31:
        raise ValueError("dense_scan: row positions are int32")


def dense_scan(
    q_emb: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
    *, block_n: int = DEFAULT_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (values f32, rows int32), each (B, n_candidates(N, block_n))."""
    if rows.device.type == "cpu":
        return dense_scan_plain(q_emb, rows, mask, block_n=block_n)
    if rows.device.type != "cuda":
        raise ValueError(f"dense_scan: unsupported device {rows.device}")
    _width(block_n)
    q_emb = q_emb.to(torch.bfloat16).float().contiguous()
    _check_cuda_inputs(q_emb, rows, mask)
    lib = build.load()
    n, dim = rows.shape
    batch = q_emb.shape[0]
    nc = n_candidates(n, block_n)
    vals = torch.empty((batch, nc), dtype=torch.float32, device=rows.device)
    idx = torch.empty((batch, nc), dtype=torch.int32, device=rows.device)
    err = lib.ck_dense_scan(
        q_emb.data_ptr(), rows.data_ptr(), mask.data_ptr(), n, batch, dim,
        block_n, vals.data_ptr(), idx.data_ptr(), nc,
        build.stream_handle(rows.device),
    )
    build.check(err, "dense_scan")
    dense_scan.launches += 1
    return vals, idx


dense_scan.launches = 0


def candidate_topk(
    vals: torch.Tensor, rows: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over candidates (lowest candidate first among ties) ->
    (values f32, row positions int64), each (B, min(k, n_candidates)):
    narrower than k when there are fewer candidates, as
    ``pallas_cosine_topk`` returns, never padded."""
    top_vals, top_pos = topk_lowest_index_first(vals, min(k, vals.shape[1]))
    return top_vals, torch.gather(rows.to(torch.int64), 1, top_pos)


def cosine_topk(
    q_emb: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor, k: int,
    *, block_n: int = DEFAULT_BLOCK_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan and ``candidate_topk`` over its candidates."""
    return candidate_topk(*dense_scan(q_emb, rows, mask, block_n=block_n), k)
