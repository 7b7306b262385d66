"""Kernel K1: the fused dense + lexical scan (``csrc/fused_scan.cu``).

Replaces ``cadence_rag_tpu/ops/pallas_fused.py`` (``fused_candidates``,
``pallas_fused_topk``). One pass over the corpus scores both lanes and keeps
one winner per group — group g of 1024-row block b is the 8 rows
``b*1024 + w*128 + g`` — so the (B, N) score planes never reach device
memory; an exact top-k over the (B, ~N/8) candidates follows, outside the
kernel, as ``lax.top_k`` follows the ``pallas_call``. These candidates are
also the port's only approximate ("ann") top-k.

The lanes are held to the serving lanes, not to the Pallas kernel's
shortcuts: the dense lane requires ``has_emb``, int8 rows take the 1/127
scale, the query is rounded to bf16 (never cast to int8), and the lexical
query stays f32 against int8 values.

``fused_scan`` launches the kernel for CUDA tensors and runs
``fused_scan_plain`` — the definition of the candidates, ragged last block
included — only for CPU tensors. ``fused_scan.launches`` counts kernel
launches. Before the launch the wrapper rounds the dense query to bf16,
splits the f32 lexical query into three bf16 pieces (``split_query``), the
operands of the kernel's bf16 tensor-core products, and stores both in the
kernel's K order (``kernel_order``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..kernels import build
from .lexical import lexical_mask_scores, lexical_scores
from .topk import NEG_INF, dense_scores, topk_lowest_index_first

BLOCK_ROWS = 1024
GROUPS = 128
SUB_TILES = BLOCK_ROWS // GROUPS
# rows per slab in the plain version (a multiple of BLOCK_ROWS, so slabs
# align with the candidate blocks); bounds the widened f32 copy of the
# lexical slab at 65536 x 4096 x 4 B = 1 GB
PLAIN_ROW_CHUNK = 65536

Candidates = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                   torch.Tensor, torch.Tensor]


def n_candidates(n: int) -> int:
    """Candidates per query: 128 per full block, min(r, 128) for a ragged
    last block of r rows (groups with no row are not emitted)."""
    return (n // BLOCK_ROWS) * GROUPS + min(n % BLOCK_ROWS, GROUPS)


def group_reduce(
    scores: torch.Tensor, row0: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n) masked scores -> per-group (values f32, rows int32), earliest
    w winning ties, exactly as the kernel (and the Pallas kernel) does."""
    batch, n = scores.shape
    n_blocks = -(-n // BLOCK_ROWS)
    pad = n_blocks * BLOCK_ROWS - n
    if pad:
        scores = torch.cat([scores, torch.full(
            (batch, pad), NEG_INF, dtype=scores.dtype, device=scores.device
        )], dim=1)
    tiles = scores.view(batch, n_blocks, SUB_TILES, GROUPS)
    best = tiles[:, :, 0].clone()
    best_w = torch.zeros(best.shape, dtype=torch.int64, device=scores.device)
    for w in range(1, SUB_TILES):
        tile = tiles[:, :, w]
        better = tile > best
        best = torch.where(better, tile, best)
        best_w = torch.where(better, torch.full_like(best_w, w), best_w)
    base = row0 + torch.arange(
        n_blocks, dtype=torch.int64, device=scores.device
    )[:, None] * BLOCK_ROWS + torch.arange(
        GROUPS, dtype=torch.int64, device=scores.device
    )[None, :]
    rows = base[None] + best_w * GROUPS
    nc = n_candidates(n)
    return (best.reshape(batch, -1)[:, :nc],
            rows.reshape(batch, -1)[:, :nc].to(torch.int32))


def fused_scan_plain(
    q_emb: Optional[torch.Tensor], q_lex: torch.Tensor,
    emb: torch.Tensor, lex: torch.Tensor,
    mask: torch.Tensor, has_emb: torch.Tensor, *, dense: bool,
) -> Candidates:
    """Plain PyTorch K1: slabs of rows, full score planes, group_reduce."""
    n = lex.shape[0]
    d_parts, l_parts = [], []
    for r0 in range(0, n, PLAIN_ROW_CHUNK):
        r1 = min(n, r0 + PLAIN_ROW_CHUNK)
        m = mask[:, r0:r1]
        if dense:
            s = dense_scores(q_emb, emb[r0:r1])
            keep = m & has_emb[None, r0:r1]
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
            d_parts.append(group_reduce(s, r0))
        lx = lexical_mask_scores(lexical_scores(q_lex, lex[r0:r1]), m)
        l_parts.append(group_reduce(lx, r0))
    l_vals = torch.cat([p[0] for p in l_parts], dim=1)
    l_idx = torch.cat([p[1] for p in l_parts], dim=1)
    if not dense:
        return None, None, l_vals, l_idx
    return (torch.cat([p[0] for p in d_parts], dim=1),
            torch.cat([p[1] for p in d_parts], dim=1), l_vals, l_idx)


def split_query(q: torch.Tensor) -> torch.Tensor:
    """(B, K) f32 -> (3, B, K) bf16 pieces h, m, l with h = bf16(q),
    m = bf16(q - h), l = bf16(q - h - m). Both differences are exact in f32,
    so h + m + l rebuilds q within ~2^-27 |q|, and each piece times an int8
    value is exact in the kernel's f32 accumulation."""
    q = q.float()
    h = q.to(torch.bfloat16)
    r = q - h.float()
    m = r.to(torch.bfloat16)
    low = (r - m.float()).to(torch.bfloat16)
    return torch.stack([h, m, low]).contiguous()


# Each 32-wide K slab of the kernel's queries holds, at logical column
# 16s + 2c + b + 8h, element 8c + 4s + 2h + b of the slab: the wgmma A
# fragment of a thread with c = lane % 4 then covers elements [8c, 8c + 8)
# of a staged row, both 16-wide K steps in one load (csrc/fused_scan.cu).
_SLAB = 32
_SLAB_ORDER = [8 * ((col % 8) // 2) + 4 * s + 2 * (col // 8) + col % 2
               for s in range(2) for col in range(16)]


@functools.lru_cache(maxsize=None)
def _slab_order(device: torch.device) -> torch.Tensor:
    # made once per device: a copy from host memory on every call would
    # wait for the stream's earlier work
    return torch.tensor(_SLAB_ORDER, device=device)


def kernel_order(q: torch.Tensor) -> torch.Tensor:
    """(..., K) -> the same values with each 32-wide K slab in the kernel's
    order; K must be a multiple of 32."""
    k = q.shape[-1]
    slabs = q.reshape(*q.shape[:-1], k // _SLAB, _SLAB)
    return slabs.index_select(-1, _slab_order(q.device)).reshape(q.shape).contiguous()


def _kernel_mask(mask: torch.Tensor) -> torch.Tensor:
    """The kernel reads the mask by TMA as (128 groups, row/128, query)
    tiles: a row pitch that is not a multiple of 128 (a ragged corpus) gets
    a zero-padded copy."""
    batch, n = mask.shape
    if n % GROUPS == 0 and mask.data_ptr() % 16 == 0:
        return mask
    padded = torch.zeros((batch, -(-n // GROUPS) * GROUPS), dtype=torch.bool,
                         device=mask.device)
    padded[:, :n] = mask
    return padded


def _check_cuda_inputs(q_emb, q_lex, emb, lex, mask, has_emb, dense) -> None:
    n, lex_dim = lex.shape
    batch = q_lex.shape[0]
    tensors = {"q_lex": q_lex, "lex": lex, "mask": mask, "has_emb": has_emb}
    if dense:
        tensors.update(q_emb=q_emb, emb=emb)
    for name, t in tensors.items():
        if t.device != lex.device:
            raise ValueError(f"fused_scan: {name} is on {t.device}, lex on {lex.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_scan: {name} must be contiguous")
    if lex.dtype != torch.int8 or mask.dtype != torch.bool or has_emb.dtype != torch.bool:
        raise TypeError("fused_scan: lex int8, mask and has_emb bool")
    if tuple(mask.shape) != (batch, n) or tuple(has_emb.shape) != (n,):
        raise ValueError(f"fused_scan: mask {tuple(mask.shape)} / has_emb "
                         f"{tuple(has_emb.shape)} do not fit batch {batch}, rows {n}")
    if lex_dim % 32 or lex.data_ptr() % 16:
        raise ValueError("fused_scan: lex_dim must be a multiple of 32, rows 16-byte aligned")
    if n >= 2**31:
        raise ValueError("fused_scan: row positions are int32")
    if dense:
        if emb.dtype not in (torch.bfloat16, torch.int8):
            raise TypeError(f"fused_scan: emb dtype {emb.dtype} (bf16 or int8)")
        if emb.shape[0] != n or emb.shape[1] % 32 or emb.data_ptr() % 16:
            raise ValueError("fused_scan: emb rows must match lex; dim a multiple of 32")
        if tuple(q_emb.shape) != (batch, emb.shape[1]):
            raise ValueError(f"fused_scan: q_emb {tuple(q_emb.shape)}")


def fused_scan(
    q_emb: Optional[torch.Tensor], q_lex: torch.Tensor,
    emb: torch.Tensor, lex: torch.Tensor,
    mask: torch.Tensor, has_emb: torch.Tensor, *, dense: bool,
) -> Candidates:
    """-> (d_vals, d_idx, l_vals, l_idx), each (B, n_candidates(N)); the
    dense pair is None when ``dense`` is False."""
    if lex.device.type == "cpu":
        return fused_scan_plain(q_emb, q_lex, emb, lex, mask, has_emb,
                                dense=dense)
    if lex.device.type != "cuda":
        raise ValueError(f"fused_scan: unsupported device {lex.device}")
    q_lex = q_lex.float().contiguous()
    if dense:
        q_emb = q_emb.to(torch.bfloat16).contiguous()
    _check_cuda_inputs(q_emb, q_lex, emb, lex, mask, has_emb, dense)
    lib = build.load()
    n, lex_dim = lex.shape
    batch = q_lex.shape[0]
    pieces = kernel_order(split_query(q_lex))
    if dense:
        q_emb = kernel_order(q_emb)
    kmask = _kernel_mask(mask)
    nc = n_candidates(n)
    dev = lex.device
    l_vals = torch.empty((batch, nc), dtype=torch.float32, device=dev)
    l_idx = torch.empty((batch, nc), dtype=torch.int32, device=dev)
    d_vals = d_idx = None
    if dense:
        d_vals = torch.empty_like(l_vals)
        d_idx = torch.empty_like(l_idx)
    err = lib.ck_fused_scan(
        q_emb.data_ptr() if dense else None, pieces.data_ptr(),
        emb.data_ptr() if dense else None,
        int(dense and emb.dtype == torch.int8), lex.data_ptr(),
        kmask.data_ptr(), kmask.shape[1], has_emb.data_ptr(),
        n, batch, int(emb.shape[1]) if dense else 32, lex_dim, int(dense),
        d_vals.data_ptr() if dense else None,
        d_idx.data_ptr() if dense else None,
        l_vals.data_ptr(), l_idx.data_ptr(), nc,
        build.stream_handle(dev),
    )
    build.check(err, "fused_scan")
    fused_scan.launches += 1
    build.count_launch("fused_scan")
    return d_vals, d_idx, l_vals, l_idx


fused_scan.launches = 0


def candidate_topk(
    vals: torch.Tensor, rows: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over candidates (lowest candidate first among ties) ->
    (values, row positions int64), padded with -inf to width k when there
    are fewer than k candidates."""
    kk = min(k, vals.shape[1])
    top_vals, top_pos = topk_lowest_index_first(vals, kk)
    pos = torch.gather(rows.to(torch.int64), 1, top_pos)
    if kk < k:
        batch = vals.shape[0]
        top_vals = torch.cat([top_vals, torch.full(
            (batch, k - kk), NEG_INF, dtype=top_vals.dtype, device=vals.device
        )], dim=1)
        pos = torch.cat([pos, torch.zeros(
            (batch, k - kk), dtype=pos.dtype, device=vals.device
        )], dim=1)
    return top_vals, pos


def fused_topk(
    q_emb: Optional[torch.Tensor], q_lex: torch.Tensor,
    emb: torch.Tensor, lex: torch.Tensor,
    mask: torch.Tensor, has_emb: torch.Tensor,
    *, k_dense: int, k_lex: int, dense: bool,
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """One scan -> {"lex": (vals, pos)} plus "dense" when ``dense``."""
    d_vals, d_idx, l_vals, l_idx = fused_scan(
        q_emb, q_lex, emb, lex, mask, has_emb, dense=dense
    )
    out = {"lex": candidate_topk(l_vals, l_idx, k_lex)}
    if dense:
        out["dense"] = candidate_topk(d_vals, d_idx, k_dense)
    return out
