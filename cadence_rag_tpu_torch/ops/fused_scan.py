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
launches; ``route_counts`` reads the kernel's own count, on the card, of
its launches by route and the lexical pieces it issued. Both queries go to
the card in f32 as they are: a small kernel ahead of the scan rounds the
dense query to bf16 and splits the lexical query into three 16-bit pieces
(``split_query``), the operands of the tensor-core products, in fp16 where
they rebuild the query (``fp16_route``; the served query, sums of f16
weights) and else in bf16, each in the scan's K order; and it notes per
query tile (``query_tile``) and 32-wide K slab whether the residual pieces
are nonzero (``slab_masks``): the scan issues them only there
(``issued_pieces``). The route is decided on the card, so the launch never
waits for it. The tile and the scratch the launch needs are the C side's
(``ck_fused_scan_tile``, ``ck_fused_scan_work_bytes``).
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


# the bound on each element that three pieces must rebuild the query within
SPLIT_REL = 2.0 ** -24
# K1's lexical slab: the K width of one stage, over which it issues a piece
_SLAB = 32


def query_tile(batch: int) -> int:
    """The queries one K1 CTA covers for ``batch`` (64, 128 or 256), as the
    kernel's launcher chooses it (loads the CUDA library)."""
    return build.load().ck_fused_scan_tile(batch)


def split_query(q: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, K) f32 -> (3, B, K) pieces h, m, l of ``dtype`` (bf16 or fp16)
    with h = rn(q), m = rn(q - h), l = rn(q - h - m). Both differences are
    exact in f32, and each piece times an int8 value is exact in the
    kernel's f32 accumulation. In bf16 the pieces rebuild q within ~2^-27
    |q|; in fp16 they rebuild a sum of f16 values exactly, short of fp16's
    range, and other queries may fall short (``fp16_route``)."""
    q = q.float()
    h = q.to(dtype)
    r = q - h.float()
    m = r.to(dtype)
    low = (r - m.float()).to(dtype)
    return torch.stack([h, m, low]).contiguous()


def fp16_route(q: torch.Tensor) -> torch.Tensor:
    """Whether K1 multiplies the (B, K) f32 query as fp16 pieces: they
    rebuild every element within SPLIT_REL |q| and h is finite. A 0-d bool
    tensor on q's device (reading it waits for the device)."""
    q = q.float()
    h, m, low = split_query(q, torch.float16).float()
    short = ((q - h) - m) - low
    return torch.isfinite(h).all() & (short.abs() <= q.abs() * SPLIT_REL).all()


def slab_masks(pieces: torch.Tensor, tile: int) -> torch.Tensor:
    """(3, B, K) pieces -> (2, tiles, K / 32) bool: whether m, and whether
    l, is nonzero for some query of each query tile of ``tile`` queries
    (K1's: ``query_tile``) in each 32-wide K slab, the residual pieces K1
    issues there."""
    _, batch, k = pieces.shape
    tiles = -(-batch // tile)
    rest = pieces[1:] != 0
    if tiles * tile > batch:
        rest = torch.cat([rest, rest.new_zeros((2, tiles * tile - batch, k))], dim=1)
    return rest.view(2, tiles, tile, k // _SLAB, _SLAB).any(4).any(2)


def issued_pieces(q: torch.Tensor, tile: int) -> Tuple[str, float]:
    """K1's route and the lexical pieces it issues a K slab, the mean over
    its query tiles of ``tile`` queries, for the (B, K) f32 query: what the
    kernel counts on the card (``counters``; this reads the device)."""
    f16 = bool(fp16_route(q))
    masks = slab_masks(split_query(q, torch.float16 if f16 else torch.bfloat16), tile)
    return ("fp16" if f16 else "bf16"), 1.0 + 2.0 * float(masks.float().mean())


COUNTS = ("bf16", "fp16", "pieces", "slabs")


@functools.lru_cache(maxsize=None)
def _counters(device: torch.device) -> torch.Tensor:
    return torch.zeros(len(COUNTS), dtype=torch.int64, device=device)


def counters(device) -> torch.Tensor:
    """The kernel's own counts on one card since the process began, int64
    in the order of COUNTS: its launches on the bf16 and the fp16 route,
    and the lexical pieces it issued over the K slabs they cover (one count
    a query tile of each launch). Copy it in stream order to read it
    without waiting for the device; ``route_counts`` waits."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _counters(dev)


def route_counts(device) -> Dict[str, int]:
    """``counters`` read into a dict (waits for the device)."""
    return dict(zip(COUNTS, counters(device).tolist()))


def _scratch(lib, batch: int, dim: int, lex_dim: int, dense: bool,
             device: torch.device) -> torch.Tensor:
    """The launch's scratch (the queries' pieces and the slab bytes), of
    the size the C side asks for."""
    return torch.empty(lib.ck_fused_scan_work_bytes(batch, dim, lex_dim, int(dense)),
                       dtype=torch.uint8, device=device)


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
        q_emb = q_emb.float().contiguous()
    _check_cuda_inputs(q_emb, q_lex, emb, lex, mask, has_emb, dense)
    lib = build.load()
    n, lex_dim = lex.shape
    batch = q_lex.shape[0]
    dim = int(emb.shape[1]) if dense else 32
    kmask = _kernel_mask(mask)
    nc = n_candidates(n)
    dev = lex.device
    work = _scratch(lib, batch, dim, lex_dim, dense, dev)
    l_vals = torch.empty((batch, nc), dtype=torch.float32, device=dev)
    l_idx = torch.empty((batch, nc), dtype=torch.int32, device=dev)
    d_vals = d_idx = None
    if dense:
        d_vals = torch.empty_like(l_vals)
        d_idx = torch.empty_like(l_idx)
    err = lib.ck_fused_scan(
        q_emb.data_ptr() if dense else None, q_lex.data_ptr(),
        work.data_ptr(), work.numel(), counters(dev).data_ptr(),
        emb.data_ptr() if dense else None,
        int(dense and emb.dtype == torch.int8), lex.data_ptr(),
        kmask.data_ptr(), kmask.shape[1], has_emb.data_ptr(),
        n, batch, dim, lex_dim, int(dense),
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
