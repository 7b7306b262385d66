"""What K1's CUDA kernels do to the queries, on CPU: the three-piece split
of the f32 lexical query in bf16 or fp16, the route between them, the slabs
where the residual pieces are issued, the kernel's order of each 32-wide K
slab (``kernel_order``, the definition ``tests/test_torch_kernels_cuda.py``
holds the card's split kernel to), and the filter mask padded to whole
128-row groups.

The kernel multiplies each piece with the int8 signatures on the tensor
cores (every product exact) and sums them in one f32 accumulator, so these
tests hold the split to the f32 lexical lane that the plain version
computes (``lexical_scores``).
"""

import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.ops import fused_scan as k1
from cadence_rag_tpu_torch.ops.lexical import lexical_scores
from cadence_rag_tpu_torch.ops.pack import _densify

# f32 sums of K terms are within K * 2^-24 of the sum of their magnitudes
# (the classic bound); the bf16 split leaves at most 2^-27 |q| per element
# and either split is held here to the 2^-24 |q| the kernel's tolerance
# budget assumes (k1.SPLIT_REL)
F32_SUM_REL = 2.0 ** -24
SPLIT_REL = k1.SPLIT_REL
# the kinds of query that take the fp16 route: sums of f16 weights
SERVED = ("served", "densified", "collisions")


def launch_tile(batch):
    """The queries one K1 CTA covers, as the launcher chooses them
    (``query_tile`` in csrc/fused_scan.cu; the card test holds
    ``k1.query_tile`` to this)."""
    return 64 if batch <= 64 else 128 if batch <= 128 else 256


# Each 32-wide K slab of the kernel's queries holds, at logical column
# 16s + 2c + b + 8h, element 8c + 4s + 2h + b of the slab: the wgmma A
# fragment of a thread with c = lane % 4 then covers elements [8c, 8c + 8)
# of a staged row, both 16-wide K steps in one load (``slab_source`` in
# csrc/fused_scan.cu).
SLAB_ORDER = [8 * ((col % 8) // 2) + 4 * s + 2 * (col // 8) + col % 2
              for s in range(2) for col in range(16)]


def kernel_order(q):
    """(..., K) -> the same values with each 32-wide K slab in the kernel's
    order; K must be a multiple of 32."""
    k = q.shape[-1]
    slabs = q.reshape(*q.shape[:-1], k // 32, 32)
    order = torch.tensor(SLAB_ORDER, device=q.device)
    return slabs.index_select(-1, order).reshape(q.shape).contiguous()


def _densified(rng, batch, lex_dim, feats, shared=True, low=None):
    """Sparse idf weights stored as f16 and scatter-added into lex_dim
    buckets, as ``ops/pack._densify`` rebuilds the main path's queries;
    with ``feats`` near ``lex_dim`` many features share a bucket, and with
    ``shared`` False none do. ``low``: weights uniform in [low, 2 low)."""
    if shared:
        buckets = rng.integers(0, lex_dim, size=(batch, feats))
    else:
        buckets = np.argsort(rng.random((batch, lex_dim)), axis=1)[:, :feats]
    if low is None:
        values = rng.lognormal(0.0, 1.0, size=(batch, feats))
    else:
        values = rng.uniform(low, 2 * low, size=(batch, feats))
    values = values.astype(np.float16)
    return _densify(torch.from_numpy(buckets),
                    torch.from_numpy(values.astype(np.float32)), lex_dim)


def _queries(kind, rng, batch, lex_dim):
    if kind == "served":
        return _densified(rng, batch, lex_dim, 64, shared=False)
    if kind == "densified":
        return _densified(rng, batch, lex_dim, 64)
    if kind == "collisions":
        return _densified(rng, batch, lex_dim, lex_dim)
    if kind == "overflow":
        # f16 weights whose shared buckets sum past fp16's largest value
        return _densified(rng, batch, lex_dim, lex_dim, low=20000.0)
    if kind == "normal":
        return torch.from_numpy(rng.standard_normal((batch, lex_dim)).astype(np.float32))
    # magnitudes over twelve decades, both signs
    mag = 10.0 ** rng.uniform(-6, 6, size=(batch, lex_dim))
    sign = rng.choice([-1.0, 1.0], size=(batch, lex_dim))
    return torch.from_numpy((sign * mag).astype(np.float32))


CASES = [("densified", 4096), ("collisions", 32), ("collisions", 128),
         ("normal", 64), ("wide", 96), ("served", 4096), ("overflow", 64)]
DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("kind,lex_dim", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_rebuilds_the_query(kind, lex_dim, dtype):
    """bf16 pieces rebuild every kind of query (short of bf16's range);
    fp16 pieces rebuild the served kinds, and exactly where no bucket is
    shared, and fall short of the others, which take bf16 (K1's route)."""
    rng = np.random.default_rng(lex_dim)
    q = _queries(kind, rng, 16, lex_dim)
    pieces = k1.split_query(q, dtype)
    assert pieces.dtype == dtype and tuple(pieces.shape) == (3, 16, lex_dim)
    rebuilt = pieces.double().sum(0)
    err = (rebuilt - q.double()).abs()
    within = bool((err <= SPLIT_REL * q.double().abs()).all())
    if dtype == torch.float16 and kind not in SERVED:
        assert not within and not bool(k1.fp16_route(q))
        return
    assert within, float(err.max())
    if dtype == torch.float16:
        assert bool(k1.fp16_route(q))
    if kind == "served":
        assert torch.equal(rebuilt, q.double())
        assert (dtype == torch.bfloat16) or not bool(pieces[1:].any())
    # each piece is the rounding of what the earlier ones left
    h, m, low = pieces.double()
    bits = 2.0 ** -(8 if dtype == torch.bfloat16 else 11)
    assert torch.equal(pieces[0], q.to(dtype))
    assert bool((m.abs() <= h.abs() * bits).all())
    assert bool((low.abs() <= m.abs() * bits).all())


def test_f16_weights_need_two_pieces_and_collisions_a_third():
    """A lone f16 weight (11 bits) is h + m exactly; a bucket that sums two
    weights of far-apart magnitudes needs the third piece, and the three
    still rebuild it."""
    rng = np.random.default_rng(0)
    lone = torch.from_numpy(
        rng.lognormal(0.0, 1.0, size=(8, 64)).astype(np.float16).astype(np.float32))
    pieces = k1.split_query(lone)
    assert torch.equal(pieces[:2].double().sum(0), lone.double())
    assert not bool(pieces[2].any())
    weights = torch.tensor([[1001.0, 0.0013, 3.0]], dtype=torch.float16).float()
    summed = _densify(torch.tensor([[5, 5, 7]]), weights, 32)
    pieces = k1.split_query(summed)
    assert bool(pieces[2, 0, 5] != 0)
    assert float((pieces.double().sum(0) - summed.double()).abs().max()) <= (
        SPLIT_REL * float(summed.abs().max()))


@pytest.mark.parametrize("kind,lex_dim", CASES)
@pytest.mark.parametrize("signature_range", [4, 127])
@pytest.mark.parametrize("route", [False, True])
def test_piece_products_match_lexical_scores(kind, lex_dim, signature_range, route):
    """sum over the pieces of piece x int8, in f64, against the f32 lexical
    lane: within the f32 sum's own error bound plus the split's; for the
    bf16 pieces, and (``route``) for the pieces K1's route takes."""
    rng = np.random.default_rng(lex_dim + signature_range)
    q = _queries(kind, rng, 16, lex_dim)
    lex = torch.from_numpy(rng.integers(
        -signature_range, signature_range + 1, size=(300, lex_dim)).astype(np.int8))
    dtype = torch.bfloat16
    if route and bool(k1.fp16_route(q)):
        dtype = torch.float16
    assert (dtype == torch.float16) == (route and kind in SERVED)
    pieces = k1.split_query(q, dtype).double()
    x = lex.double()
    got = sum(p @ x.T for p in pieces)
    want = lexical_scores(q, lex).double()
    magnitude = q.double().abs() @ x.abs().T
    tol = (lex_dim * F32_SUM_REL + SPLIT_REL) * magnitude
    assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() - tol).max())


def test_f16_weights_are_one_fp16_piece_and_shared_buckets_need_more():
    """In fp16 a lone f16 weight is h alone; a bucket that sums two weights
    of far-apart magnitudes needs m, and the three rebuild it exactly."""
    rng = np.random.default_rng(0)
    lone = torch.from_numpy(
        rng.lognormal(0.0, 1.0, size=(8, 64)).astype(np.float16).astype(np.float32))
    pieces = k1.split_query(lone, torch.float16)
    assert torch.equal(pieces[0].float(), lone) and not bool(pieces[1:].any())
    weights = torch.tensor([[1001.0, 0.0013, 3.0]], dtype=torch.float16).float()
    summed = _densify(torch.tensor([[5, 5, 7]]), weights, 32)
    pieces = k1.split_query(summed, torch.float16)
    assert bool(pieces[1, 0, 5] != 0) and not bool(pieces[1:, 0, 7].any())
    assert torch.equal(pieces.double().sum(0), summed.double())
    assert bool(k1.fp16_route(summed))


@pytest.mark.parametrize("kind,lex_dim", CASES)
def test_route_is_fp16_for_the_served_kinds_only(kind, lex_dim):
    """The fp16 route for sums of f16 weights; bf16 for f32 queries off
    fp16's grid (``normal``, ``wide``) and for sums past its range."""
    rng = np.random.default_rng(lex_dim + 1)
    q = _queries(kind, rng, 16, lex_dim)
    route, pieces = k1.issued_pieces(q, launch_tile(16))
    assert route == ("fp16" if kind in SERVED else "bf16")
    assert bool(k1.fp16_route(q)) == (kind in SERVED)
    assert 1.0 <= pieces <= 3.0
    if kind == "served":
        assert pieces == 1.0
    bad = q.clone()
    bad[3, 5] = float("nan")
    assert not bool(k1.fp16_route(bad)) and k1.issued_pieces(bad, 64)[0] == "bf16"


@pytest.mark.parametrize("batch", [1, 64, 65, 117, 128, 129, 256, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_masks_mark_the_slabs_with_residual_pieces(batch, dtype):
    """A (tile, slab) cell is set for m (l) exactly where some query of the
    tile has m (l) nonzero in the slab; the pieces K1 issues a slab are 1
    plus the cells set, over the cells."""
    rng = np.random.default_rng(batch)
    q = _densified(rng, batch, 4096, 45)
    pieces = k1.split_query(q, dtype)
    tile = launch_tile(batch)
    masks = k1.slab_masks(pieces, tile)
    tiles = -(-batch // tile)
    assert tuple(masks.shape) == (2, tiles, 4096 // 32)
    for p in (1, 2):
        for t in range(tiles):
            for slab in range(4096 // 32):
                cell = pieces[p, t * tile:(t + 1) * tile, 32 * slab:32 * (slab + 1)]
                assert bool(masks[p - 1, t, slab]) == bool((cell != 0).any())
    # the route's pieces: an f16 weight is one fp16 piece, and only shared
    # buckets need residuals, where most weights need bf16's m
    fp16_cells = k1.slab_masks(k1.split_query(q, torch.float16), tile)
    bf16_cells = k1.slab_masks(k1.split_query(q, torch.bfloat16), tile)
    assert int(fp16_cells[0].sum()) < int(bf16_cells[0].sum())
    route, issued = k1.issued_pieces(q, tile)
    assert route == "fp16"
    assert issued == pytest.approx(
        1.0 + float(fp16_cells.float().sum()) / (tiles * 4096 // 32))


def test_kernel_order_gives_each_thread_its_fragment():
    """Thread c of a warp reads elements [8c, 8c + 8) of a staged row; for
    K step s its A fragment holds logical columns 2c, 2c+1 (registers 0, 1)
    and 2c+8, 2c+9 (registers 2, 3) of the step. The ordered queries must
    carry exactly those elements at those columns."""
    q = torch.arange(64, dtype=torch.float32)[None, :]
    ordered = kernel_order(q)[0]
    for slab in range(2):
        col0 = 32 * slab
        for c in range(4):
            for s in range(2):
                cols = [col0 + 16 * s + x for x in (2 * c, 2 * c + 1, 2 * c + 8, 2 * c + 9)]
                want = [col0 + 8 * c + 4 * s + i for i in range(4)]
                assert ordered[cols].tolist() == want


@pytest.mark.parametrize("lex_dim", [32, 4096])
def test_kernel_order_is_a_permutation_within_slabs(lex_dim):
    rng = np.random.default_rng(lex_dim)
    q = torch.from_numpy(rng.standard_normal((3, 5, lex_dim)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-127, 128, size=(7, lex_dim)).astype(np.float32))
    qo, xo = kernel_order(q), kernel_order(x)
    assert qo.is_contiguous() and qo.shape == q.shape
    slabs = qo.reshape(3, 5, lex_dim // 32, 32).sort(-1).values
    assert torch.equal(slabs, q.reshape(3, 5, lex_dim // 32, 32).sort(-1).values)
    # the same order on both sides leaves every dot product unchanged
    torch.testing.assert_close(qo.double() @ xo.double().T, q.double() @ x.double().T,
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n", [128, 1024, 300, 1025])
def test_kernel_mask_pads_to_whole_groups(n):
    rng = np.random.default_rng(n)
    mask = torch.from_numpy(rng.random((3, n)) < 0.5)
    got = k1._kernel_mask(mask)
    if n % k1.GROUPS == 0:
        assert got is mask
    else:
        assert tuple(got.shape) == (3, -(-n // k1.GROUPS) * k1.GROUPS)
        assert torch.equal(got[:, :n], mask) and not bool(got[:, n:].any())
