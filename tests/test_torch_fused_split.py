"""What K1's wrapper hands its CUDA kernel, on CPU: the three-piece bf16
split of the f32 lexical query, the kernel's order of each 32-wide K slab,
and the filter mask padded to whole 128-row groups.

The kernel multiplies each bf16 piece with the int8 signatures on the bf16
tensor cores (every product exact) and sums the three in one f32
accumulator, so these tests hold the split to the f32 lexical lane that
the plain version computes (``lexical_scores``).
"""

import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.ops import fused_scan as k1
from cadence_rag_tpu_torch.ops.lexical import lexical_scores
from cadence_rag_tpu_torch.ops.pack import _densify

# f32 sums of K terms are within K * 2^-24 of the sum of their magnitudes
# (the classic bound); the split leaves at most 2^-27 |q| per element and
# is held here to the 2^-24 |q| the kernel's tolerance budget assumes
F32_SUM_REL = 2.0 ** -24
SPLIT_REL = 2.0 ** -24


def _densified(rng, batch, lex_dim, feats):
    """Sparse idf weights stored as f16 and scatter-added into lex_dim
    buckets, as ``ops/pack._densify`` rebuilds the main path's queries;
    with ``feats`` near ``lex_dim`` many features share a bucket."""
    buckets = rng.integers(0, lex_dim, size=(batch, feats))
    values = rng.lognormal(0.0, 1.0, size=(batch, feats)).astype(np.float16)
    return _densify(torch.from_numpy(buckets),
                    torch.from_numpy(values.astype(np.float32)), lex_dim)


def _queries(kind, rng, batch, lex_dim):
    if kind == "densified":
        return _densified(rng, batch, lex_dim, 64)
    if kind == "collisions":
        return _densified(rng, batch, lex_dim, lex_dim)
    if kind == "normal":
        return torch.from_numpy(rng.standard_normal((batch, lex_dim)).astype(np.float32))
    # magnitudes over twelve decades, both signs
    mag = 10.0 ** rng.uniform(-6, 6, size=(batch, lex_dim))
    sign = rng.choice([-1.0, 1.0], size=(batch, lex_dim))
    return torch.from_numpy((sign * mag).astype(np.float32))


CASES = [("densified", 4096), ("collisions", 32), ("collisions", 128),
         ("normal", 64), ("wide", 96)]


@pytest.mark.parametrize("kind,lex_dim", CASES)
def test_split_rebuilds_the_query(kind, lex_dim):
    rng = np.random.default_rng(lex_dim)
    q = _queries(kind, rng, 16, lex_dim)
    pieces = k1.split_query(q)
    assert pieces.dtype == torch.bfloat16 and tuple(pieces.shape) == (3, 16, lex_dim)
    rebuilt = pieces.double().sum(0)
    err = (rebuilt - q.double()).abs()
    assert bool((err <= SPLIT_REL * q.double().abs()).all()), float(err.max())
    # each piece is the bf16 rounding of what the earlier ones left
    h, m, low = pieces.double()
    assert torch.equal(pieces[0], q.to(torch.bfloat16))
    assert bool((m.abs() <= h.abs() * 2.0 ** -8).all())
    assert bool((low.abs() <= m.abs() * 2.0 ** -8).all())


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
def test_piece_products_match_lexical_scores(kind, lex_dim, signature_range):
    """sum over the pieces of piece x int8, in f64, against the f32 lexical
    lane: within the f32 sum's own error bound plus the split's."""
    rng = np.random.default_rng(lex_dim + signature_range)
    q = _queries(kind, rng, 16, lex_dim)
    lex = torch.from_numpy(rng.integers(
        -signature_range, signature_range + 1, size=(300, lex_dim)).astype(np.int8))
    pieces = k1.split_query(q).double()
    x = lex.double()
    got = sum(p @ x.T for p in pieces)
    want = lexical_scores(q, lex).double()
    magnitude = q.double().abs() @ x.abs().T
    tol = (lex_dim * F32_SUM_REL + SPLIT_REL) * magnitude
    assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() - tol).max())


def test_kernel_order_gives_each_thread_its_fragment():
    """Thread c of a warp reads elements [8c, 8c + 8) of a staged row; for
    K step s its A fragment holds logical columns 2c, 2c+1 (registers 0, 1)
    and 2c+8, 2c+9 (registers 2, 3) of the step. The ordered queries must
    carry exactly those elements at those columns."""
    q = torch.arange(64, dtype=torch.float32)[None, :]
    ordered = k1.kernel_order(q)[0]
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
    qo, xo = k1.kernel_order(q), k1.kernel_order(x)
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
