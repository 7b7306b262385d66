"""Kernel K2's plain version and ``cosine_topk`` against the Pallas kernel
they replace (``cadence_rag_tpu/ops/pallas_topk.py``, run in interpret
mode as tests/kernels/test_pallas_topk.py runs it), on CPU.

Tolerances: on grid inputs (bf16-exact values whose sums are exact in f32)
values, candidate rows and tie winners are identical; on random f32 inputs
values agree within 1e-5 (f32 sums in another order) and ids are identical.
The CUDA kernel runs only on a card; tests/test_torch_kernels_cuda.py and
chip_smoke.py hold it against this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cadence_rag_tpu.ops.pallas_topk import pallas_candidates, pallas_cosine_topk
from cadence_rag_tpu.ops.topk import reference_topk_numpy
from cadence_rag_tpu_torch.ops import dense_scan as k2
from cadence_rag_tpu_torch.ops.topk import dense_scores


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _grid_inputs(rng, n, dim, b):
    """Coarse-grid values: ties are frequent, and every product and partial
    sum is exact in f32, so any summation order gives the same scores."""
    rows = rng.integers(-4, 5, size=(n, dim)).astype(np.float32) / 4.0
    q = rng.integers(-4, 5, size=(b, dim)).astype(np.float32) / 4.0
    mask = rng.random((b, n)) < 0.7
    return q, rows, mask


def _pallas(q, rows, mask, block_n, dtype=jnp.bfloat16):
    with pltpu.force_tpu_interpret_mode():
        vals, idx = pallas_candidates(
            jnp.asarray(q), jnp.asarray(rows, dtype=dtype), jnp.asarray(mask),
            block_n=block_n)
    return np.asarray(vals), np.asarray(idx)


@pytest.mark.parametrize("block_n", [256, 512, 1024])
def test_plain_matches_pallas_interpret_grid(block_n):
    rng = np.random.default_rng(block_n)
    n, dim, b = 4096, 64, 4
    q, rows, mask = _grid_inputs(rng, n, dim, b)
    # some queries and groups fully masked: -inf with the group's first row
    mask[1] = False
    mask[2, : 3 * block_n // 2] = False
    j_vals, j_idx = _pallas(q, rows, mask, block_n)
    t_vals, t_idx = k2.dense_scan_plain(
        _t(q), _t(rows).to(torch.bfloat16), _t(mask), block_n=block_n)
    assert t_vals.shape == (b, k2.n_candidates(n, block_n)) == j_vals.shape
    np.testing.assert_array_equal(t_vals.numpy(), j_vals)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    # ties are present, and the lowest offset won them in both
    plane = (q @ rows.T)[0]
    width = block_n // 128
    groups = plane.reshape(-1, width)
    assert ((groups == groups.max(axis=1, keepdims=True)).sum(axis=1) > 1).any()

    ref_vals, ref_idx = pallas_cosine_topk(
        jnp.asarray(q), jnp.asarray(rows, dtype=jnp.bfloat16),
        jnp.asarray(mask), 20, block_n=block_n, interpret=True)
    got_vals, got_idx = k2.cosine_topk(
        _t(q), _t(rows).to(torch.bfloat16), _t(mask), 20, block_n=block_n)
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(ref_vals))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("block_n", [256, 512, 1024])
def test_plain_matches_pallas_interpret_random_bf16(block_n):
    rng = np.random.default_rng(10 + block_n)
    n, dim, b = 2048, 64, 3
    rows = _unit_rows(rng, n, dim)
    q = rows[rng.integers(0, n, size=b)] + 0.05 * rng.standard_normal((b, dim))
    q = q.astype(np.float32)
    mask = rng.random((b, n)) < 0.5
    j_vals, j_idx = _pallas(q, rows, mask, block_n)
    t_vals, t_idx = k2.dense_scan_plain(
        _t(q), _t(rows).to(torch.bfloat16), _t(mask), block_n=block_n)
    np.testing.assert_allclose(t_vals.numpy(), j_vals, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)


def _pair(q, docs, mask, k, block_n):
    """(port, Pallas interpret) cosine top-k on f32 rows, as
    tests/kernels/test_pallas_topk.py feeds them."""
    ref = pallas_cosine_topk(jnp.asarray(q), jnp.asarray(docs), jnp.asarray(mask),
                             k, block_n=block_n, interpret=True)
    got = k2.cosine_topk(_t(q), _t(docs), _t(mask), k, block_n=block_n)
    ref = tuple(np.asarray(x) for x in ref)
    got = (got[0].numpy(), got[1].numpy())
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    return got


def test_self_match_top1():
    rng = np.random.default_rng(0)
    docs = _unit_rows(rng, 2048, 128)
    qs = docs[[3, 700]]
    vals, idx = _pair(qs, docs, np.ones((2, 2048), dtype=bool), 5, 512)
    assert int(idx[0, 0]) == 3 and int(idx[1, 0]) == 700
    assert float(vals[0, 0]) == pytest.approx(1.0, abs=1e-5)


def test_recall_vs_exact():
    rng = np.random.default_rng(1)
    n, k = 4096, 10
    docs = _unit_rows(rng, n, 64)
    qs = _unit_rows(rng, 4, 64)
    mask = np.ones((4, n), dtype=bool)
    _, ref_idx = reference_topk_numpy(qs, docs, mask, k)
    _, got_idx = _pair(qs, docs, mask, k, 512)
    recalls = [len(set(map(int, got_idx[b])) & set(map(int, ref_idx[b]))) / k
               for b in range(4)]
    assert np.mean(recalls) >= 0.8, recalls


def test_mask_respected():
    rng = np.random.default_rng(2)
    docs = _unit_rows(rng, 1024, 32)
    mask = np.ones((1, 1024), dtype=bool)
    mask[0, 5] = False  # exclude the self-match
    _, idx = _pair(docs[[5]], docs, mask, 3, 256)
    assert 5 not in set(map(int, idx[0]))


def test_candidate_index_mapping():
    """Winner indices are global row positions."""
    rng = np.random.default_rng(3)
    docs = _unit_rows(rng, 1024, 32)
    qs = _unit_rows(rng, 2, 32)
    vals, idx = _pair(qs, docs, np.ones((2, 1024), dtype=bool), 8, 256)
    scores = qs @ docs.T
    for b in range(2):
        for v, i in zip(vals[b], idx[b]):
            assert scores[b, int(i)] == pytest.approx(float(v), abs=1e-5)


def _definition(plane, n, block_n):
    """Candidates straight from the definition: candidate c = block c//128,
    group c%128 = rows block*block_n + g*width + off that exist; the first
    maximum wins; only groups holding a row are emitted."""
    width = block_n // 128
    b = plane.shape[0]
    nc = k2.n_candidates(n, block_n)
    vals = np.full((b, nc), -np.inf, dtype=np.float32)
    rows = np.zeros((b, nc), dtype=np.int64)
    for c in range(nc):
        blk, g = divmod(c, 128)
        members = [blk * block_n + g * width + off for off in range(width)]
        members = [r for r in members if r < n]
        assert members
        for bi in range(b):
            best = int(np.argmax(plane[bi, members]))
            vals[bi, c] = plane[bi, members[best]]
            rows[bi, c] = members[best]
    return vals, rows


@pytest.mark.parametrize("n,block_n", [
    (1, 256), (100, 256), (1000, 256), (2348, 1024), (5000, 2048), (1234, 384),
])
def test_ragged_rule_against_definition(n, block_n):
    rng = np.random.default_rng(n)
    q, rows, mask = _grid_inputs(rng, n, 32, 3)
    width = block_n // 128
    r = n % block_n
    assert k2.n_candidates(n, block_n) == (n // block_n) * 128 + -(-r // width)
    bf = _t(rows).to(torch.bfloat16)
    plane = dense_scores(_t(q), bf).numpy()
    plane = np.where(mask, plane, -np.inf).astype(np.float32)
    want_v, want_r = _definition(plane, n, block_n)
    got_v, got_i = k2.dense_scan_plain(_t(q), bf, _t(mask), block_n=block_n)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_r)
    # the full blocks match the Pallas kernel on the block-aligned prefix
    full = (n // block_n) * block_n
    if full:
        j_vals, j_idx = _pallas(q, rows[:full], mask[:, :full], block_n)
        np.testing.assert_array_equal(got_v.numpy()[:, : j_vals.shape[1]], j_vals)
        np.testing.assert_array_equal(got_i.numpy()[:, : j_idx.shape[1]], j_idx)


def test_topk_narrower_than_k_is_not_padded():
    """k above the candidate count returns min(k, n_candidates) columns,
    as pallas_cosine_topk does."""
    rng = np.random.default_rng(4)
    q, rows, mask = _grid_inputs(rng, 512, 32, 2)
    ref = pallas_cosine_topk(jnp.asarray(q), jnp.asarray(rows, dtype=jnp.bfloat16),
                             jnp.asarray(mask), 300, block_n=512, interpret=True)
    got = k2.cosine_topk(_t(q), _t(rows).to(torch.bfloat16), _t(mask), 300,
                         block_n=512)
    assert got[0].shape == (2, 128) == np.asarray(ref[0]).shape
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def test_default_block_n_is_the_codes():
    """The reference docstring says block_n=2048; its code defaults to 1024
    (8-row groups). Both packages' defaults give the same candidates."""
    rng = np.random.default_rng(5)
    q, rows, mask = _grid_inputs(rng, 4096, 32, 2)
    assert k2.DEFAULT_BLOCK_N == 1024 and k2.n_candidates(4096) == 512
    ref = pallas_cosine_topk(jnp.asarray(q), jnp.asarray(rows, dtype=jnp.bfloat16),
                             jnp.asarray(mask), 600, interpret=True)
    got = k2.cosine_topk(_t(q), _t(rows).to(torch.bfloat16), _t(mask), 600)
    assert got[0].shape == (2, 512) == np.asarray(ref[0]).shape
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_int8_rows_raise_type_error():
    """The TPU kernel casts the query to int8 storage, zeroing a unit query;
    the port refuses int8 rows instead."""
    rows = torch.zeros((1024, 32), dtype=torch.int8)
    q = torch.ones((2, 32)) / 32 ** 0.5
    mask = torch.ones((2, 1024), dtype=torch.bool)
    for fn in (k2.dense_scan_plain, k2.dense_scan):
        with pytest.raises(TypeError, match="int8"):
            fn(q, rows, mask)
    with pytest.raises(TypeError, match="int8"):
        k2.cosine_topk(q, rows, mask, 5)


@pytest.mark.parametrize("block_n", [128, 300, 4096])
def test_block_n_outside_the_kernel_range_raises(block_n):
    with pytest.raises(ValueError, match="block_n"):
        k2.n_candidates(4096, block_n)
