"""The port's device-program ops against the JAX package's, on CPU.

Inputs are made with numpy from a seed and fed to both packages. Where the
arithmetic is the same (masks, tie order, tech keys, packing) results must
be identical; f32 sums taken in another order are held to the tolerance
stated at each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_rag_tpu.ops import fusion as jfusion
from cadence_rag_tpu.ops import lexical as jlexical
from cadence_rag_tpu.ops import masks as jmasks
from cadence_rag_tpu.ops import pack as jpack
from cadence_rag_tpu.ops import techlane as jtechlane
from cadence_rag_tpu.ops import topk as jtopk
from cadence_rag_tpu.engine import planner as jplanner
from cadence_rag_tpu_torch.engine import planner as tplanner
from cadence_rag_tpu_torch.ops import fusion as tfusion
from cadence_rag_tpu_torch.ops import lexical as tlexical
from cadence_rag_tpu_torch.ops import masks as tmasks
from cadence_rag_tpu_torch.ops import pack as tpack
from cadence_rag_tpu_torch.ops import tech_keys as ttech_keys
from cadence_rag_tpu_torch.ops import topk as ttopk

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max

# f32 matmul results over <= 1024-term sums taken in a different order
SCORE_RTOL = 1e-5
SCORE_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_filter_mask_identical():
    rng = np.random.default_rng(0)
    n, b, c = 300, 5, 17
    call_idx = rng.integers(0, c, n).astype(np.int32)
    started = rng.integers(1_600_000_000, 1_700_000_000, n).astype(np.int32)
    started[rng.random(n) < 0.1] = INT32_MIN
    allowed = rng.random((b, c)) < 0.6
    dmin = np.array([INT32_MIN + 1, 1_650_000_000, 0, 1_690_000_000, 5],
                    dtype=np.int32)
    dmax = np.array([INT32_MAX, 1_680_000_000, -1, INT32_MAX, 4],
                    dtype=np.int32)
    ref = jmasks.filter_mask(*map(jnp.asarray, (call_idx, started, allowed,
                                                dmin, dmax)))
    got = tmasks.filter_mask(*map(_t, (call_idx, started, allowed, dmin, dmax)))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dense_scores(dtype):
    rng = np.random.default_rng(1)
    emb = _unit_rows(rng, 257, 96)
    q = _unit_rows(rng, 4, 96)
    if dtype == "int8":
        stored = np.clip(np.rint(emb * 127.0), -127, 127).astype(np.int8)
        j_emb, t_emb = jnp.asarray(stored), _t(stored)
    else:
        j_emb = jnp.asarray(emb, dtype=jnp.bfloat16)
        t_emb = _t(emb).to(torch.bfloat16)
    ref = np.asarray(jtopk.dense_scores(jnp.asarray(q), j_emb))
    got = _np(ttopk.dense_scores(_t(q), t_emb))
    assert got.dtype == np.float32 and got.shape == (4, 257)
    np.testing.assert_allclose(got, ref, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_exact_topk_duplicates_lowest_row_first():
    rng = np.random.default_rng(2)
    # heavy ties, signed zeros and -inf: the order must be lax.top_k's
    vals = rng.integers(-3, 4, size=(6, 200)).astype(np.float32)
    vals[:, ::7] = -np.inf
    vals[0, 10:20] = 0.0
    vals[0, 20:30] = -0.0
    mask = rng.random((6, 200)) < 0.8
    for k in (1, 17, 200):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(vals), k)
        got_v, got_i = ttopk.topk_lowest_index_first(_t(vals), k)
        np.testing.assert_array_equal(_np(got_i), np.asarray(ref_i))
        np.testing.assert_array_equal(
            _np(got_v).view(np.int32), np.asarray(ref_v).view(np.int32))
        ref_v, ref_i = jtopk.masked_topk_exact(jnp.asarray(vals),
                                               jnp.asarray(mask), k)
        got_v, got_i = ttopk.masked_topk_exact(_t(vals), _t(mask), k)
        np.testing.assert_array_equal(_np(got_i), np.asarray(ref_i))
        np.testing.assert_array_equal(_np(got_v), np.asarray(ref_v))


def test_order_keys_round_trip():
    vals = np.array([[3.5, -0.0, 0.0, -np.inf, 1e-30, -2.0, np.inf]],
                    dtype=np.float32)
    keys = ttopk.order_keys(_t(vals))
    back, idx = ttopk.topk_from_keys(keys, vals.shape[1])
    np.testing.assert_array_equal(_np(idx), [[6, 0, 4, 2, 1, 5, 3]])
    np.testing.assert_array_equal(
        _np(back).view(np.int32), vals[:, [6, 0, 4, 2, 1, 5, 3]].view(np.int32))


def _lex_inputs(rng, n=600, d=256, b=4):
    lex = rng.integers(-4, 5, size=(n, d)).astype(np.int8)
    lex[rng.random(n) < 0.3] = 0          # rows that match nothing
    q = np.zeros((b, d), dtype=np.float32)
    for row in range(b):
        cols = rng.choice(d, 20, replace=False)
        q[row, cols] = rng.standard_normal(20).astype(np.float32) * 0.3
    mask = rng.random((b, n)) < 0.7
    return q, lex, mask


def test_lexical_lane():
    rng = np.random.default_rng(3)
    q, lex, mask = _lex_inputs(rng)
    ref_v, ref_i = jlexical.lexical_topk(jnp.asarray(q), jnp.asarray(lex),
                                         jnp.asarray(mask), 50)
    got_v, got_i = tlexical.lexical_topk(_t(q), _t(lex), _t(mask), 50)
    ref_v, ref_i, got_v, got_i = map(_np, (ref_v, ref_i, got_v, got_i))
    finite = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(got_v), finite)
    np.testing.assert_array_equal(got_i[finite], ref_i[finite])
    np.testing.assert_allclose(got_v[finite], ref_v[finite],
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)
    scores = _np(tlexical.lexical_scores(_t(q), _t(lex)))
    np.testing.assert_allclose(
        scores, np.asarray(jlexical.lexical_scores(jnp.asarray(q),
                                                   jnp.asarray(lex))),
        rtol=SCORE_RTOL, atol=SCORE_ATOL)


def _tech_inputs(rng, n=700, slots=16, b=5, capacity=2):
    hashes = rng.integers(1, 40, size=60).astype(np.int32)  # shared vocab
    tech = np.zeros((n, slots), dtype=np.int32)
    for r in range(n):
        for h in rng.choice(hashes, size=rng.integers(0, 4), replace=False):
            s = int(h) % slots
            tech[r, s] = h
    # calls of ~25 rows share one start second: ties are the normal case
    started = np.repeat(
        rng.integers(1_600_000_000, 1_700_000_000, n // 25 + 1), 25
    )[:n].astype(np.int32)
    started[rng.random(n) < 0.05] = INT32_MIN
    q = np.zeros((b, slots * capacity), dtype=np.int32)
    for row in range(b):
        for i, h in enumerate(rng.choice(hashes, size=3, replace=False)):
            q[row, (i % capacity) * slots + int(h) % slots] = h
    mask = (rng.random((b, n)) < 0.8) & (started != INT32_MIN)[None, :]
    return tech, started, q, mask


@pytest.mark.parametrize("k", [10, 50])
def test_tech_lane_ties_identical(k):
    rng = np.random.default_rng(4)
    tech, started, q, mask = _tech_inputs(rng)
    ref_v, ref_i = jtechlane.tech_topk(*map(jnp.asarray, (tech, started, q, mask)), k)
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    assert np.isfinite(ref_v).sum() > k  # more matches than slots: ties matter
    got_v, got_i = ttech_keys.tech_topk_keys(*map(_t, (tech, started, q, mask)), k)
    np.testing.assert_array_equal(_np(got_i), ref_i)
    np.testing.assert_array_equal(_np(got_v), ref_v)


LANES = ("lex", "tech", "dense")
API = {"lex": "bm25", "tech": "tech_tokens", "dense": "dense"}


def _mk_lane(rng, batch, k, n_docs, lo, hi):
    vals = np.full((batch, k), -np.inf, dtype=np.float32)
    pos = np.zeros((batch, k), dtype=np.int32)
    for b in range(batch):
        m = int(rng.integers(lo, hi + 1))
        vals[b, :m] = np.sort(rng.standard_normal(m).astype(np.float32))[::-1]
        pos[b, :m] = rng.choice(n_docs, size=m, replace=False)
        pos[b, m:] = rng.integers(0, n_docs, size=k - m)
    return vals, pos


@pytest.mark.parametrize("lanes", [LANES, ("lex", "tech")])
def test_device_rrf_against_jax_and_host_oracle(lanes):
    rng = np.random.default_rng(5)
    batch = 6
    outs = {
        "lex": _mk_lane(rng, batch, 8, 20, 1, 8),
        "tech": _mk_lane(rng, batch, 5, 20, 0, 5),
        "dense": _mk_lane(rng, batch, 8, 20, 1, 8),
    }
    outs = {name: outs[name] for name in lanes}
    ref = [np.asarray(x) for x in jfusion.rrf_fuse_lanes_device(
        {n: (jnp.asarray(v), jnp.asarray(p)) for n, (v, p) in outs.items()},
        LANES)]
    got = [_np(x) for x in tfusion.rrf_fuse_lanes_device(
        {n: (_t(v), _t(p)) for n, (v, p) in outs.items()}, LANES)]
    np.testing.assert_array_equal(got[3], ref[3])
    for b in range(batch):
        m = int(ref[3][b])
        np.testing.assert_array_equal(got[0][b, :m], ref[0][b, :m])
        np.testing.assert_array_equal(got[2][b, :m], ref[2][b, :m])
        # f32 sums of <= 3 terms; the ids above already agree
        np.testing.assert_allclose(got[1][b, :m], ref[1][b, :m], atol=1e-6)
    rect = {}
    for name, (v, p) in outs.items():
        rect[API[name]] = (p.astype(np.int64), v,
                           np.isfinite(v).sum(axis=1).astype(np.int32))
    host = tfusion.rrf_merge_rect(rect)
    jhost = jfusion.rrf_merge_rect(rect)
    for b in range(batch):
        ids, scores, masks, names = host[b]
        jids, jscores, jmasks_, jnames = jhost[b]
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(scores, jscores)
        np.testing.assert_array_equal(masks, jmasks_)
        assert names == jnames
        m = int(got[3][b])
        assert m == ids.size
        np.testing.assert_array_equal(got[0][b, :m], ids)
        np.testing.assert_array_equal(got[2][b, :m], masks)
        # device sums in f32, the oracle in f64
        np.testing.assert_allclose(got[1][b, :m], scores, atol=1e-6)


def test_host_merge_family_matches_jax():
    rng = np.random.default_rng(6)
    plans = []
    for _ in range(4):
        plans.append({
            "bm25": rng.choice(30, size=int(rng.integers(0, 10)), replace=False),
            "tech_tokens": rng.choice(30, size=int(rng.integers(0, 6)), replace=False),
            "dense": rng.choice(30, size=int(rng.integers(0, 10)), replace=False),
        })
    for got, ref in zip(tfusion.rrf_merge_batch(plans),
                        jfusion.rrf_merge_batch(plans)):
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(g, r)
    for lanes in plans:
        got = tfusion.rrf_merge_arrays(lanes)
        ref = jfusion.rrf_merge_arrays(lanes)
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(g, r)


def _feats(rng, dim, sizes):
    out = []
    for m in sizes:
        buckets = rng.integers(0, dim, size=m).astype(np.int64)
        signs = np.where(rng.random(m) < 0.5, -1.0, 1.0).astype(np.float32)
        tfs = rng.integers(1, 4, size=m).astype(np.float32)
        out.append((buckets, signs, tfs))
    return out


@pytest.mark.parametrize("sizes", [(3, 0, 17, 5), (3, 300, 17, 0)])
def test_pack_queries_bytes_identical(sizes):
    rng = np.random.default_rng(7)
    dim, F, b = 1024, 256, len(sizes)
    feats = _feats(rng, dim, sizes)
    df = rng.integers(0, 50, size=dim).astype(np.int64)
    ref_sparse = jpack.sparse_lex_rows(feats, df, 400, F)
    got_sparse = tpack.sparse_lex_rows(feats, df, 400, F)
    for g, r in zip(got_sparse, ref_sparse):
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))
    q_emb = _unit_rows(rng, b, 32)
    q_tech = rng.integers(0, 1000, size=(b, 16)).astype(np.int32)
    allowed = rng.random((b, 37)) < 0.5
    dmin = rng.integers(-5, 5, b).astype(np.int32)
    dmax = rng.integers(5, 15, b).astype(np.int32)
    for emb in (q_emb, None):
        ref = jpack.pack_queries(emb, ref_sparse, ref_sparse, q_tech,
                                 allowed, dmin, dmax)
        got = tpack.pack_queries(emb, got_sparse, got_sparse, q_tech,
                                 allowed, dmin, dmax)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def test_densify_duplicate_buckets_scatter_add():
    buckets = np.array([[5, 5, 9, 0, 5], [1, 2, 1, 2, 0]], dtype=np.int32)
    values = np.array([[0.5, 0.25, -1.0, 0.0, 0.125],
                       [1.0, 2.0, 3.0, -4.0, 0.0]], dtype=np.float32)
    ref = np.asarray(jpack._densify(jnp.asarray(buckets), jnp.asarray(values), 16))
    got = _np(tpack._densify(_t(buckets).long(), _t(values), 16))
    np.testing.assert_array_equal(got, ref)
    assert got[0, 5] == 0.875 and got[1, 1] == 4.0 and got[1, 2] == -2.0


@pytest.mark.parametrize("dense", [True, False])
def test_unpack_unaligned_slices(dense):
    """With dense off the q_emb slot is B*2 bytes and the call bitmap B*C
    bytes, so later slices start at offsets no element size divides."""
    rng = np.random.default_rng(8)
    b, F, n_calls, dim = 3, 8, 37, (32 if dense else 1)
    feats = _feats(rng, 1024, (2, 5, 8))
    df = rng.integers(0, 50, size=1024).astype(np.int64)
    sparse = tpack.sparse_lex_rows(feats, df, 400, F)
    q_emb = _unit_rows(rng, b, 32) if dense else None
    q_tech = rng.integers(-5, 1000, size=(b, 16)).astype(np.int32)
    allowed = rng.random((b, n_calls)) < 0.5
    dmin = rng.integers(-5, 5, b).astype(np.int32)
    dmax = rng.integers(5, 15, b).astype(np.int32)
    packed = tpack.pack_queries(q_emb, sparse, sparse, q_tech, allowed,
                                dmin, dmax)
    statics = dict(batch=b, dim=dim, q_feats=F, tech_q=16, n_calls=n_calls)
    ref = jpack._unpack(jnp.asarray(packed), **statics)
    got = tpack._unpack(_t(packed), **statics)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(_np(got[name]), np.asarray(ref[name]),
                                      err_msg=name)


def test_planner_matches_jax():
    for rows in (0, 1, 1999, 2000, 2001, 10**6):
        for scoped in (False, True):
            assert tplanner.choose_dense_mode(rows, scoped) == \
                jplanner.choose_dense_mode(rows, scoped)
    for ef in (1, 20, 80, 81, 160, 320, 10**6):
        assert tplanner.recall_target_for_ef_search(ef) == \
            jplanner.recall_target_for_ef_search(ef)
