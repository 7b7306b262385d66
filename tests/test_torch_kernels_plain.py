"""The plain versions of kernels K1 and K3 against the Pallas kernels they
replace (run in interpret mode, as tests/kernels/test_pallas_fused.py runs
them) and against the XLA lanes, on CPU.

The CUDA kernels themselves run only on a card; chip_smoke.py holds each
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cadence_rag_tpu.config import settings
from cadence_rag_tpu.ingest import featurize
from cadence_rag_tpu.ops import lexical as jlexical
from cadence_rag_tpu.ops import topk as jtopk
from cadence_rag_tpu.ops.pallas_fused import fused_candidates, pallas_fused_topk
from cadence_rag_tpu.ops.pallas_tech import tech_topk_pallas
from cadence_rag_tpu_torch.ops import fused_scan as k1
from cadence_rag_tpu_torch.ops import tech_keys as k3

INT32_MIN = np.iinfo(np.int32).min


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _k1_inputs(rng, n, dim, d, b, grid=True):
    """bf16-representable values on a coarse grid: every product and every
    partial sum is exact in f32, so the Pallas kernel's bf16 casts and any
    accumulation order give bit-identical scores (ties included)."""
    emb = rng.integers(-64, 65, size=(n, dim)).astype(np.float32) / 64.0
    q_emb = rng.integers(-64, 65, size=(b, dim)).astype(np.float32) / 64.0
    lex = rng.integers(-4, 5, size=(n, d)).astype(np.int8)
    q_lex = rng.integers(-8, 9, size=(b, d)).astype(np.float32) / 16.0
    mask = rng.random((b, n)) < 0.8
    return q_emb, q_lex, emb, lex, mask


def test_k1_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    n, dim, d, b = 4096, 64, 256, 4
    q_emb, q_lex, emb, lex, mask = _k1_inputs(rng, n, dim, d, b)
    j_args = (jnp.asarray(q_emb), jnp.asarray(q_lex),
              jnp.asarray(emb, dtype=jnp.bfloat16), jnp.asarray(lex),
              jnp.asarray(mask))
    with pltpu.force_tpu_interpret_mode():
        jd_v, jd_i, jl_v, jl_i = (np.asarray(x) for x in fused_candidates(*j_args))
    td_v, td_i, tl_v, tl_i = k1.fused_scan_plain(
        _t(q_emb), _t(q_lex), _t(emb).to(torch.bfloat16), _t(lex), _t(mask),
        torch.ones(n, dtype=torch.bool), dense=True)
    assert td_v.shape == (b, k1.n_candidates(n)) == (b, n // 8)
    # exact arithmetic: candidates identical, including tie winners
    np.testing.assert_array_equal(td_v.numpy(), jd_v)
    np.testing.assert_array_equal(td_i.numpy(), jd_i)
    np.testing.assert_array_equal(tl_v.numpy(), jl_v)
    np.testing.assert_array_equal(tl_i.numpy(), jl_i)

    ref = pallas_fused_topk(*j_args, k_dense=50, k_lex=50, interpret=True)
    got = k1.fused_topk(
        _t(q_emb), _t(q_lex), _t(emb).to(torch.bfloat16), _t(lex), _t(mask),
        torch.ones(n, dtype=torch.bool), k_dense=50, k_lex=50, dense=True)
    for lane in ("dense", "lex"):
        np.testing.assert_array_equal(got[lane][1].numpy(),
                                      np.asarray(ref[lane][1]))
        np.testing.assert_array_equal(got[lane][0].numpy(),
                                      np.asarray(ref[lane][0]))


def _group_truth(scores, n):
    """Brute-force candidates from full (B, n) masked scores."""
    b = scores.shape[0]
    nc = k1.n_candidates(n)
    vals = np.full((b, nc), -np.inf, dtype=np.float32)
    rows = np.zeros((b, nc), dtype=np.int64)
    for c in range(nc):
        blk, g = divmod(c, 128)
        members = [blk * 1024 + w * 128 + g for w in range(8)]
        members = [r for r in members if r < n]
        for bi in range(b):
            best = int(np.argmax(scores[bi, members]))  # first max wins
            vals[bi, c] = scores[bi, members[best]]
            rows[bi, c] = members[best]
    return vals, rows


@pytest.mark.parametrize("n", [8, 100, 1024, 2348])
@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_k1_has_emb_int8_ragged_against_xla_lanes(n, emb_dtype):
    rng = np.random.default_rng(n)
    dim, d, b = 64, 128, 3
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q_emb = emb[rng.integers(0, n, size=b)] + 0.01
    lex = rng.integers(-4, 5, size=(n, d)).astype(np.int8)
    q_lex = (rng.standard_normal((b, d)) * 0.2).astype(np.float32)
    mask = rng.random((b, n)) < 0.8
    has_emb = rng.random(n) < 0.7
    if emb_dtype == "int8":
        stored = np.clip(np.rint(emb * 127.0), -127, 127).astype(np.int8)
        j_emb, t_emb = jnp.asarray(stored), _t(stored)
    else:
        j_emb = jnp.asarray(emb, dtype=jnp.bfloat16)
        t_emb = _t(emb).to(torch.bfloat16)
    # the XLA lanes' full masked planes
    dense = np.asarray(jtopk.dense_scores(jnp.asarray(q_emb), j_emb))
    dense = np.where(mask & has_emb[None, :], dense, -np.inf)
    lexs = np.asarray(jlexical.lexical_scores(jnp.asarray(q_lex),
                                              jnp.asarray(lex)))
    lexs = np.where(mask & (lexs > jlexical.LEX_MATCH_THRESHOLD), lexs, -np.inf)
    td_v, td_i, tl_v, tl_i = k1.fused_scan_plain(
        _t(q_emb), _t(q_lex), t_emb, _t(lex), _t(mask), _t(has_emb),
        dense=True)
    for (vals, rows), plane in (((td_v, td_i), dense), ((tl_v, tl_i), lexs)):
        want_v, want_r = _group_truth(plane, n)
        # f32 sums in another order than XLA's: a winner may differ only
        # where two rows of one group score within the tolerance
        np.testing.assert_allclose(vals.numpy(), want_v, rtol=1e-5, atol=1e-5)
        differ = rows.numpy() != want_r
        assert differ.mean() < 0.01
    # rows without embeddings never win a dense group
    won = td_i.numpy()[np.isfinite(td_v.numpy())]
    assert has_emb[won].all()
    # the final top-k recovers the exact lane's winners
    got = k1.fused_topk(_t(q_emb), _t(q_lex), t_emb, _t(lex), _t(mask),
                        _t(has_emb), k_dense=10, k_lex=10, dense=True)
    assert got["dense"][0].shape == (b, 10)
    _, ex_i = jtopk.masked_topk_exact(
        jnp.asarray(dense), jnp.asarray(np.isfinite(dense)), 1)
    np.testing.assert_array_equal(got["dense"][1][:, 0].numpy(),
                                  np.asarray(ex_i)[:, 0])


def test_k1_dense_off_skips_dense_half():
    rng = np.random.default_rng(9)
    q_emb, q_lex, emb, lex, mask = _k1_inputs(rng, 2048, 64, 128, 2)
    d_v, d_i, l_v, l_i = k1.fused_scan_plain(
        None, _t(q_lex), None, _t(lex), _t(mask),
        torch.ones(2048, dtype=torch.bool), dense=False)
    assert d_v is None and d_i is None
    full = k1.fused_scan_plain(
        _t(q_emb), _t(q_lex), _t(emb).to(torch.bfloat16), _t(lex), _t(mask),
        torch.ones(2048, dtype=torch.bool), dense=True)
    np.testing.assert_array_equal(l_v.numpy(), full[2].numpy())
    np.testing.assert_array_equal(l_i.numpy(), full[3].numpy())
    out = k1.fused_topk(None, _t(q_lex), None, _t(lex), _t(mask),
                        torch.ones(2048, dtype=torch.bool),
                        k_dense=5, k_lex=5, dense=False)
    assert set(out) == {"lex"}


def _tech_from_featurize(rng, n, b):
    slots = int(settings.tech_hash_slots)
    vocab = [f"svc-{i}" for i in range(40)] + [f"v2.{i}.1" for i in range(20)]
    tech = np.zeros((n, slots), dtype=np.int32)
    for r in range(n):
        toks = list(rng.choice(vocab, size=int(rng.integers(0, 5)), replace=False))
        tech[r] = featurize.tech_slots(toks)
    queries = [list(rng.choice(vocab, size=int(rng.integers(1, 4)), replace=False))
               for _ in range(b)]
    structures = featurize.query_tech_structures_batch(queries)
    width = max(s.shape[0] for s, _ in structures)
    q = np.zeros((b, width), dtype=np.int32)
    for i, (s, dropped) in enumerate(structures):
        assert dropped == 0
        q[i, : s.shape[0]] = s
    # every chunk of a call shares its start second
    started = np.repeat(rng.integers(1_600_000_000, 1_700_000_000, n // 16 + 1),
                        16)[:n].astype(np.int32)
    started[rng.random(n) < 0.05] = INT32_MIN
    mask = (rng.random((b, n)) < 0.9) & (started != INT32_MIN)[None, :]
    return tech, started, q, mask


@pytest.mark.parametrize("k", [16, 50])
def test_k3_plain_matches_pallas_interpret(k):
    """Slot-aligned (S*C) compare against the Pallas kernel's full S*Q
    compare, on structures from featurize.query_tech_structures_batch."""
    rng = np.random.default_rng(11)
    n, b = 2048, 4
    tech, started, q, mask = _tech_from_featurize(rng, n, b)
    ref_v, ref_i = tech_topk_pallas(
        *map(jnp.asarray, (tech, started, q, mask)), k, interpret=True)
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    assert (np.isfinite(ref_v).sum(axis=1) > 1).all()
    got_v, got_i = k3.tech_topk_keys(*map(_t, (tech, started, q, mask)), k)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    # the keys plane orders exactly like the f32 plane
    keys = k3.tech_keys_plain(*map(_t, (q, tech, started, mask)))
    assert keys.dtype == torch.int64 and keys.shape == (b, n)
