"""The port's meshes and sharded lanes (``parallel/``) against the JAX
package's, on the CPU: the counterpart of tests/kernels/test_parallel.py.

The JAX side runs on conftest's 8 virtual CPU devices; the port's mesh is
the CPU eight times (``make_mesh("data:8", ["cpu"] * 8)``). Both get the
same seeded numpy inputs, bf16 rows (the port stores bf16 or int8), and
the merged lanes must agree: positions identical, in order, and scores
within 1e-5 (f32 sums of the same products taken in another order). Then
the merge's own rules: ties go to the lowest global row, the filters and
``has_emb`` hold across shards, and a mesh that does not fit raises.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_rag_tpu.ops.hashing import tech_query_structure_from_hashes
from cadence_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cadence_rag_tpu.parallel.sharded import (
    sharded_dense_topk as jax_dense_topk,
    sharded_multi_lane as jax_multi_lane,
)
from cadence_rag_tpu_torch.parallel import (
    make_mesh, parse_mesh_shape, sharded_dense_topk, sharded_multi_lane,
)
from cadence_rag_tpu_torch.parallel.sharded import _merge_gathered

SCORE_ATOL = 1e-5
CPU8 = ["cpu"] * 8


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bf16(x):
    """The same bf16 values for both packages: -> (jax array, torch tensor)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _assert_lane(port, jax_out, lane=""):
    p_scores, p_pos = (np.asarray(t) for t in port)
    j_scores, j_pos = (np.asarray(x) for x in jax_out)
    finite = np.isfinite(j_scores)
    np.testing.assert_array_equal(np.isfinite(p_scores), finite, err_msg=lane)
    np.testing.assert_array_equal(np.where(finite, p_pos, -1),
                                  np.where(finite, j_pos, -1), err_msg=lane)
    np.testing.assert_allclose(p_scores[finite], j_scores[finite].astype(np.float32),
                               rtol=0, atol=SCORE_ATOL, err_msg=lane)


class TestMesh:
    def test_parse(self):
        assert parse_mesh_shape("data:4,model:2") == [("data", 4), ("model", 2)]

    def test_make_mesh_all_devices(self):
        mesh = make_mesh(device="cpu")
        assert mesh.size == 1 and mesh.shape == {"data": 1}
        assert make_mesh("data:4", device="cpu").devices == (torch.device("cpu"),) * 4
        assert make_mesh(devices=CPU8).shape == {"data": 8}
        assert make_mesh(devices=CPU8).local_positions() == list(range(8))

    def test_bad_shape_raises(self):
        with pytest.raises(ValueError, match=r"needs 3 devices, have 8"):
            make_mesh("data:3", CPU8)

    def test_no_card_has_no_devices(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible")
        with pytest.raises(ValueError, match=r"needs 2 devices, have 0"):
            make_mesh("data:2")

    def test_a_gang_mesh_spans_every_process(self, monkeypatch):
        from cadence_rag_tpu_torch.parallel import mesh as mesh_mod

        gang = mesh_mod.Gang(backend="gloo", rank=1, world=2,
                             device=torch.device("cpu"))
        monkeypatch.setattr(mesh_mod, "_gang", gang)
        mesh = make_mesh("data:4", device="cpu")
        assert mesh.processes == (0, 0, 1, 1) and mesh.local_positions() == [2, 3]
        with pytest.raises(ValueError, match=r"does not divide over the gang's 2"):
            make_mesh("data:3", device="cpu")

    # (hosts, cards per process) -> (backend, card per process)
    @pytest.mark.parametrize("hosts, cards, want", [
        (["a", "a"], [1, 1], ("gloo", [0, 0])),               # one card shared
        (["a", "a"], [0, 0], ("gloo", [-1, -1])),             # the CPU
        (["a", "a", "a", "a"], [4] * 4, ("nccl", [0, 1, 2, 3])),
        (["a", "b"], [1, 1], ("nccl", [0, 0])),               # 2 hosts x 1 card
        (["a"] * 4 + ["b"] * 4, [4] * 8, ("nccl", [0, 1, 2, 3] * 2)),
        (["a", "b", "a", "b"], [2] * 4, ("nccl", [0, 0, 1, 1])),
        (["a", "a", "b", "b"], [1] * 4, ("gloo", [0, 0, 0, 0])),
        (["a", "a", "b"], [2, 2, 1], ("nccl", [0, 1, 0])),
    ])
    def test_plan_gang(self, hosts, cards, want):
        from cadence_rag_tpu_torch.parallel.mesh import plan_gang

        assert plan_gang(hosts, cards) == want

    def test_the_model_axis_is_not_sharded(self):
        """Rows shard over ``data`` only: a ``model`` axis replicates them,
        whatever the axes' order."""
        from cadence_rag_tpu_torch.parallel.sharded import data_shards

        assert data_shards(make_mesh("data:4,model:2", CPU8)) == 4
        assert data_shards(make_mesh("model:2,data:4", CPU8)) == 4
        assert data_shards(make_mesh("model:8", CPU8)) == 1


class TestShardedTopk:
    def test_matches_the_jax_package(self):
        assert jax.device_count() == 8
        rng = np.random.default_rng(0)
        n, dim, batch, k = 512, 64, 4, 10
        emb_j, emb_t = _bf16(_unit_rows(rng, n, dim))
        qs = _unit_rows(rng, batch, dim)
        call_idx = np.zeros(n, dtype=np.int32)
        started = np.full(n, 1000, dtype=np.int32)
        allowed = np.ones((batch, 8), dtype=bool)
        dmin = np.zeros(batch, np.int32)
        dmax = np.full(batch, 2**31 - 1, np.int32)
        want = jax_dense_topk(
            jax_make_mesh("data:8"), emb_j, jnp.asarray(call_idx),
            jnp.asarray(started), jnp.asarray(qs), jnp.asarray(allowed),
            jnp.asarray(dmin), jnp.asarray(dmax), k)
        got = sharded_dense_topk(
            make_mesh("data:8", CPU8), emb_t, torch.from_numpy(call_idx),
            torch.from_numpy(started), torch.from_numpy(qs),
            torch.from_numpy(allowed), torch.from_numpy(dmin),
            torch.from_numpy(dmax), k)
        _assert_lane(got, want)

    def test_filters_respected_across_shards(self):
        rng = np.random.default_rng(1)
        n, dim = 256, 32
        _emb_j, emb_t = _bf16(_unit_rows(rng, n, dim))
        call_idx = (np.arange(n) % 4).astype(np.int32)
        started = np.full(n, 500, dtype=np.int32)
        qs = _unit_rows(rng, 1, dim)
        allowed = np.zeros((1, 4), dtype=bool)
        allowed[0, 2] = True
        scores, pos = sharded_dense_topk(
            make_mesh("data:8", CPU8), emb_t, torch.from_numpy(call_idx),
            torch.from_numpy(started), torch.from_numpy(qs),
            torch.from_numpy(allowed), torch.tensor([0], dtype=torch.int32),
            torch.tensor([2**31 - 1], dtype=torch.int32), 8)
        assert torch.isfinite(scores).all()
        assert set(call_idx[pos[0].numpy()]) == {2}

    def test_ties_go_to_the_lowest_global_row(self):
        """Equal scores in two shards: the lower shard's rows come first,
        each shard's own in row order, as one ``lax.top_k`` over the whole
        corpus would order them."""
        vals = [torch.tensor([[0.5, 0.5, 0.1]]), torch.tensor([[0.9, 0.5, 0.5]])]
        pos = [torch.tensor([[3, 7, 1]]), torch.tensor([[12, 10, 14]])]
        top_vals, top_pos = _merge_gathered(vals, pos, 5)
        assert top_pos.tolist() == [[12, 3, 7, 10, 14]]
        assert top_vals.tolist() == [[0.8999999761581421, 0.5, 0.5, 0.5, 0.5]]


class TestShardedMultiLane:
    def test_matches_the_jax_package(self):
        rng = np.random.default_rng(5)
        n, dim, dlex, s, batch = 512, 64, 256, 4, 3
        emb_j, emb_t = _bf16(_unit_rows(rng, n, dim))
        lex = rng.integers(-4, 5, size=(n, dlex)).astype(np.int8)
        tech = np.zeros((n, s), dtype=np.int32)
        tech[::7, 0] = 99
        call_idx = (np.arange(n) % 16).astype(np.int32)
        started = rng.integers(1000, 5000, size=n).astype(np.int32)
        has_emb = rng.random(n) > 0.1
        q_emb = _unit_rows(rng, batch, dim)
        q_lex = (rng.standard_normal((batch, dlex)) * 0.1).astype(np.float32)
        q_tech = np.stack([tech_query_structure_from_hashes([99], s)
                           for _ in range(batch)])
        allowed = rng.random((batch, 16)) < 0.7
        dmin = np.zeros(batch, np.int32)
        dmax = np.full(batch, 2**31 - 1, np.int32)
        dmin[1] = 2500
        host = (lex, tech, call_idx, started, has_emb, q_emb, q_lex, q_tech,
                allowed, dmin, dmax)
        want = jax_multi_lane(
            jax_make_mesh("data:8"), emb_j, *(jnp.asarray(a) for a in host),
            k_dense=8, k_lex=8, k_tech=8)
        got = sharded_multi_lane(
            make_mesh("data:8", CPU8), emb_t, *(torch.from_numpy(a) for a in host),
            k_dense=8, k_lex=8, k_tech=8)
        for lane in ("dense", "lex", "tech"):
            _assert_lane(got[lane], want[lane], lane)

    def test_dense_lane_excludes_rows_without_embeddings(self):
        rng = np.random.default_rng(9)
        n, dim = 128, 32
        emb = _unit_rows(rng, n, dim)
        has_emb = np.ones(n, dtype=bool)
        has_emb[::3] = False
        emb[~has_emb] = 0.0
        lanes = sharded_multi_lane(
            make_mesh("data:8", CPU8),
            torch.from_numpy(emb).to(torch.bfloat16),
            torch.from_numpy(rng.integers(-3, 4, size=(n, 64)).astype(np.int8)),
            torch.zeros((n, 2), dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32),
            torch.full((n,), 1000, dtype=torch.int32),
            torch.from_numpy(has_emb),
            torch.from_numpy(_unit_rows(rng, 1, dim)),
            torch.zeros((1, 64)), torch.zeros((1, 2), dtype=torch.int32),
            torch.ones((1, 4), dtype=torch.bool),
            torch.zeros(1, dtype=torch.int32),
            torch.full((1,), 2**31 - 1, dtype=torch.int32),
            k_dense=16, k_lex=8, k_tech=8)
        scores, pos = lanes["dense"]
        ranked = pos[0][torch.isfinite(scores[0])].numpy()
        assert ranked.size == 16 and has_emb[ranked].all()


def test_shard_tally_counts_launches_where_they_happen(monkeypatch):
    """A wrapper's launch counts for the shard whose lanes run it, in the
    thread that runs it; a launch outside a shard's lanes counts for none."""
    from cadence_rag_tpu_torch.kernels import build
    from cadence_rag_tpu_torch.parallel import sharded

    def lanes(*_args, **_kw):
        build.count_launch("fused_scan")
        build.count_launch("tech_topk")
        build.count_launch("fused_scan")
        return {}

    monkeypatch.setattr(sharded, "_lanes_one_corpus", lanes)
    monkeypatch.setattr(sharded, "launches_by_shard",
                        collections.defaultdict(collections.Counter))
    shards = [(s, (torch.zeros(4, 2),)) for s in (0, 1)]
    queries = sharded._OnDevice(q_emb=None, q_lex=None, q_tech=None, allowed=None,
                                dmin=None, dmax=None)
    build.count_launch("fused_scan")
    sharded.corpus_lanes("chunks", shards, 4, queries, torch.device("cpu"),
                         k_dense=1, k_lex=1, k_tech=1, dense_mode="ann",
                         dense_enabled=True)
    build.count_launch("tech_topk")
    assert {key: dict(t) for key, t in sharded.launches_by_shard.items()} == {
        ("chunks", s): {"fused_scan": 2, "tech_topk": 1} for s in (0, 1)}
