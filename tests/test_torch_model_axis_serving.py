"""Serving under ``MESH_SHAPE`` with a ``model`` axis, the port on the CPU
against the JAX package and against its own ``data``-only mesh.

The model axis replicates the index's rows (JAX's ``P("data", None)``): a
data shard is computed once per process, so ``data:2,model:2`` must answer
as the JAX package under the same ``MESH_SHAPE`` (every request shape of
``request_bodies`` in one micro-batch, ``torch_parity.assert_same_response``)
and as the port's own ``data:2``, bit for bit, and as the JAX package's
unsharded program; the JAX package's own sharded program departs from that
on two requests (``JAX_SHARDED_DEPARTS``): their tech lanes hold rows of one
call, tied on recency, and JAX's row-sharded ``lax.approx_max_k``
(``cadence_rag_tpu/ops/topk.py:82``, under ``ops/techlane.py:81``) returns
the tied rows out of row order, which the ``top_k`` sort after it keeps.
``ops/techlane.py:7-9`` states the lane's order as recency, then id
ascending: the unsharded program's, and the port's under any mesh
(``test_tied_tech_rows_keep_row_order_under_the_mesh``). The JAX package builds its mesh
over every device, so its ``make_mesh`` is given conftest's first four
virtual CPU devices. Then a checkpoint round trip and a growth across
a doubling under the model axis, each against the port's unsharded index.
The two-process gang under ``data:1,model:2`` runs in
``test_torch_multihost.py``.
"""

import jax
import numpy as np
import pytest

from test_torch_sharded_serving import _ids, _populate, _reshard
from torch_parity import (  # noqa: F401  (fixtures)
    BOTH, JAX, PORT, assert_same_response, ingest_corpus, port_store,
    request_bodies, set_both,
)

MODEL_AXIS = "data:2,model:2"
# requests whose answer the JAX package's sharded program (data:2, with or
# without the model axis) gives otherwise than its own unsharded program:
# the artifacts' fused order, through the tech lane's tied rows
JAX_SHARDED_DEPARTS = {"budget", "limits"}


def _batch(pkg, calls):
    bodies = request_bodies(calls)
    return pkg.retrieve.retrieve_evidence_batch([pkg.request(b) for b in bodies.values()])


@pytest.fixture()
def jax_mesh_of_four(monkeypatch):
    from cadence_rag_tpu.parallel import mesh as jax_mesh

    make = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh",
                        lambda spec=None, devices=None: make(spec, jax.devices()[:4]))


def test_model_axis_answers_as_the_jax_package_and_as_data2(
        port_store, set_both, jax_mesh_of_four):
    """Every request shape in one micro-batch. The port under the model
    axis answers as its own ``data:2`` and as the JAX package's unsharded
    program, bit for bit, and as the JAX package under the same
    ``MESH_SHAPE`` on every request but JAX_SHARDED_DEPARTS: there the JAX
    package's sharded program departs from its own unsharded answer (a
    data axis alone does the same), and the port keeps the unsharded one."""
    names = list(request_bodies({"ext-B": "x"}))
    set_both("mesh_shape", MODEL_AXIS)
    for pkg in BOTH:
        pkg.index.reset_index()
    index = PORT.index.get_index("cpu")
    assert index.mesh.shape == {"data": 2, "model": 2}
    # two data shards, each held once (on the first position of its group)
    assert sorted(index.chunks._shards) == [0, 1]
    calls = {pkg.root: ingest_corpus(pkg) for pkg in BOTH}
    assert JAX.index.get_index().mesh.shape == {"data": 2, "model": 2}
    got = dict(zip(names, _batch(PORT, calls[PORT.root])))
    jax_sharded = dict(zip(names, _batch(JAX, calls[JAX.root])))
    set_both("mesh_shape", "data:2")
    PORT.index.reset_index()
    PORT.index.get_index("cpu")
    PORT.ingest.rebuild_index_from_store()
    for name, want in zip(names, _batch(PORT, calls[PORT.root])):
        assert_same_response(got[name], want, want_pkg=PORT)
    set_both("mesh_shape", "")
    JAX.index.reset_index()
    JAX.ingest.rebuild_index_from_store()
    departs = set()
    for name, want in zip(names, _batch(JAX, calls[JAX.root])):
        assert_same_response(got[name], want)
        try:
            assert_same_response(got[name], jax_sharded[name])
        except AssertionError:
            departs.add(name)
    assert departs == JAX_SHARDED_DEPARTS


def test_tied_tech_rows_keep_row_order_under_the_mesh():
    """Rows 0-2 match the query at one recency, row 3 at an older one, over
    32 rows. JAX's tech lane answers 0, 1, 2, 3 unsharded and another order
    of the tied rows with its rows sharded over ``data:2``; the port's
    sharded lanes answer 0, 1, 2, 3 under ``data:2`` and under the model
    axis."""
    import torch
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from cadence_rag_tpu.ops.techlane import tech_topk
    from cadence_rag_tpu_torch.parallel.mesh import make_mesh
    from cadence_rag_tpu_torch.parallel.sharded import sharded_multi_lane

    n, slots, k = 32, 8, 4
    tech = np.zeros((n, slots), np.int32)
    tech[:4, 9 % slots] = 9
    started = np.full(n, 1000, np.int32)
    started[3] = 900
    q_tech = np.zeros((2, slots), np.int32)
    q_tech[:, 9 % slots] = 9
    mask = np.ones((2, n), bool)
    want = [0, 1, 2, 3]
    lane = jax.jit(lambda d, st, q, m: tech_topk(d, st, q, m, k))
    assert np.asarray(lane(tech, started, q_tech, mask)[1])[0].tolist() == want
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    rows = NamedSharding(mesh, P("data", None))
    with mesh:
        got = lane(jax.device_put(tech, rows),
                   jax.device_put(started, NamedSharding(mesh, P("data"))),
                   q_tech, jax.device_put(mask, NamedSharding(mesh, P(None, "data"))))
    got = np.asarray(got[1])[0].tolist()
    assert sorted(got[:3]) == want[:3] and got[3] == 3 and got != want

    rng = np.random.default_rng(0)
    emb_rows = rng.standard_normal((n, 16)).astype(np.float32)
    t = torch.from_numpy
    for spec, size in (("data:2", 2), (MODEL_AXIS, 4)):
        lanes = sharded_multi_lane(
            make_mesh(spec, ["cpu"] * size), t(emb_rows).to(torch.bfloat16),
            torch.zeros((n, 8), dtype=torch.int8), t(tech),
            torch.zeros(n, dtype=torch.int32), t(started), torch.ones(n, dtype=torch.bool),
            t(emb_rows[:2]), torch.zeros((2, 8)), t(q_tech), torch.ones((2, 1), dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32), torch.full((2,), 2**31 - 1, dtype=torch.int32),
            k_dense=k, k_lex=k, k_tech=k)
        assert lanes["tech"][1][0].tolist() == want, spec


def test_checkpoint_roundtrip_under_the_model_axis(port_store, monkeypatch, tmp_path):
    monkeypatch.setattr(PORT.settings, "mesh_shape", MODEL_AXIS)
    PORT.index.reset_index()
    PORT.index.get_index("cpu")
    _populate(PORT)
    before = _ids(PORT)
    state = PORT.index.get_index().chunks.state_arrays()
    PORT.checkpoint.save_index(str(tmp_path / "snap"))
    PORT.index.reset_index()
    index = PORT.index.get_index("cpu")
    PORT.checkpoint.restore_index(str(tmp_path / "snap"), index)
    assert len(index.chunks._shards) == 2
    for key, value in index.chunks.state_arrays().items():
        np.testing.assert_array_equal(value, state[key], err_msg=key)
    assert _ids(PORT) == before
    flat = _reshard(monkeypatch, "")
    assert flat.mesh is None and _ids(PORT) == before


def test_growth_across_a_doubling_under_the_model_axis(port_store, monkeypatch):
    """16 rows over two data shards (model:4 replicating each): the 17th
    row doubles the capacity; the grown corpus is the unsharded rebuild's."""
    monkeypatch.setattr(PORT.settings, "index_initial_capacity", 16)
    monkeypatch.setattr(PORT.settings, "mesh_shape", "model:4,data:2")
    PORT.index.reset_index()
    index = PORT.index.get_index("cpu")
    _populate(PORT)
    assert index.chunks.capacity == 32 and index.chunks.count == 18
    assert {bufs[0].shape[0] for bufs in index.chunks._shards.values()} == {16}
    sharded_state = index.chunks.state_arrays()
    sharded = _ids(PORT)
    flat = _reshard(monkeypatch, "")
    for key, value in flat.chunks.state_arrays().items():
        np.testing.assert_array_equal(sharded_state[key], value, err_msg=key)
    assert _ids(PORT) == sharded
