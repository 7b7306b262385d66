"""The ``model`` mesh axis (``parallel/tensor.py``, the tensor-parallel
Qwen3 encoder and embedder) against the JAX package's ``sharded=True``
programs, on the CPU.

The JAX side runs on conftest's eight virtual CPU devices, its weights laid
out by its own ``param_shardings``; the port's mesh is the CPU repeated.
Both get the same seeded numpy tokens and the same weights (the port's
carried from JAX's with ``from_jax_params``), and:

- the Qwen3 tiny preset, tensor-parallel at ``data:2,model:4`` (JAX's own
  test's mesh: a kv head replicated over two positions) and at
  ``data:1,model:2``: within TP_ATOL of JAX's ``encode(..., sharded=True)``
  (JAX's own tolerance for tp against one device; read: 3.4e-3, the gap of
  XLA's in-process bf16 intermediates that ``test_torch_qwen3.py``
  describes) and within TINY_ATOL of the port's unsharded forward (read:
  0.0, every bf16 rounding the same);
- weights born sharded at ``data:1,model:8``: each position's shard is the
  unsharded init's slice that ``param_shardings`` gives it, bit for bit;
- the embedder at the dry run's configuration and at ``tuned_small_v1``'s
  (with the bag head) within TP_ATOL of JAX's sharded ``encode`` (read:
  2.8e-4 and 3.8e-5; JAX's sharded program is its unsharded one within
  3e-8, and the gap is the port's unsharded forward's against JAX's in
  this process, where XLA keeps bf16 intermediates in f32), and equal to
  the port's unsharded forward;
- ``gather_params(shard_params(m)) == m`` for both models, JAX's fused
  ``wqkv`` included;
- three dp+tp ``train_step``s at ``data:4,model:2`` against JAX's
  ``train_step(..., sharded=True)`` under the same mesh, from the same
  weights and AdamW state: each loss within TRAJECTORY_ATOL
  (``test_torch_training.py``'s), and the parameters' change, gathered,
  within PARAM_CHANGE_RTOL of JAX's as a share of JAX's change (read:
  0.041, elements whose tiny gradient flips sign between the packages
  moving 2 lr apart; a step that changes nothing reads 1.0, one that drops
  the ``w_in`` gradients 0.45);
- the sharded gradient, gathered, against the unsharded one within
  ``test_torch_training.py``'s GRAD_RTOL.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cadence_rag_tpu.models import embedder as jemb
from cadence_rag_tpu.models import qwen3 as jq
from cadence_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cadence_rag_tpu_torch.models import embedder as emb
from cadence_rag_tpu_torch.models import prng
from cadence_rag_tpu_torch.models import qwen3 as q3
from cadence_rag_tpu_torch.parallel import tensor as tp
from cadence_rag_tpu_torch.parallel.mesh import make_mesh
from chip_smoke import param_change_gap
from test_torch_qwen3 import TINY_ATOL
from test_torch_training import GRAD_FLOOR, GRAD_RTOL, TRAJECTORY_ATOL
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TP_ATOL = 2e-2
LR = 1e-3
STEPS = 3
PARAM_CHANGE_RTOL = 0.1
QTINY = q3.PRESETS["tiny"]
DRYRUN_KW = dict(vocab_buckets=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                 max_len=16, embed_dim=64)
ARTIFACT = Path(__file__).resolve().parent.parent / "artifacts" / "embedder" / \
    "tuned_small_v1.npz"
QTEXTS = ["alpha beta gamma", "delta epsilon", "zeta eta theta iota", "kappa"]


def _cpu_mesh(spec):
    size = int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))
    return make_mesh(spec, ["cpu"] * size)


def _jax_mesh(spec):
    size = int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))
    return jax_make_mesh(spec, devices=jax.devices()[:size])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(rng, batch, max_len, vocab):
    tokens = rng.integers(1, vocab, size=(batch, max_len)).astype(np.int32)
    for row, length in enumerate(rng.integers(2, max_len + 1, size=batch)):
        tokens[row, length:] = 0
    return tokens


def _put(tree, shardings):
    return jax.tree.map(lambda x, s: jax.device_put(x, s), tree, shardings,
                        is_leaf=lambda x: isinstance(x, (jnp.ndarray, np.ndarray)))


@pytest.fixture(scope="module")
def qwen_pair():
    params = jq.init_params(jq.PRESETS["tiny"], jax.random.PRNGKey(0))
    return params, q3.from_jax_params(_np(params), QTINY, "cpu")


# -- Qwen3 ------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["data:2,model:4", "data:1,model:2"])
def test_qwen3_tensor_parallel_matches_jax_and_unsharded(qwen_pair, spec):
    params, model = qwen_pair
    tokens = q3.batch_tokenize(QTEXTS, QTINY)
    jmesh = _jax_mesh(spec)
    shardings = jq.param_shardings(jq.PRESETS["tiny"], jmesh)
    with jmesh:
        want = np.asarray(jax.jit(
            lambda p, t: jq.encode(p, t, jq.PRESETS["tiny"], sharded=True))(
            {n: jax.device_put(a, shardings[n]) for n, a in params.items()},
            jax.device_put(jnp.asarray(tokens), NamedSharding(jmesh, P("data", None)))))
    sharded = q3.shard_params(model, _cpu_mesh(spec))
    got = sharded(tokens).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TP_ATOL)
    np.testing.assert_allclose(got, model(torch.from_numpy(tokens)).numpy(),
                               rtol=0, atol=TINY_ATOL)


def test_qwen3_shards_gather_back(qwen_pair):
    _params, model = qwen_pair
    back = q3.gather_params(q3.shard_params(model, _cpu_mesh("data:2,model:4")), "cpu")
    for name, value in model.params().items():
        assert torch.equal(back.params()[name], value), name


def test_qwen3_born_sharded_is_the_unsharded_init_sliced():
    mesh = _cpu_mesh("data:1,model:8")
    layouts = q3.param_shardings(QTINY, mesh)
    born = q3.init_params(QTINY, prng.PRNGKey(1), "cpu", mesh=mesh)
    whole = q3.init_params(QTINY, prng.PRNGKey(1), "cpu").params()
    for pos in range(8):
        held = born.params.at(pos)
        for name, layout in layouts.items():
            assert torch.equal(held[name], layout.take(whole[name], pos)), (pos, name)
            if not layout.replicated:
                assert held[name].numel() < whole[name].numel(), (pos, name)
    assert born.params.at(0)["w_gate"].shape[-1] == QTINY.d_ff // 8
    # 4 query heads over 8 positions: half a head's columns each, and the kv
    # head its query head uses, whole, replicated over 4 positions
    assert born.params.at(0)["wq"].shape[-1] == QTINY.q_dim // 8
    heads = [layouts["wk"].ranges[m] for m in range(8)]
    assert heads == [((0, 16),)] * 4 + [((16, 32),)] * 4
    assert torch.equal(born.params.at(3)["wk"], whole["wk"][:, :, :16])
    with pytest.raises(ValueError, match="query heads do not split"):
        born(q3.batch_tokenize(QTEXTS, QTINY))


# -- the embedder -------------------------------------------------------------------
def _embedder_pair(kw=DRYRUN_KW, seed=0):
    jcfg = jemb.EmbedderConfig(**kw)
    params = jemb.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, emb.from_jax_params(_np(params), emb.EmbedderConfig(**kw), "cpu")


def _jax_sharded(jcfg, params, spec):
    jmesh = _jax_mesh(spec)
    return jmesh, _put(params, jemb.param_shardings(jcfg, jmesh))


@pytest.mark.parametrize("config", ["dryrun", "tuned_small_v1"])
def test_embedder_tensor_parallel_matches_jax(config):
    spec = "data:2,model:2"
    if config == "dryrun":
        jcfg, params, model = _embedder_pair()
    else:
        params, jcfg = jemb.load_params(str(ARTIFACT))
        cfg = emb.EmbedderConfig(**{f.name: getattr(jcfg, f.name)
                                    for f in dataclasses.fields(emb.EmbedderConfig)})
        model = emb.from_jax_params(_np(params), cfg, "cpu")
        assert cfg.use_bag and cfg.d_model == 128 and cfg.embed_dim == 1024
    tokens = _tokens(np.random.default_rng(1), 4, jcfg.max_len, jcfg.vocab_buckets)
    jmesh, jparams = _jax_sharded(jcfg, params, spec)
    with jmesh:
        want = np.asarray(jax.jit(lambda p, t: jemb.encode(p, t, jcfg, sharded=True))(
            jparams, jax.device_put(jnp.asarray(tokens), NamedSharding(jmesh, P("data", None)))))
    sharded = emb.shard_params(model, _cpu_mesh(spec))
    got = sharded(tokens).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TP_ATOL)
    np.testing.assert_array_equal(got, model(torch.from_numpy(tokens)).numpy())


def test_embedder_shards_gather_back_with_jax_fused_wqkv():
    jcfg, params, model = _embedder_pair()
    mesh = _cpu_mesh("data:1,model:4")
    sharded = emb.shard_params(model, mesh)
    # the port's layout: [q_m | k_m | v_m], not JAX's contiguous cut
    wqkv = model.blocks[0].wqkv.detach()
    d = jcfg.d_model
    held = sharded.params.at(1)["blocks.0.wqkv"]
    assert torch.equal(held, torch.cat([wqkv[:, j * d + 16:j * d + 32] for j in range(3)], 1))
    back = emb.gather_params(sharded, "cpu")
    for name, value in emb.flatten_tree(_np(params)).items():
        assert np.array_equal(dict(back.named_parameters())[name].detach().numpy(), value), name


def test_dp_tp_train_steps_match_jax():
    jcfg, params, model = _embedder_pair()
    spec = "data:4,model:2"
    jmesh, jparams = _jax_sharded(jcfg, params, spec)
    j_opt = jemb.adamw_init(jparams)
    step = jax.jit(lambda p, o, a, b: jemb.train_step(p, o, a, b, jcfg, sharded=True, lr=LR))
    sharded = emb.shard_params(model, _cpu_mesh(spec))
    opt = emb.adamw_init(sharded.params.leaves())
    rows = NamedSharding(jmesh, P("data", None))
    start = {k: torch.from_numpy(v) for k, v in emb.flatten_tree(_np(jparams)).items()}
    rng = np.random.default_rng(6)
    for _ in range(STEPS):
        a, p = (_tokens(rng, 8, jcfg.max_len, jcfg.vocab_buckets) for _ in range(2))
        with jmesh:
            jparams, j_opt, j_loss = step(jparams, j_opt, jax.device_put(a, rows),
                                          jax.device_put(p, rows))
        sharded, opt, loss = emb.train_step(sharded, opt, a, p, lr=LR)
        assert float(loss) == pytest.approx(float(j_loss), abs=TRAJECTORY_ATOL)
    assert int(opt["step"]) == int(j_opt["step"]) == STEPS
    got = dict(emb.gather_params(sharded, "cpu").named_parameters())
    want = {k: torch.from_numpy(v) for k, v in emb.flatten_tree(_np(jparams)).items()}
    assert param_change_gap(got, want, start) <= PARAM_CHANGE_RTOL
    # the frozen mixture: no gradient, decayed by AdamW on every shard
    np.testing.assert_array_equal(got["mix"].detach().numpy(), np.asarray(jparams["mix"]))


def test_sharded_gradient_gathers_to_the_unsharded_one():
    _jcfg, _params, model = _embedder_pair()
    rng = np.random.default_rng(3)
    a, p = (_tokens(rng, 8, 16, 512) for _ in range(2))
    want = emb.gradients(emb.trainable(model), emb.info_nce_loss(model, a, p))
    sharded = emb.shard_params(model, _cpu_mesh("data:4,model:2"))
    leaves = sharded.params.requires_grad_(True).tensors
    loss = emb.info_nce_loss(sharded, a, p)
    keys = list(leaves)
    grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys],
                                               allow_unused=True)))
    zero = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in grads.items()}
    got = sharded.params.gather(sharded.params.sync_grads(zero), device="cpu")
    top = max(float(g.abs().max()) for g in want.values() if g is not None)
    for name, g in want.items():
        if g is None:
            assert not bool(got[name].any()), name
            continue
        scale = max(float(g.abs().max()), GRAD_FLOOR * top)
        assert float((got[name] - g).abs().max()) / scale <= GRAD_RTOL, name


def test_copies_on_distinct_devices_take_the_summed_gradient():
    """A data group over two devices holds a copy of each leaf on each, and
    ``sync_grads`` gives every copy the sum of both copies' gradients: the
    step equals the one over a mesh whose positions share one device
    (where autograd sums the positions' gradients into one leaf).
    ``cpu`` and ``cpu:0`` are two devices to the mesh and one to torch."""
    _jcfg, _params, model = _embedder_pair()
    rng = np.random.default_rng(4)
    a, p = (_tokens(rng, 8, 16, 512) for _ in range(2))
    stepped = {}
    for devices in (["cpu", "cpu"], ["cpu", "cpu:0"]):
        sharded = emb.shard_params(model, make_mesh("data:2", devices))
        assert len(sharded.params.tensors) == len(sharded.params.layouts) * len(set(devices))
        sharded, _opt, _loss = emb.train_step(
            sharded, emb.adamw_init(sharded.params.leaves()), a, p, lr=LR)
        copies = {}
        for (name, _m, _dev), t in sharded.params.tensors.items():
            copies.setdefault(name, []).append(t.detach())
        assert all(torch.equal(c[0], c[-1]) for c in copies.values())
        stepped[len(set(devices))] = sharded.params.gather(device="cpu")
    for name, value in stepped[1].items():
        assert torch.equal(stepped[2][name], value), name


def test_layouts_split_and_put_back():
    layout = tp.split(12, 1, 2, pieces=3)
    assert layout.ranges == (((0, 2), (4, 6), (8, 10)), ((2, 4), (6, 8), (10, 12)))
    whole = torch.arange(24.0).reshape(2, 12)
    shards = [layout.take(whole, m) for m in range(2)]
    assert torch.equal(layout.put(shards, 12), whole)
    with pytest.raises(ValueError, match="do not split"):
        tp.split(10, 0, 4)


def test_mesh_axis_arithmetic():
    mesh = _cpu_mesh("model:2,data:4")
    assert [mesh.axis_index(p, "data") for p in range(8)] == [0, 1, 2, 3] * 2
    assert [mesh.axis_index(p, "model") for p in range(8)] == [0] * 4 + [1] * 4
    assert mesh.model_group(5) == [1, 5] and mesh.data_group(5) == [4, 5, 6, 7]
    assert mesh.shard_positions(2) == [2, 6] and mesh.n_shards == 4
    assert list(mesh.local_shards()) == [0, 1, 2, 3]
    flat = _cpu_mesh("data:2,model:2")
    assert flat.model_group(2) == [2, 3] and flat.shard_positions(1) == [2, 3]
    assert flat.held_shards(0) == [0, 1] and flat.shard_holders(1) == [0]
