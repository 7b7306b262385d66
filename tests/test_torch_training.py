"""Training (``models/embedder.py``, ``models/reranker.py``) against the JAX
package's, on the CPU, on the plain path (f32 products of bf16-rounded
operands; autograd takes the place of ``jax.value_and_grad``).

The same seeded numpy tokens and the same weights (carried across with
``from_jax_params``) go through both packages:

- ``info_nce_loss`` (with and without hard negatives) and ``pairwise_loss``
  (with and without ``prior_residual``) within LOSS_ATOL;
- every leaf's gradient within GRAD_RTOL of the leaf's largest |gradient|,
  or of GRAD_FLOOR times the model's largest where the leaf's is smaller:
  the reranker's ``final_ln.bias`` gradient is zero in exact arithmetic
  (the hi and lo scores' gradients cancel) and both packages give only
  rounding noise there (~3e-8). Both packages round each product's
  operands, and each cast's cotangent, to bf16; a cotangent element whose
  f32 value lies near a rounding boundary rounds the other way under another
  summation order, and the flip travels into the weights' gradients (read:
  4.8e-3 for the embedder, 1.26e-2 for the reranker with its prior). The frozen bag and ``mix`` get
  no gradient in either package;
- ``adamw_update`` on identical numpy params, gradients and state within
  ADAMW_ATOL, every leaf updated, zero gradients included; the optimizer
  state (``mu``, ``nu``, ``step``) carried across with
  ``opt_state_from_jax`` and held to JAX's after the update;
- TRAJECTORY_STEPS train steps on identical batches: each step's loss
  within TRAJECTORY_ATOL of JAX's (Adam's first step moves an element by
  ~lr times the sign of its gradient, so a tiny gradient whose sign flips
  moves it 2 lr: the parameters drift apart by a few lr, and the losses
  with them; read: 7.3e-3 over 8 steps at lr 1e-3), and ``mix`` (no
  gradient, decayed by AdamW) equal to JAX's;
- JAX's ``test_train_step_reduces_loss`` restated on the port;
- ``save_params`` of a port-trained model loads in the JAX package, and
  the reverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_rag_tpu.models import embedder as jemb
from cadence_rag_tpu.models import reranker as jrr
from cadence_rag_tpu_torch.models import embedder as emb
from cadence_rag_tpu_torch.models import prng
from cadence_rag_tpu_torch.models import reranker as rr
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

LOSS_ATOL = 1e-5
GRAD_RTOL = 2e-2
GRAD_FLOOR = 1 / 64
ADAMW_ATOL = 1e-7
TRAJECTORY_STEPS = 5
TRAJECTORY_ATOL = 1.5e-2
VEC_ATOL = 1e-5
EMB_KW = dict(vocab_buckets=512, d_model=32, n_layers=2, n_heads=2, d_ff=64,
              max_len=16, embed_dim=24)
TINY, JTINY = emb.EmbedderConfig(**EMB_KW), jemb.EmbedderConfig(**EMB_KW)
RR_KW = dict(vocab_buckets=256, d_model=32, n_layers=1, n_heads=2, d_ff=64,
             max_len=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return emb.flatten_tree(_np(tree))


def _tokens(rng, batch, max_len, vocab, low=1):
    tokens = rng.integers(low, vocab, size=(batch, max_len)).astype(np.int32)
    for row, length in enumerate(rng.integers(2, max_len + 1, size=batch)):
        tokens[row, length:] = 0
    return tokens


def _embedder_pair(seed=0):
    params = jemb.init_params(JTINY, jax.random.PRNGKey(seed))
    return params, emb.trainable(emb.from_jax_params(_np(params), TINY, "cpu"))


def _reranker_pair(prior_residual, seed=1):
    kw = dict(RR_KW, prior_residual=prior_residual, prior_gain=0.5)
    jcfg, cfg = jrr.RerankerConfig(**kw), rr.RerankerConfig(**kw)
    params = jrr.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, emb.trainable(rr.from_jax_params(_np(params), cfg, "cpu"))


def _assert_grads_match(model, loss, jax_grads):
    got = emb.gradients(model, loss)
    want = _flat(jax_grads)
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        if not np.abs(g).any():
            assert got[name] is None or not bool(got[name].any()), name
            continue
        scale = max(np.abs(g).max(), GRAD_FLOOR * top)
        diff = np.abs(got[name].numpy() - g).max() / scale
        assert diff <= GRAD_RTOL, (name, diff)
    return got


@pytest.mark.parametrize("with_negatives", [False, True])
def test_info_nce_loss_and_gradients_match_jax(with_negatives):
    params, model = _embedder_pair()
    rng = np.random.default_rng(0)
    a, p, n = (_tokens(rng, 8, 16, 512) for _ in range(3))
    negs = n if with_negatives else None
    j_loss, j_grads = jax.value_and_grad(
        lambda q: jemb.info_nce_loss(q, jnp.asarray(a), jnp.asarray(p), JTINY,
                                     negatives=None if negs is None else jnp.asarray(negs))
    )(params)
    loss = emb.info_nce_loss(model, a, p, negatives=negs)
    assert float(loss) == pytest.approx(float(j_loss), abs=LOSS_ATOL)
    got = _assert_grads_match(model, loss, j_grads)
    assert got["bag_emb"] is None and got["mix"] is None   # freeze_bag


@pytest.mark.parametrize("prior_residual", [False, True])
def test_pairwise_loss_and_gradients_match_jax(prior_residual):
    jcfg, params, model = _reranker_pair(prior_residual)
    rng = np.random.default_rng(3)
    hi, lo = (_tokens(rng, 8, 32, 256, low=2) for _ in range(2))
    p_hi, p_lo = (rng.normal(size=8).astype(np.float32) for _ in range(2))
    j_loss, j_grads = jax.value_and_grad(jrr.pairwise_loss)(
        params, jnp.asarray(hi), jnp.asarray(lo), jcfg, jnp.asarray(p_hi),
        jnp.asarray(p_lo))
    loss = rr.pairwise_loss(model, hi, lo, p_hi, p_lo)
    assert float(loss) == pytest.approx(float(j_loss), abs=LOSS_ATOL)
    got = _assert_grads_match(model, loss, j_grads)
    # scoring never reads the bag head and mix: no gradient, as in JAX
    assert got["bag_emb"] is None and got["mix"] is None


def test_prior_joins_the_margin_without_a_gradient_path():
    _, _, model = _reranker_pair(True)
    rng = np.random.default_rng(4)
    hi, lo = (_tokens(rng, 4, 32, 256, low=2) for _ in range(2))
    prior = torch.zeros(4, requires_grad=True)
    loss = rr.pairwise_loss(model, hi, lo, prior, torch.zeros(4))
    assert torch.autograd.grad(loss, prior, allow_unused=True)[0] is None


def test_adamw_update_matches_jax():
    """Two JAX updates build a state with moments; the third runs in both
    packages from that state: params, mu, nu and step within ADAMW_ATOL."""
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(16, 8)).astype(np.float32),
              "b": rng.normal(size=(8,)).astype(np.float32),
              "frozen": rng.normal(size=(4, 4)).astype(np.float32)}
    grads = [{"w": rng.normal(size=(16, 8)).astype(np.float32) * 1e-3,
              "b": rng.normal(size=(8,)).astype(np.float32),
              "frozen": np.zeros((4, 4), np.float32)} for _ in range(3)]
    kw = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = jemb.adamw_init(j_params)
    for g in grads[:2]:
        j_params, j_state = jemb.adamw_update(j_params, jax.tree.map(jnp.asarray, g),
                                              j_state, **kw)
    t_params = {n: torch.tensor(np.asarray(v)) for n, v in j_params.items()}
    t_state = emb.opt_state_from_jax(_np(j_state), "cpu")
    assert int(t_state["step"]) == 2 and t_state["step"].dtype == torch.int32
    j_params, j_state = jemb.adamw_update(j_params, jax.tree.map(jnp.asarray, grads[2]),
                                          j_state, **kw)
    t_grads = {n: torch.tensor(v) for n, v in grads[2].items()}
    t_grads["frozen"] = None                    # no gradient: decayed all the same
    emb.adamw_update(t_params, t_grads, t_state, **kw)
    for name in params:
        np.testing.assert_allclose(t_params[name].numpy(), np.asarray(j_params[name]),
                                   atol=ADAMW_ATOL, rtol=0)
        np.testing.assert_allclose(t_state["mu"][name].numpy(),
                                   np.asarray(j_state["mu"][name]), atol=ADAMW_ATOL, rtol=0)
        np.testing.assert_allclose(t_state["nu"][name].numpy(),
                                   np.asarray(j_state["nu"][name]), atol=ADAMW_ATOL, rtol=0)
    assert int(t_state["step"]) == int(j_state["step"]) == 3
    assert not np.array_equal(t_params["frozen"].numpy(), params["frozen"])


def test_adamw_init_matches_jax():
    params, model = _embedder_pair()
    state, j_state = emb.adamw_init(model), jemb.adamw_init(params)
    assert set(state["mu"]) == set(_flat(j_state["mu"])) == set(state["nu"])
    assert all(not bool(t.any()) for t in state["mu"].values())
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32


def test_train_step_trajectory_matches_jax():
    params, model = _embedder_pair()
    j_opt, opt = jemb.adamw_init(params), emb.adamw_init(model)
    step = jax.jit(lambda p, o, a, b, n: jemb.train_step(p, o, a, b, JTINY, negatives=n,
                                                         lr=1e-3))
    rng = np.random.default_rng(6)
    for _ in range(TRAJECTORY_STEPS):
        a, p, n = (_tokens(rng, 8, 16, 512) for _ in range(3))
        params, j_opt, j_loss = step(params, j_opt, jnp.asarray(a), jnp.asarray(p),
                                     jnp.asarray(n))
        model, opt, loss = emb.train_step(model, opt, a, p, negatives=n, lr=1e-3)
        assert float(loss) == pytest.approx(float(j_loss), abs=TRAJECTORY_ATOL)
    assert int(opt["step"]) == int(j_opt["step"]) == TRAJECTORY_STEPS
    # the frozen mixture: no gradient, decayed by AdamW, JAX's bytes
    np.testing.assert_array_equal(model.mix.detach().numpy(), np.asarray(params["mix"]))
    assert not np.array_equal(np.asarray(params["mix"]), [1.0, 0.5])


def test_train_step_reduces_loss():
    """``tests/unit/test_models.py::test_train_step_reduces_loss`` on the port."""
    model = emb.init_params(TINY, prng.PRNGKey(0), "cpu")
    opt = emb.adamw_init(model)
    rng = np.random.default_rng(0)
    anchors = rng.integers(1, TINY.vocab_buckets, size=(8, TINY.max_len)).astype(np.int32)
    positives = rng.integers(1, TINY.vocab_buckets, size=(8, TINY.max_len)).astype(np.int32)
    first_loss = loss = None
    for _ in range(30):
        model, opt, loss = emb.train_step(model, opt, anchors, positives)
        if first_loss is None:
            first_loss = float(loss)
    assert float(loss) < first_loss * 0.8, (first_loss, float(loss))


def test_serving_forward_is_unchanged_by_training_mode():
    params, model = _embedder_pair()
    tokens = torch.from_numpy(_tokens(np.random.default_rng(7), 4, 16, 512))
    served = model(tokens)
    assert not served.requires_grad
    with torch.no_grad():
        assert torch.equal(served, model.vectors(tokens))
    frozen = emb.from_jax_params(_np(params), TINY, "cpu")
    assert torch.equal(served, frozen(tokens))


@pytest.mark.parametrize("kind", ["embedder", "reranker"])
def test_trained_npz_loads_in_both_packages(kind, tmp_path):
    """Two steps in one package, saved; the other package loads the file
    and holds the same leaves (and vectors / scores)."""
    rng = np.random.default_rng(8)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    if kind == "embedder":
        params, model = _embedder_pair()
        opt, j_opt = emb.adamw_init(model), jemb.adamw_init(params)
        for _ in range(2):
            a, p = _tokens(rng, 8, 16, 512), _tokens(rng, 8, 16, 512)
            model, opt, _ = emb.train_step(model, opt, a, p, lr=1e-3)
            params, j_opt, _ = jemb.train_step(params, j_opt, jnp.asarray(a),
                                               jnp.asarray(p), JTINY, lr=1e-3)
        emb.save_params(port_path, model, init_seed=0)
        jemb.save_params(jax_path, params, JTINY, init_seed=0)
        loaded_j, _ = jemb.load_params(port_path)
        loaded_t, _ = emb.load_params(jax_path, "cpu")
        tokens = _tokens(rng, 4, 16, 512)
        np.testing.assert_allclose(
            np.asarray(jemb.encode(loaded_j, jnp.asarray(tokens), JTINY)),
            model(torch.from_numpy(tokens)).numpy(), atol=VEC_ATOL, rtol=0)
    else:
        jcfg, params, model = _reranker_pair(True)
        opt, j_opt = emb.adamw_init(model), jemb.adamw_init(params)
        for _ in range(2):
            hi, lo = _tokens(rng, 8, 32, 256, low=2), _tokens(rng, 8, 32, 256, low=2)
            prior = np.zeros(8, np.float32)
            model, opt, _ = rr.train_step(model, opt, hi, lo, lr=1e-3, prior_hi=prior,
                                          prior_lo=prior)
            params, j_opt, _ = jrr.train_step(params, j_opt, jnp.asarray(hi),
                                              jnp.asarray(lo), jcfg, lr=1e-3,
                                              prior_hi=jnp.asarray(prior),
                                              prior_lo=jnp.asarray(prior))
        rr.save_params(port_path, model)
        jrr.save_params(jax_path, params, jcfg)
        loaded_j, _ = jrr.load_params(port_path)
        loaded_t, _ = rr.load_params(jax_path, "cpu")
        tokens = _tokens(rng, 4, 32, 256, low=2)
        np.testing.assert_allclose(
            np.asarray(jrr.score_pairs(loaded_j, jnp.asarray(tokens), jcfg)),
            rr.score_pairs(model, tokens).numpy(), atol=VEC_ATOL, rtol=0)
    # every leaf the other package saved, as it saved it (a frozen bag is
    # not stored: both packages draw it again from the seed at load)
    with np.load(port_path) as stored:
        names = {emb.module_name(k) for k in stored.files if k.startswith("[")}
    assert names == set(_flat(params)) - ({"bag_emb"} if kind == "embedder" else set())
    for name in names:
        np.testing.assert_array_equal(_flat(loaded_j)[name], dict(
            model.named_parameters())[name].detach().numpy(), err_msg=name)
        np.testing.assert_array_equal(dict(loaded_t.named_parameters())[name]
                                      .detach().numpy(), _flat(params)[name],
                                      err_msg=name)
