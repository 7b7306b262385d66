"""The neural embedder and the cross-encoder reranker (``models/embedder.py``,
``models/reranker.py``) against the JAX package's, on the CPU.

``tests/unit/test_models.py`` builds its weights with ``jax.random``, so its
cases are restated here on the port's API (all but the training step, which
waits for the training item). Then the same seeded numpy inputs go through
both packages, on the plain path (f32 products of bf16-rounded operands):

- the seeded initial weights: every leaf within INIT_ATOL (``models/prng``'s
  f32 normal against ``jax.random``'s, times 0.02; the bag's unit normals
  within 1e-6);
- ``encode`` and ``score_pairs``: within VEC_ATOL on JAX's own seeded init
  and on parameters carried across (``from_jax_params``), and within
  ARTIFACT_ATOL on every committed artifact
  (``artifacts/embedder/tuned_small_v1.npz``, ``artifacts/reranker/*.npz``),
  the providers' outputs included. The wider tolerance covers one operand
  rounded to bf16 on the other side of a tie: both packages round their
  activations to bf16 before each product, and summation order alone can
  move a value across a rounding boundary (one of the artifact's test
  texts differs by 1.1e-4, the others by less than 1e-5);
- npz files both ways: a file either package saved loads in the other and
  gives the same vectors;
- the reranker's attention is causal, as the JAX package's ``score_pairs``
  (through the embedder's ``_block``) makes it.
"""

from pathlib import Path

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
from torch_parity import port_store  # noqa: F401  (fixture)

INIT_ATOL = 1e-6
VEC_ATOL = 1e-5
ARTIFACT_ATOL = 5e-4
ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
RERANKER_ARTIFACTS = sorted((ARTIFACTS / "reranker").glob("*.npz"))
TINY_KW = dict(vocab_buckets=512, d_model=32, n_layers=2, n_heads=2, d_ff=64,
               max_len=16, embed_dim=24)
TINY = emb.EmbedderConfig(**TINY_KW)
JTINY = jemb.EmbedderConfig(**TINY_KW)
RR_KW = dict(vocab_buckets=256, d_model=32, n_layers=1, n_heads=2, d_ff=64,
             max_len=32)
RR_CFG = rr.RerankerConfig(**RR_KW)
TEXTS = ["hello world", "other text entirely here", "the ECONNRESET storm",
         "a b c d e f g h i j k l m n o p q r s t", "x",
         "rolling back to v2.3.1 stopped the resets"]
QUERY = "object store resets after the upgrade"
DOCS = ["the ECONNRESET storm started after the object store upgrade",
        "rolling back to v2.3.1 stopped the resets immediately",
        "quarterly pipeline review went well", "", "object store"]


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _flat_jax(params):
    return {emb.module_name("/".join(str(k) for k in path)): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _pairs(cfg, query=QUERY, docs=DOCS):
    return np.stack([rr.pair_tokenize(query, d, cfg) for d in docs])


# -- test_models.py, restated on the port ------------------------------------
class TestEmbedder:
    def test_vector_contract_unit_norm(self):
        model = emb.init_params(TINY, prng.PRNGKey(0), "cpu")
        out = emb.encode(model, emb.batch_tokenize(["hello world", "other text"], TINY))
        assert out.shape == (2, TINY.embed_dim)
        np.testing.assert_allclose(torch.linalg.vector_norm(out, dim=1).numpy(),
                                   1.0, atol=1e-3)

    def test_deterministic_tokenizer(self):
        a = emb.hash_tokenize("The Quick Fox", TINY)
        b = emb.hash_tokenize("the quick fox", TINY)
        np.testing.assert_array_equal(a, b)  # case-normalized
        assert (a > 0).all()
        for text in TEXTS:
            np.testing.assert_array_equal(a := emb.hash_tokenize(text, TINY),
                                          jemb.hash_tokenize(text, JTINY))
            assert a.dtype == np.int32

    def test_last_token_pooling_ignores_padding(self):
        model = emb.init_params(TINY, prng.PRNGKey(0), "cpu")
        va = emb.encode(model, emb.batch_tokenize(["hello world"], TINY))
        vb = emb.encode(model, emb.batch_tokenize(["hello world extra"], TINY))
        assert not np.allclose(va.numpy(), vb.numpy())

    def test_provider_interface(self, port_store, monkeypatch):
        monkeypatch.setattr(port_store, "embeddings_dim", 24)
        provider = emb.NeuralEmbeddingProvider(cfg=TINY)
        result = provider.embed(["some text", "more text"])
        assert isinstance(result.vectors, np.ndarray)
        assert result.vectors.shape == (2, 24)
        assert result.vectors.dtype == np.float32
        assert "cadence-neural-embedder" in result.model
        assert provider.device == torch.device("cpu")


class TestReranker:
    def test_pair_tokenize_sep(self):
        tokens = rr.pair_tokenize("query words", "doc words here", RR_CFG)
        assert rr.SEP_TOKEN_ID in tokens.tolist()
        jcfg = jrr.RerankerConfig(**RR_KW)
        for doc in DOCS + [" ".join(["w"] * 40)]:
            np.testing.assert_array_equal(rr.pair_tokenize(QUERY, doc, RR_CFG),
                                          jrr.pair_tokenize(QUERY, doc, jcfg))

    def test_score_shape_and_determinism(self):
        model = rr.init_params(RR_CFG, prng.PRNGKey(0), "cpu")
        tokens = np.stack([rr.pair_tokenize("q", "first doc", RR_CFG),
                           rr.pair_tokenize("q", "second doc", RR_CFG)])
        s1 = rr.score_pairs(model, tokens).numpy()
        s2 = rr.score_pairs(model, tokens).numpy()
        assert s1.shape == (2,)
        np.testing.assert_allclose(s1, s2)


class TestPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        model = emb.init_params(TINY, prng.PRNGKey(0), "cpu")
        path = str(tmp_path / "params.npz")
        emb.save_params(path, model)
        restored, cfg = emb.load_params(path, "cpu")
        assert cfg == TINY
        tokens = emb.batch_tokenize(["roundtrip text"], TINY)
        np.testing.assert_allclose(emb.encode(model, tokens).numpy(),
                                   emb.encode(restored, tokens).numpy(), rtol=1e-6)

    def test_provider_loads_trained_params(self, tmp_path, port_store, monkeypatch):
        model = emb.init_params(TINY, prng.PRNGKey(3), "cpu")
        path = str(tmp_path / "tuned.npz")
        emb.save_params(path, model)
        monkeypatch.setattr(port_store, "embedder_params_path", path)
        # a checkpoint whose embed_dim disagrees with EMBEDDINGS_DIM is a
        # startup-time misconfiguration
        with pytest.raises(RuntimeError, match="EMBEDDINGS_DIM"):
            emb.NeuralEmbeddingProvider()
        monkeypatch.setattr(port_store, "embeddings_dim", TINY.embed_dim)
        provider = emb.NeuralEmbeddingProvider()
        assert provider.model_id.endswith("-tuned")
        assert provider.cfg == TINY


# -- parity with the JAX package ---------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_embedder_init_matches_jax(seed):
    model = emb.init_params(TINY, prng.PRNGKey(seed), "cpu")
    want = _flat_jax(jemb.init_params(JTINY, jax.random.PRNGKey(seed)))
    got = {n: p.numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=INIT_ATOL, err_msg=name)


def test_reranker_init_matches_jax():
    model = rr.init_params(RR_CFG, prng.PRNGKey(0), "cpu")
    want = _flat_jax(jrr.init_params(jrr.RerankerConfig(**RR_KW),
                                     jax.random.PRNGKey(0)))
    got = {n: p.numpy() for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert got["bag_emb"].shape == (RR_CFG.vocab_buckets, 1)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=INIT_ATOL, err_msg=name)


@pytest.mark.parametrize("source", ["own_init", "carried"])
def test_encode_matches_jax(source):
    jparams = jemb.init_params(JTINY, jax.random.PRNGKey(1))
    model = (emb.init_params(TINY, prng.PRNGKey(1), "cpu") if source == "own_init"
             else emb.from_jax_params(_np_tree(jparams), TINY, "cpu"))
    tokens = emb.batch_tokenize(TEXTS, TINY)
    np.testing.assert_array_equal(tokens, jemb.batch_tokenize(TEXTS, JTINY))
    want = np.asarray(jemb.encode(jparams, jnp.asarray(tokens), JTINY))
    np.testing.assert_allclose(emb.encode(model, tokens).numpy(), want,
                               rtol=0, atol=VEC_ATOL)


@pytest.mark.parametrize("source", ["own_init", "carried"])
def test_score_pairs_matches_jax(source):
    jcfg = jrr.RerankerConfig(**RR_KW)
    jparams = jrr.init_params(jcfg, jax.random.PRNGKey(2))
    model = (rr.init_params(RR_CFG, prng.PRNGKey(2), "cpu") if source == "own_init"
             else rr.from_jax_params(_np_tree(jparams), RR_CFG, "cpu"))
    tokens = _pairs(RR_CFG)
    want = np.asarray(jrr.score_pairs(jparams, jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(rr.score_pairs(model, tokens).numpy(), want,
                               rtol=0, atol=VEC_ATOL)


def test_embedder_artifact_matches_jax(port_store, monkeypatch):
    """The committed tuned embedder (its bag regenerated): ``encode`` and the
    provider give JAX's vectors."""
    path = str(ARTIFACTS / "embedder" / "tuned_small_v1.npz")
    jparams, jcfg = jemb.load_params(path)
    model, cfg = emb.load_params(path, "cpu")
    texts = TEXTS + ["the downgrade fixed the failures",
                     "billing-api error rates spiked after the deploy"]
    tokens = emb.batch_tokenize(texts, cfg)
    want = np.asarray(jemb.encode(jparams, jnp.asarray(tokens), jcfg))
    got = emb.encode(model, tokens).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ARTIFACT_ATOL)
    assert (got * want).sum(axis=1).min() > 1 - 1e-6
    monkeypatch.setattr(port_store, "embedder_params_path", path)
    monkeypatch.setattr(port_store, "embeddings_dim", 1024)
    served = emb.NeuralEmbeddingProvider().embed(texts)
    np.testing.assert_array_equal(served.vectors, got)
    assert served.model == "cadence-neural-embedder-128d2L-tuned"


@pytest.mark.parametrize("path", RERANKER_ARTIFACTS, ids=lambda p: p.stem)
def test_reranker_artifacts_match_jax(path, port_store, monkeypatch):
    """Every committed reranker (the 6-field ones without a prior head,
    ``two_register_v1`` with one): ``score_pairs`` with and without a
    prior, and ``NeuralReranker.score``, give JAX's logits."""
    jparams, jcfg = jrr.load_params(str(path))
    model, cfg = rr.load_params(str(path), "cpu")
    assert (cfg.prior_residual, cfg.prior_gain) == (jcfg.prior_residual, jcfg.prior_gain)
    # 6-field rows predate the prior head
    assert len(np.load(path)["__rerank_cfg__"]) == (8 if cfg.prior_residual else 6)
    tokens = _pairs(cfg)
    prior = np.linspace(-3.0, 25.0, len(DOCS)).astype(np.float32)
    for p in (None, prior):
        want = np.asarray(jrr.score_pairs(
            jparams, jnp.asarray(tokens), jcfg,
            prior=None if p is None else jnp.asarray(p)))
        np.testing.assert_allclose(rr.score_pairs(model, tokens, p).numpy(),
                                   want, rtol=0, atol=ARTIFACT_ATOL)
    from cadence_rag_tpu.config import settings as jsettings

    monkeypatch.setattr(port_store, "reranker_params_path", str(path))
    monkeypatch.setattr(jsettings, "reranker_params_path", str(path))
    got = rr.NeuralReranker().score(QUERY, DOCS, priors=prior)
    want = jrr.NeuralReranker().score(QUERY, DOCS, priors=prior)
    np.testing.assert_allclose(got, want, rtol=0, atol=ARTIFACT_ATOL)
    np.testing.assert_array_equal(np.argsort(-got), np.argsort(-want))
    assert rr.NeuralReranker().score(QUERY, []).shape == (0,)


@pytest.mark.parametrize("kind", ["embedder", "reranker"])
def test_npz_files_load_in_both_packages(kind, tmp_path):
    """A checkpoint saved by either package loads in the other, with the
    same config and the same outputs."""
    if kind == "embedder":
        jparams = jemb.init_params(JTINY, jax.random.PRNGKey(4))
        jemb.save_params(str(tmp_path / "jax.npz"), jparams, JTINY, init_seed=4)
        emb.save_params(str(tmp_path / "port.npz"),
                        emb.init_params(TINY, prng.PRNGKey(4), "cpu"), init_seed=4)
        tokens = emb.batch_tokenize(TEXTS, TINY)
        from_jax, cfg = emb.load_params(str(tmp_path / "jax.npz"), "cpu")
        jp, jcfg = jemb.load_params(str(tmp_path / "port.npz"))
        got = [emb.encode(from_jax, tokens).numpy(),
               np.asarray(jemb.encode(jp, jnp.asarray(tokens), jcfg))]
        want = np.asarray(jemb.encode(jparams, jnp.asarray(tokens), JTINY))
        assert cfg == TINY and jcfg == JTINY
    else:
        jcfg0 = jrr.RerankerConfig(**RR_KW, prior_residual=True, prior_gain=0.2)
        cfg0 = rr.RerankerConfig(**RR_KW, prior_residual=True, prior_gain=0.2)
        jparams = jrr.init_params(jcfg0, jax.random.PRNGKey(4))
        jrr.save_params(str(tmp_path / "jax.npz"), jparams, jcfg0)
        rr.save_params(str(tmp_path / "port.npz"),
                       rr.init_params(cfg0, prng.PRNGKey(4), "cpu"))
        tokens = _pairs(cfg0)
        prior = np.arange(len(DOCS), dtype=np.float32)
        from_jax, cfg = rr.load_params(str(tmp_path / "jax.npz"), "cpu")
        jp, jcfg = jrr.load_params(str(tmp_path / "port.npz"))
        got = [rr.score_pairs(from_jax, tokens, prior).numpy(),
               np.asarray(jrr.score_pairs(jp, jnp.asarray(tokens), jcfg,
                                          prior=jnp.asarray(prior)))]
        want = np.asarray(jrr.score_pairs(jparams, jnp.asarray(tokens), jcfg0,
                                          prior=jnp.asarray(prior)))
        assert cfg == cfg0 and (jcfg.prior_residual, jcfg.prior_gain) == (True, 0.2)
    for g in got:
        np.testing.assert_allclose(g, want, rtol=0, atol=VEC_ATOL)
    assert sorted(np.load(tmp_path / "jax.npz").files) == \
        sorted(np.load(tmp_path / "port.npz").files)


def test_reranker_attention_is_causal():
    """The reranker runs the embedder's causal blocks (the JAX package's
    ``score_pairs`` does, whatever its docstring says): two pairs that share
    the query prefix have the same hidden states over that prefix, however
    their documents differ, and the JAX package agrees on the logits."""
    model = rr.init_params(RR_CFG, prng.PRNGKey(5), "cpu")
    tokens = torch.from_numpy(_pairs(RR_CFG, docs=[
        "first document about the object store",
        "an entirely different second document"])).long()
    prefix = len(QUERY.split()) + 1                      # query + [SEP]
    with torch.inference_mode():
        hidden, _mask = model.hidden(tokens, plain=True)
    torch.testing.assert_close(hidden[0, :prefix], hidden[1, :prefix],
                               rtol=0, atol=0)
    assert not torch.allclose(hidden[0, prefix:prefix + 3],
                              hidden[1, prefix:prefix + 3])
    jcfg = jrr.RerankerConfig(**RR_KW)
    jparams = jrr.init_params(jcfg, jax.random.PRNGKey(5))
    want = np.asarray(jrr.score_pairs(jparams, jnp.asarray(tokens.numpy()
                                                           .astype(np.int32)), jcfg))
    np.testing.assert_allclose(rr.score_pairs(model, tokens.numpy()).numpy(),
                               want, rtol=0, atol=VEC_ATOL)


def test_neural_providers_need_a_named_device(monkeypatch):
    """A provider never picks a device: without one named by the entry point
    (``device.set_models_device``), building one raises."""
    from cadence_rag_tpu_torch import device

    monkeypatch.setattr(device, "_models_device", None)
    with pytest.raises(RuntimeError, match="no device named"):
        emb.NeuralEmbeddingProvider(cfg=TINY)
    with pytest.raises(RuntimeError, match="no device named"):
        rr.NeuralReranker(cfg=RR_CFG)
    assert rr.NeuralReranker(cfg=RR_CFG, device="cpu").device.type == "cpu"
