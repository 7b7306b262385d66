"""The Qwen3-shaped encoder (``models/qwen3.py``) against the JAX package's,
on the CPU.

``tests/unit/test_qwen3.py``'s nine unsharded cases are restated on the
port's API (its two sharded cases wait for the sharding item). Then:

- the synthetic weights: the tiny preset's and the 4b widths' (depth 2,
  vocab 1024) are the JAX package's ``init_params``, bit for bit, and
  ``from_jax_params`` carries JAX's arrays across unchanged;
- ``encode``: the JAX package runs in a child process with XLA's excess
  precision off (``--xla_allow_excess_precision=false``). In this process
  XLA keeps some of ``encode``'s bf16 intermediates in f32 inside its
  ``lax.scan``, where the port, like JAX op by op, rounds them. With it
  off, the tiny preset's vectors are JAX's within TINY_ATOL; at the 4b
  widths, where head_dim 128 and the 32/8 GQA grouping show, within
  WIDE_ATOL with a cosine of at least WIDE_MIN_COS per vector: each row's
  last hidden state is pooled from bf16, and a sum taken in another order
  can round a bf16 activation the other way;
- npz files both ways, bf16 as uint16 bits with the ``__bf16__`` manifest.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_rag_tpu.models import qwen3 as jq
from cadence_rag_tpu_torch.models import prng
from cadence_rag_tpu_torch.models import qwen3 as q3
from torch_parity import port_store  # noqa: F401  (fixture)

TINY = q3.PRESETS["tiny"]
WIDE = dataclasses.replace(q3.PRESETS["4b"], n_layers=2, vocab_buckets=1024)
TINY_ATOL = 1e-6
WIDE_ATOL = 2e-3
WIDE_MIN_COS = 0.9999
REPO = Path(__file__).resolve().parent.parent
TEXTS = ["hello world", "other text entirely", "alpha beta gamma delta epsilon",
         "one two three four five six seven eight nine ten eleven twelve",
         "x", "the ECONNRESET storm hit the object store gateway"]

JAX_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from cadence_rag_tpu.models import qwen3 as jq
out = {}
configs = {"tiny": jq.PRESETS["tiny"],
           "wide": dataclasses.replace(jq.PRESETS["4b"], n_layers=2,
                                       vocab_buckets=1024)}
data = np.load(sys.argv[1])
for name, cfg in configs.items():
    params = jq.init_params(cfg, jax.random.PRNGKey(0))
    out[name] = np.asarray(jq.encode(params, jnp.asarray(data[name]), cfg))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def models():
    """The port's seeded weights for both configs, made once."""
    return {name: q3.init_params(cfg, prng.PRNGKey(0), "cpu")
            for name, cfg in (("tiny", TINY), ("wide", WIDE))}


def _tokens(cfg, seq):
    return q3.batch_tokenize(TEXTS, cfg, seq_len=seq)


@pytest.fixture(scope="module")
def jax_vectors(tmp_path_factory):
    """JAX's ``encode`` of TEXTS on its own seeded weights (tiny and the 4b
    widths), computed with XLA's excess precision off."""
    tmp = tmp_path_factory.mktemp("qwen3")
    np.savez(tmp / "tokens.npz", tiny=_tokens(TINY, 32), wide=_tokens(WIDE, 16))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(tmp / "tokens.npz"),
                    str(tmp / "out.npz")], check=True, env=env, timeout=300)
    return dict(np.load(tmp / "out.npz"))


# -- test_qwen3.py's unsharded cases, restated on the port ---------------------
class TestQwen3Encode:
    def test_vector_contract_unit_norm(self):
        model = q3.init_params(TINY, prng.PRNGKey(0), "cpu")
        out = q3.encode(model, q3.batch_tokenize(["hello world", "other text entirely"], TINY))
        assert out.shape == (2, TINY.embed_dim)
        np.testing.assert_allclose(torch.linalg.vector_norm(out, dim=1).numpy(),
                                   1.0, atol=1e-3)

    def test_truncation_is_hidden_prefix(self):
        assert TINY.embed_dim < TINY.d_model  # 2560 -> 1024 shape contract

    def test_last_token_pooling_tracks_last_real_token(self):
        model = q3.init_params(TINY, prng.PRNGKey(0), "cpu")
        va = q3.encode(model, q3.batch_tokenize(["hello world"], TINY)).numpy()
        vb = q3.encode(model, q3.batch_tokenize(["hello world extra"], TINY)).numpy()
        assert not np.allclose(va, vb)

    def test_trailing_pad_invariance(self):
        """The pooled vector does not depend on the pad width (causal mask,
        last-token pooling): the same text at two sequence lengths."""
        model = q3.init_params(TINY, prng.PRNGKey(0), "cpu")
        va = q3.encode(model, q3.batch_tokenize(["one two three"], TINY, seq_len=16))
        vb = q3.encode(model, q3.batch_tokenize(["one two three"], TINY, seq_len=32))
        np.testing.assert_allclose(va.numpy(), vb.numpy(), atol=2e-2)

    def test_batch_independence(self):
        """Row i's embedding does not depend on the batch's other rows."""
        model = q3.init_params(TINY, prng.PRNGKey(0), "cpu")
        solo = q3.encode(model, q3.batch_tokenize(["target text here"], TINY))
        batch = q3.encode(model, q3.batch_tokenize(
            ["target text here", "noise row", "another noise row"], TINY))
        np.testing.assert_allclose(solo[0].numpy(), batch[0].numpy(), atol=2e-2)

    def test_param_count_4b_preset(self):
        cfg = q3.preset("4b")
        count = cfg.param_count()
        # Qwen3-4B is ~4.0B params (embedding 389M + 36 x ~101M)
        assert 3.8e9 < count < 4.3e9, count
        assert count == jq.preset("4b").param_count()

    def test_save_load_roundtrip(self, tmp_path):
        model = q3.init_params(TINY, prng.PRNGKey(0), "cpu")
        path = str(tmp_path / "q.npz")
        q3.save_params(path, model)
        restored, cfg = q3.load_params(path, "cpu")
        assert cfg == TINY
        tokens = q3.batch_tokenize(["round trip"], TINY)
        np.testing.assert_allclose(q3.encode(model, tokens).numpy(),
                                   q3.encode(restored, tokens).numpy(), atol=1e-6)


class TestQwen3Provider:
    def test_provider_registry_contract(self, port_store, monkeypatch):
        from cadence_rag_tpu_torch.embed import provider as prov

        monkeypatch.setattr(port_store, "embeddings_provider", "qwen3")
        monkeypatch.setattr(port_store, "embeddings_dim", TINY.embed_dim)
        monkeypatch.setattr(q3.Qwen3EmbeddingProvider, "_instance",
                            q3.Qwen3EmbeddingProvider(TINY))
        prov.reset_embed_cache()
        result = prov.embed_texts(["a first text", "a second text", "third"])
        assert np.asarray(result.vectors).shape == (3, TINY.embed_dim)
        assert result.model.startswith("qwen3-shaped-")

    def test_dim_mismatch_fails_at_startup(self, port_store, monkeypatch):
        monkeypatch.setattr(port_store, "embeddings_dim", TINY.embed_dim + 1)
        with pytest.raises(RuntimeError, match="EMBEDDINGS_DIM"):
            q3.Qwen3EmbeddingProvider(TINY)


# -- parity with the JAX package ---------------------------------------------
@pytest.mark.parametrize("name", ["tiny", "wide"])
def test_init_is_jax_init_bit_for_bit(models, name):
    """``wide``: the 4b widths at depth 2 with a 1024-row vocab."""
    cfg = {"tiny": TINY, "wide": WIDE}[name]
    jcfg = dataclasses.replace(jq.PRESETS["4b"], **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    want = jq.init_params(jcfg, jax.random.PRNGKey(0))
    model = models[name]
    assert [n for n, _ in model.named_parameters()] == [n for n, _, _ in q3._param_specs(cfg)]
    for name, param in model.named_parameters():
        w = want[name]
        assert param.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16 else torch.float32)
        np.testing.assert_array_equal(param.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)), err_msg=name)
    carried = q3.from_jax_params({n: np.asarray(a) for n, a in want.items()}, cfg, "cpu")
    for (name, a), (_, b) in zip(model.named_parameters(), carried.named_parameters()):
        assert torch.equal(a, b), name


def test_tiny_encode_matches_jax(models, jax_vectors):
    got = q3.encode(models["tiny"], _tokens(TINY, 32)).numpy()
    np.testing.assert_allclose(got, jax_vectors["tiny"], rtol=0, atol=TINY_ATOL)


def test_4b_widths_encode_matches_jax(models, jax_vectors):
    """head_dim 128, 32 query heads over 8 key/value heads, d_ff 9728, at
    depth 2 with a 1024-row vocab."""
    got = q3.encode(models["wide"], _tokens(WIDE, 16)).numpy()
    want = jax_vectors["wide"]
    assert got.shape == want.shape == (len(TEXTS), 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=WIDE_ATOL)
    assert (got * want).sum(axis=1).min() >= WIDE_MIN_COS


def test_in_process_jax_is_close(jax_vectors):
    """JAX in this process (excess precision on) is near both."""
    jparams = jq.init_params(TINY, jax.random.PRNGKey(0))
    here = np.asarray(jq.encode(jparams, jnp.asarray(_tokens(TINY, 32)), jq.PRESETS["tiny"]))
    assert (here * jax_vectors["tiny"]).sum(axis=1).min() > 0.999


def test_npz_files_load_in_both_packages(tmp_path):
    jparams = jq.init_params(jq.PRESETS["tiny"], jax.random.PRNGKey(3))
    jq.save_params(str(tmp_path / "jax.npz"), jparams, jq.PRESETS["tiny"])
    model = q3.init_params(TINY, prng.PRNGKey(3), "cpu")
    q3.save_params(str(tmp_path / "port.npz"), model)
    from_jax, cfg = q3.load_params(str(tmp_path / "jax.npz"), "cpu")
    jp, jcfg = jq.load_params(str(tmp_path / "port.npz"))
    assert cfg == TINY and jcfg == jq.PRESETS["tiny"]
    for name, param in from_jax.named_parameters():
        assert torch.equal(param, getattr(model, name)), name
        np.testing.assert_array_equal(np.asarray(jp[name].astype(jnp.float32)),
                                      param.float().numpy(), err_msg=name)
    a, b = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(a.files) == sorted(b.files)
    assert sorted(a["__bf16__"]) == sorted(b["__bf16__"])
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_provider_buckets_and_bpe(port_store, monkeypatch, tmp_path):
    """The provider pads each batch to ``min(pow2(longest, lo=16),
    max_len)`` and does not pad the batch; its vectors are ``encode``'s,
    rounded to bfloat16."""
    monkeypatch.setattr(port_store, "embeddings_dim", TINY.embed_dim)
    provider = q3.Qwen3EmbeddingProvider(TINY)
    assert provider.tokenize(["a b"]).shape == (1, 16)
    assert provider.tokenize(["w " * 17]).shape == (1, 32)
    assert provider.tokenize(["w " * 100, "x"]).shape == (2, 32)   # max_len
    texts = ["alpha beta", "gamma", "delta epsilon zeta"]
    got = provider.embed(texts)
    assert got.vectors.shape == (3, TINY.embed_dim)
    want = q3.encode(provider.model, q3.batch_tokenize(texts, TINY, seq_len=16))
    np.testing.assert_array_equal(got.vectors, want.to(torch.bfloat16).float().numpy())
    assert provider.model_id == "qwen3-shaped-64d2L-synthetic"
