"""``models/prng.py`` against ``jax.random`` (threefry2x32, partitionable).

Keys, splits and 32-bit words: bit-identical, for several seeds (one above
2**32, which JAX's 32-bit mode takes mod 2**32) and odd and 3-D shapes.
Uniforms (f32 and bf16): bit-identical. The f32 normal: within
F32_NORMAL_ATOL (XLA's erfinv polynomial is ported; ``log1p`` is torch's and
may differ from XLA's in the last bit). The bf16 normal: all 128 values it
can take, bit-identical, and a scaled draw as ``jax.jit`` makes it. The
tuned embedder artifact's frozen bag, regenerated: within F32_NORMAL_ATOL of
the JAX package's ``load_params``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.models import prng

F32_NORMAL_ATOL = 2e-6
SEEDS = [0, 1, 42, 2**31 + 3, 2**32 + 5]
SHAPES = [(5,), (3, 7, 11), (1000,), (2, 1, 9)]
ARTIFACT = Path(__file__).resolve().parent.parent / "artifacts" / "embedder" / \
    "tuned_small_v1.npz"


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_are_jax_bits(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    for num in (2, 3, 7, (2, 3)):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _u32(jax.random.split(jk, num)))
    # a split of a split, as the models' init walks its keys
    np.testing.assert_array_equal(
        prng.split(prng.split(tk, 4)[3], 6).numpy(),
        _u32(jax.random.split(jax.random.split(jk, 4)[3], 6)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_are_jax_bits(seed, shape):
    np.testing.assert_array_equal(
        prng.bits(prng.PRNGKey(seed), shape).numpy(),
        _u32(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_uniform_is_jax_uniform(seed, dtype):
    want = jax.random.uniform(jax.random.PRNGKey(seed), (3, 333),
                              getattr(jnp, dtype), -0.5, 2.0)
    got = prng.uniform(prng.PRNGKey(seed), (3, 333), getattr(torch, dtype),
                       -0.5, 2.0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_f32_normal_within_tolerance(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (512, 1024)))
    got = prng.normal(prng.PRNGKey(seed), (512, 1024)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_NORMAL_ATOL)
    # most values are the same float
    assert (got == want).mean() > 0.9


def test_f32_normal_in_chunks_is_the_same_draw(monkeypatch):
    whole = prng.normal(prng.PRNGKey(3), (7, 333))
    monkeypatch.setattr(prng, "CHUNK", 100)
    np.testing.assert_array_equal(prng.normal(prng.PRNGKey(3), (7, 333)).numpy(),
                                  whole.numpy())


def test_bf16_normal_takes_jaxs_128_values():
    """A bf16 normal reads 8 random bits (7 of them reach the mantissa): its
    128 values, each checked against the draw JAX makes from the same
    bits."""
    key = jax.random.PRNGKey(11)
    n = 20000
    raw = _u32(jax.random.bits(key, (n,), jnp.uint32))
    want = np.asarray(jax.random.normal(key, (n,), jnp.bfloat16).astype(jnp.float32))
    table = prng.bf16_normal_table().float().numpy()
    idx = (raw & 0xFF) >> 1
    assert len(np.unique(idx)) == 128
    np.testing.assert_array_equal(table[idx], want)
    got = prng.normal(prng.PRNGKey(11), (n,), torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("scale", [0.0123, 1 / np.sqrt(2560), 1 / np.sqrt(151936)])
def test_scaled_bf16_normal_matches_jit(scale):
    """``normal(bf16) * scale`` as the Qwen3 init makes it under jit."""
    key = jax.random.PRNGKey(2)
    fn = jax.jit(lambda k: jax.random.normal(k, (40, 250), dtype=jnp.bfloat16)
                 * float(scale))
    got = prng.normal(prng.PRNGKey(2), (40, 250), torch.bfloat16,
                      scale=float(scale))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(fn(key).astype(jnp.float32)))


def test_normal_into_out_tensor():
    out = torch.empty(4, 9, dtype=torch.bfloat16)
    assert prng.normal(prng.PRNGKey(1), (4, 9), out=out) is out
    np.testing.assert_array_equal(
        out.float().numpy(),
        prng.normal(prng.PRNGKey(1), (4, 9), torch.bfloat16).float().numpy())
    with pytest.raises(ValueError, match="shape"):
        prng.normal(prng.PRNGKey(1), (4, 8), out=out)


def test_erfinv_edges():
    x = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0])
    got = prng.erfinv_f32(x)
    assert got[0] == -np.inf and got[-1] == np.inf and got[2] == 0
    np.testing.assert_allclose(got[1:4].numpy(),
                               torch.erfinv(x[1:4]).numpy(), atol=1e-6)


def test_artifact_bag_regenerates_as_in_jax():
    from cadence_rag_tpu.models.embedder import load_params as jload
    from cadence_rag_tpu_torch.models.embedder import load_params as tload

    jparams, jcfg = jload(str(ARTIFACT))
    model, cfg = tload(str(ARTIFACT), "cpu")
    assert "['bag_emb']" not in np.load(ARTIFACT).files
    want = np.asarray(jparams["bag_emb"])
    got = model.bag_emb.numpy()
    assert got.shape == want.shape == (cfg.vocab_buckets, cfg.embed_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_NORMAL_ATOL)
