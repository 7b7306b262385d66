"""The geometry gate (``evals/geometry_gate.py``) against the JAX package's,
on the CPU.

- ``tests/kernels/test_geometry_gate.py``'s two cases restated on the port;
- on the same arrays, the int8 gate (``int8_recall``, ``int8_eps_recall``
  and the score loss) equals the JAX package's: both score
  ``round(x * 127)`` rows with the query rounded to bf16 and rank with
  ``lax.top_k``'s tie order against the exact f32 ranking (no tie was taken
  in another order on these corpora);
- the port's ``ann`` is kernel K1's dense lane (its plain version on the
  CPU) over bf16 rows, held to the floor 0.95 against the exact scan of the
  same rows; the JAX gate's ``approx_max_k`` is exact on the CPU, so its
  recall is 1.0 there and is not compared;
- the corpus generator and the cached tokenizer give the JAX package's
  texts and ``batch_tokenize``'s ids;
- the default source end to end at a small n: the committed embedder's
  vectors through all three gates.
"""

from pathlib import Path

import numpy as np
import pytest

from cadence_rag_tpu.evals import geometry_gate as jgeo
from cadence_rag_tpu_torch.evals import geometry_gate as geo
from cadence_rag_tpu_torch.models import embedder as emb
from torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

EMBEDDER = str(Path(__file__).resolve().parent.parent / "artifacts" / "embedder"
               / "tuned_small_v1.npz")
MIN_ANN = 0.95
INT8_KEYS = ("int8_recall", "int8_eps_recall", "int8_score_loss_mean",
             "int8_score_loss_p99")


def _clustered_corpus(n=4096, dim=128, clusters=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, clusters, n)
    docs = centers[assign] + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    pick = rng.choice(n, 32, replace=False)
    queries = docs[pick] + 0.02 * rng.standard_normal((32, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return docs.astype(np.float32), queries.astype(np.float32)


# -- tests/kernels/test_geometry_gate.py ---------------------------------------------
def test_run_gates_small():
    docs, queries = _clustered_corpus()
    out = geo.run_gates(docs, queries, k=10, recall_target=0.95, skip_ivf=True,
                        device="cpu")
    assert out["n"] == docs.shape[0]
    assert out["ann_recall"] >= 0.9, out
    assert out["int8_eps_recall"] >= out["int8_recall"] - 1e-9, out
    assert out["int8_eps_recall"] >= 0.99, out
    assert out["int8_score_loss_p99"] <= 2e-2, out


def test_eps_recall_tightens_with_smaller_eps():
    docs, queries = _clustered_corpus(seed=1)
    wide = geo.run_gates(docs, queries, k=10, recall_target=0.95, skip_ivf=True,
                         int8_eps=1e-2, device="cpu")
    tight = geo.run_gates(docs, queries, k=10, recall_target=0.95, skip_ivf=True,
                          int8_eps=1e-6, device="cpu")
    assert tight["int8_eps_recall"] <= wide["int8_eps_recall"] + 1e-9


# -- against the JAX package ----------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("int8_eps", [1e-2, 1e-6])
def test_int8_gate_identical_to_jax(seed, int8_eps):
    docs, queries = _clustered_corpus(seed=seed)
    kw = dict(k=10, recall_target=0.95, skip_ivf=True, int8_eps=int8_eps)
    want = jgeo.run_gates(docs, queries, **kw)
    got = geo.run_gates(docs, queries, device="cpu", **kw)
    assert {k: got[k] for k in INT8_KEYS} == {k: want[k] for k in INT8_KEYS}
    for key in ("n", "dim", "k", "queries", "recall_target", "int8_eps"):
        assert got[key] == want[key], key
    # K1's dense lane over the bf16 rows
    assert got["ann_recall"] >= MIN_ANN and got["ann_recall_f32"] >= MIN_ANN - 0.02


def test_ivf_gate_runs_over_the_threshold():
    docs, queries = _clustered_corpus(n=20_000, seed=3)
    out = geo.run_gates(docs, queries, k=10, recall_target=0.95, ivf_min=10_000,
                        device="cpu")
    assert out["ivf_clusters"] == 141 and out["ivf_nprobe"] == 11
    assert out["ivf_recall"] >= 0.9, out
    assert 0 < out["ivf_candidate_frac"] < 0.5


def test_corpus_and_tokens_are_the_jax_packages():
    docs, paras = geo.corpus_texts(500, 4)
    assert (docs, paras) == jgeo._corpus_texts(500, 4)
    cfg = emb.EmbedderConfig(vocab_buckets=16384, max_len=12)
    cache = {}
    np.testing.assert_array_equal(geo.tokenize_cached(docs + ["", "A  b"], cfg, cache),
                                  emb.batch_tokenize(docs + ["", "A  b"], cfg))
    assert len(cache) < 3000      # every distinct word hashed once


def test_default_source_end_to_end():
    timings = {}
    docs, queries = geo.embedder_geometry(3000, 64, 0, EMBEDDER, "cpu", timings)
    assert tuple(docs.shape) == (3000, 1024) and tuple(queries.shape) == (64, 1024)
    np.testing.assert_allclose(docs.norm(dim=1).numpy(), 1.0, atol=1e-5)
    out = geo.run_gates(docs, queries, k=10, recall_target=0.95, ivf_min=2000,
                        device="cpu")
    assert out["ann_recall"] >= MIN_ANN, out
    assert out["int8_recall"] >= 0.90 or out["int8_eps_recall"] >= 0.99, out
    assert "ivf_recall" in out and timings["texts_per_s"] > 0
