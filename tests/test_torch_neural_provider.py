"""The tuned neural embedder as the dense provider, JAX package vs port, on
the CPU.

``tests/integration/test_neural_provider.py``'s three cases, restated on the
port's API (its loader takes a device): the committed artifact loads with its
frozen bag regenerated, the real gate with ``provider="neural"`` clears its
floors, and the tuned model beats the stub on dense-only paraphrase MRR.
Then the real gate's answers: the same ids for every gold query as the JAX
package's gate (both ingest under one fake clock), and the same metrics; and
``EMBEDDINGS_PROVIDER=neural`` with ``EMBEDDER_PARAMS_PATH`` starts and
serves through the port's router.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import BOTH, JAX, PORT, fake_clock, port_store, set_both  # noqa: F401

ARTIFACT = Path(__file__).resolve().parent.parent / "artifacts" / "embedder" / \
    "tuned_small_v1.npz"


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


def _gate_ids(pkg, monkeypatch, **kwargs):
    """``pkg``'s real gate with the ids of every gold query's answer."""
    metrics = sys.modules[f"{pkg.root}.evals.metrics"]
    seen = {}
    inner = metrics.compute_metrics

    def recording(gold, results, **kw):
        seen["results"] = results
        return inner(gold, results, **kw)

    monkeypatch.setattr(metrics, "compute_metrics", recording)
    monkeypatch.setattr(pkg.ingest, "now_utc", fake_clock())
    outcome = pkg.real_gate.run_gate(**kwargs)
    return outcome, seen["results"]


class TestCommittedArtifact:
    def test_artifact_loads_and_bag_regenerates(self):
        from cadence_rag_tpu_torch.models.embedder import load_params

        model, cfg = load_params(str(ARTIFACT), "cpu")
        assert cfg.use_bag and cfg.freeze_bag
        # the frozen bag is not stored; it regenerates from (cfg, seed)
        assert "['bag_emb']" not in np.load(ARTIFACT).files
        assert tuple(model.bag_emb.shape) == (cfg.vocab_buckets, cfg.embed_dim)
        assert cfg.embed_dim == 1024

    def test_real_gate_passes_with_neural_artifact(self, port_tmp_store, monkeypatch):
        """The end-to-end gate (all lanes fused) clears the reference floors
        with provider=neural and the committed weights."""
        from cadence_rag_tpu_torch.evals.real_gate import run_gate

        monkeypatch.setattr(port_tmp_store, "embeddings_dim", 1024)
        outcome = run_gate(device="cpu", provider="neural",
                           embedder_params_path=str(ARTIFACT))
        assert outcome["failures"] == [], outcome

    def test_artifact_paraphrase_beats_stub_dense_only(self, port_tmp_store):
        """Dense lane only: the tuned model beats the stub on register
        paraphrase, over the held-out eval combos."""
        from cadence_rag_tpu_torch.embed.stub import HashEmbeddingProvider
        from cadence_rag_tpu_torch.evals.train_corpus import (
            EVENTS, generate_calls, train_eval_split,
        )
        from cadence_rag_tpu_torch.models.embedder import (
            batch_tokenize, encode, load_params,
        )

        _, eval_combos = train_eval_split(seed=0)
        docs, gold_sets, queries = [], [], []
        rng = np.random.default_rng(3)
        for call in generate_calls(eval_combos, seed=1):
            phr = EVENTS[call.event]["summary"]
            queries.append(phr[int(rng.integers(0, len(phr)))].format(svc=call.service))
            gold = set()
            for text in call.transcript:
                if call.service in text:
                    gold.add(len(docs))
                docs.append(text)
            gold_sets.append(gold)
        model, cfg = load_params(str(ARTIFACT), "cpu")
        stub = HashEmbeddingProvider()

        def mrr(embed_fn):
            ranks = np.argsort(-(embed_fn(queries) @ embed_fn(docs).T), axis=1)
            total = 0.0
            for qi, gold in enumerate(gold_sets):
                for rank, di in enumerate(ranks[qi], start=1):
                    if di in gold:
                        total += 1.0 / rank
                        break
            return total / len(gold_sets)

        neural_mrr = mrr(lambda t: encode(model, batch_tokenize(t, cfg)).numpy())
        stub_mrr = mrr(lambda t: np.asarray(stub.embed(t).vectors))
        assert neural_mrr > stub_mrr + 0.05, (neural_mrr, stub_mrr)


def test_neural_real_gate_matches_jax(port_store, tmp_path, monkeypatch, set_both):
    """Both packages' real gates with the committed embedder: every gold
    query's answer is the same list of ids, and the metrics are equal."""
    set_both("embeddings_dim", 1024)
    got = {}
    for pkg in BOTH:
        kwargs = {"device": "cpu"} if pkg is PORT else {}
        got[pkg.root] = _gate_ids(
            pkg, monkeypatch, store_dir=str(tmp_path / pkg.root), provider="neural",
            embedder_params_path=str(ARTIFACT), **kwargs)
    (port, port_ids), (jax, jax_ids) = got[PORT.root], got[JAX.root]
    assert port_ids == jax_ids and len(port_ids) >= 10
    assert port["metrics"] == jax["metrics"]
    assert not port["failures"]


def test_neural_provider_serves_through_the_router(port_store, monkeypatch):
    """``EMBEDDINGS_PROVIDER=neural`` with ``EMBEDDER_PARAMS_PATH``: startup
    takes it and the router's /retrieve answers from the tuned model's dense
    lane, with the JAX package's ids."""
    from cadence_rag_tpu_torch.evals.fixtures import ingest_fixtures
    from cadence_rag_tpu_torch.models.embedder import NeuralEmbeddingProvider
    from cadence_rag_tpu_torch.serve.testing import TestClient

    for name, value in (("embeddings_provider", "neural"), ("embeddings_dim", 1024),
                        ("embedder_params_path", str(ARTIFACT)),
                        ("store_sync_interval_s", 0.0)):
        monkeypatch.setattr(port_store, name, value)
    monkeypatch.setattr(NeuralEmbeddingProvider, "_instance", None)
    PORT.index.reset_index()
    client = TestClient(device="cpu")
    ingest_fixtures()
    PORT.pipeline.run_embedding_backfill(batch_size=16)
    resp = client.post("/retrieve", json={
        "query": "the downgrade fixed the connection resets", "debug": True})
    assert resp.status_code == 200
    body = resp.json()
    notes = body["notes"]["retrieval"]
    assert notes["dense_model_id"] == "cadence-neural-embedder-128d2L-tuned"
    assert notes["dense_error"] is None and body["quotes"]
    assert body["debug"]["lanes"]["chunks"]["dense"]
    assert NeuralEmbeddingProvider.shared().device.type == "cpu"
