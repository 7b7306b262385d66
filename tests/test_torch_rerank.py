"""The rerank lane and the eval CLIs, JAX package vs port, on the CPU.

``tests/integration/test_rerank.py`` (its neural provider's case included)
and ``tests/integration/test_eval_gate.py`` run against the port as they
stand (``torch_parity.mirror_tests``; the real gate is asked for the CPU).
Then the same corpus and requests go through both packages with
``RERANK_ENABLED``: responses identical (debug lane scores within 1e-5),
with the lexical provider and with both neural ones over the committed
``two_register_v1.npz``; ``_lexical_scores`` and ``prior_for_texts`` equal
within 1e-5 on the same seeded inputs; the real gate's metrics identical
with each provider.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import (
    BOTH,
    JAX,
    PORT,
    assert_same_response,
    fake_clock,
    ingest_corpus,
    mirror_tests,
    port_store,  # noqa: F401  (fixture)
    request_bodies,
    set_both,  # noqa: F401  (fixture)
)

SCORE_ATOL = 1e-5
TWO_REGISTER = str(Path(__file__).resolve().parent.parent / "artifacts" /
                   "reranker" / "two_register_v1.npz")
GATE_ON_CPU = ((r"\brun_gate\(", 'run_gate(device="cpu", '),)


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_tests(globals(), "rerank", "integration/test_rerank.py",
             rewrites=GATE_ON_CPU)
mirror_tests(globals(), "eval_gate", "integration/test_eval_gate.py",
             rewrites=GATE_ON_CPU)


def test_the_mirrored_tests_ran_against_the_port():
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence
    from cadence_rag_tpu_torch.evals.real_gate import run_gate

    assert sys.modules[f"{__name__}.rerank"].retrieve_evidence is retrieve_evidence
    assert sys.modules[f"{__name__}.eval_gate"].run_gate is run_gate


@pytest.mark.parametrize("provider", ["neural", "neural_raw"])
def test_neural_providers_raise(port_store, set_both, provider, monkeypatch):
    """The cross-encoder is ported, so neither neural provider raises any
    more: with the committed ``two_register_v1.npz`` both rerank as the JAX
    package's do, in ``rerank`` (the same order), in the engine (the same
    responses), at startup and in the real gate (the same metrics)."""
    from cadence_rag_tpu.models.reranker import NeuralReranker as JaxReranker
    from cadence_rag_tpu_torch.models.reranker import NeuralReranker

    for pkg in BOTH:
        monkeypatch.setattr(pkg.ingest, "now_utc", fake_clock())
    calls = {pkg.root: ingest_corpus(pkg) for pkg in BOTH}
    set_both("reranker_params_path", TWO_REGISTER)
    for cls in (JaxReranker, NeuralReranker):
        monkeypatch.setattr(cls, "_instance", None)
    ranked = [(i, {"lex"}, 1.0 / (60 + i)) for i in range(1, 12)]
    doc_freq = np.ones(1024, np.int64)
    out = [pkg.rerank.rerank("ECONNRESET object store gateway", list(ranked),
                             "chunks", doc_freq, 11, topk=9, provider=provider)
           for pkg in BOTH]
    assert out[0] == out[1] and out[1][9:] == ranked[9:]
    set_both("rerank_enabled", True)
    set_both("rerank_provider", provider)
    for name in ("pack", "debug", "limits", "budget"):
        body = request_bodies(calls[JAX.root])[name]
        got = PORT.retrieve.retrieve_evidence(PORT.request(body))
        want = JAX.retrieve.retrieve_evidence(JAX.request(body))
        assert_same_response(got, want)
        assert got["notes"]["retrieval"]["reranked_from"] >= 1, name
    PORT.api.startup("cpu")
    assert NeuralReranker.shared().device.type == "cpu"
    gates = {}
    for pkg in BOTH:
        monkeypatch.setattr(pkg.ingest, "now_utc", fake_clock())
        kwargs = {"device": "cpu"} if pkg is PORT else {}
        gates[pkg.root] = pkg.real_gate.run_gate(
            rerank_provider=provider, reranker_params_path=TWO_REGISTER, **kwargs)
    assert not gates[PORT.root]["failures"]
    assert gates[PORT.root]["metrics"] == gates[JAX.root]["metrics"]


def test_reranked_responses_match(port_store, set_both):
    """Every request shape with the rerank lane on: the port's responses
    are the JAX package's, ``reranked_from`` included."""
    calls = {pkg.root: ingest_corpus(pkg) for pkg in BOTH}
    set_both("rerank_enabled", True)
    set_both("rerank_provider", "lexical")
    reranked = 0
    for name, body in request_bodies(calls[JAX.root]).items():
        port_body = json.loads(json.dumps(body))
        ids = port_body.get("filters", {}).get("call_ids")
        if ids:
            ext = JAX.call_ext()
            port_body["filters"]["call_ids"] = [
                calls[PORT.root][ext[i]] for i in ids]
        got = PORT.retrieve.retrieve_evidence(PORT.request(port_body))
        want = JAX.retrieve.retrieve_evidence(JAX.request(body))
        assert_same_response(got, want)
        notes = got.get("notes", {}).get("retrieval")
        if notes and notes.get("reranked_from"):
            reranked += 1
            assert "rerank_ms" in notes["timings_ms"], name
    assert reranked >= 5
    # the batched path (ids_only: the native fast path stands down)
    bodies = [{"query": q, "return_style": "ids_only"} for q in
              ("ECONNRESET object store", "kafka consumer lag", "lenovo BOM")]
    got = PORT.retrieve.retrieve_evidence_batch([PORT.request(b) for b in bodies])
    want = JAX.retrieve.retrieve_evidence_batch([JAX.request(b) for b in bodies])
    assert [r["retrieved_ids"] for r in got] == [r["retrieved_ids"] for r in want]


def test_lexical_scores_and_prior_match(port_store):
    """``_lexical_scores`` over the stored signatures and ``prior_for_texts``
    over raw text: the same floats in both packages (within 1e-5)."""
    for pkg in BOTH:
        ingest_corpus(pkg)
    rng = np.random.default_rng(5)
    doc_freq = rng.integers(0, 9, size=1024).astype(np.int64)
    ids = list(range(1, 12)) + [999]
    for query in ("ECONNRESET object store gateway", "kafka broker-7 v3.2.1", ""):
        got = PORT.rerank._lexical_scores(
            query, "chunks", "chunk_id", "text", ids, doc_freq, 11)
        want = JAX.rerank._lexical_scores(
            query, "chunks", "chunk_id", "text", ids, doc_freq, 11)
        assert got.keys() == want.keys() and len(got) >= 8
        for doc_id in want:
            assert abs(got[doc_id] - want[doc_id]) <= SCORE_ATOL
        texts = ["the ECONNRESET fix v2.3.1", "kafka lag on broker-7", "nothing"]
        np.testing.assert_allclose(
            PORT.rerank.prior_for_texts(query, texts, doc_freq, 11),
            JAX.rerank.prior_for_texts(query, texts, doc_freq, 11),
            rtol=0, atol=SCORE_ATOL)
    assert PORT.rerank.prior_for_texts("q", [], doc_freq, 11).shape == (0,)
    np.testing.assert_array_equal(
        PORT.featurize.query_lexical_vector("object store SSD", doc_freq, 11),
        JAX.featurize.query_lexical_vector("object store SSD", doc_freq, 11))


def test_rerank_keeps_the_rrf_ladder_and_the_tail(port_store):
    """The rerank order is applied to the head, the descending RRF scores
    stay where they were and the tail keeps its order, in both packages."""
    for pkg in BOTH:
        ingest_corpus(pkg)
    ranked = [(i, {"lex"}, 1.0 / (60 + i)) for i in range(1, 11)]
    doc_freq = np.ones(1024, np.int64)
    out = [pkg.rerank.rerank("ECONNRESET object store", list(ranked), "chunks",
                             doc_freq, 10, topk=6, provider="lexical")
           for pkg in BOTH]
    assert out[0] == out[1]
    assert [s for _d, _l, s in out[1]] == [s for _d, _l, s in ranked]
    assert out[1][6:] == ranked[6:]
    assert sorted(d for d, _l, _s in out[1][:6]) == [1, 2, 3, 4, 5, 6]
    assert PORT.rerank.rerank("q", [], "chunks", doc_freq, 1, topk=5,
                              provider="lexical") == []


def test_real_gate_with_lexical_rerank_matches(port_store, tmp_path, monkeypatch):
    """The real gate with ``rerank_provider="lexical"``: the port passes its
    floors with the JAX package's metrics."""
    outcomes = {}
    for pkg in BOTH:
        monkeypatch.setattr(sys.modules[f"{pkg.root}.ingest.ingest"], "now_utc",
                            fake_clock())
        kwargs = {"device": "cpu"} if pkg is PORT else {}
        outcomes[pkg.root] = pkg.real_gate.run_gate(
            store_dir=str(tmp_path / pkg.root), rerank_provider="lexical",
            **kwargs)
    got, want = outcomes[PORT.root], outcomes[JAX.root]
    assert not got["failures"], got
    assert got["metrics"] == want["metrics"]
    assert port_store.rerank_enabled is False      # restored by the gate


@pytest.mark.parametrize("cli", ["gate", "run_eval"])
def test_eval_clis_match_on_the_sample_files(cli, capsys, monkeypatch):
    """``evals/gate.py`` and ``evals/run_eval.py`` over the sample JSONL
    files each package ships: the same output."""
    import importlib

    outs = []
    for pkg in BOTH:
        mod = importlib.import_module(f"{pkg.root}.evals.{cli}")
        data = importlib.import_module(f"{pkg.root}.evals").__path__[0] + "/data"
        monkeypatch.setattr(sys, "argv", [
            cli, "--gold", f"{data}/gold_sample.jsonl",
            "--results", f"{data}/results_sample.jsonl"])
        try:
            mod.main()
            code = 0
        except SystemExit as exc:
            code = exc.code
        outs.append((code, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0][1]
