"""The models' eval harnesses, JAX package vs port, on the CPU.

The rerank gate over the committed ``two_register_v1.npz`` gives the JAX
package's MRRs over its curated candidate sets and its fixture metrics
exactly (the port's cross-encoder scores within 1e-5 of XLA's, far inside
the gaps between them). Its end-to-end MRRs through ``/retrieve`` agree
within ``E2E_MRR_ATOL``: the port's lexical lane keeps kernel K1's one
winner per 8-row group and orders exact ties by group, as the Pallas
kernel's ``pallas_fused_topk`` does, where the JAX package's served lane
(``approx_max_k``, exact on the CPU) keeps every row and orders ties by
row. The paraphrase corpus is full of tied summaries, so a few of the 24
answers differ in their tail.
Without ``params_path`` the gate trains first (the training item, held to
the JAX package's in ``test_torch_training_gates.py``). The Qwen3 harnesses (``qwen3_bench``,
``qwen3_coresident_bench``) run end to end at the tiny preset on the CPU
and default to the card.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from torch_parity import BOTH, JAX, PORT, fake_clock, port_store  # noqa: F401

TWO_REGISTER = str(Path(__file__).resolve().parent.parent / "artifacts" /
                   "reranker" / "two_register_v1.npz")
EXACT_KEYS = ("queries", "shuffled_mrr", "lexical_mrr", "neural_mrr", "hybrid_mrr",
              "fixture_metrics", "failures")
E2E_KEYS = ("e2e_off_mrr", "e2e_lexical_mrr", "e2e_neural_mrr")
E2E_MRR_ATOL = 0.02


def test_rerank_gate_over_the_committed_artifact_matches_jax(port_store, monkeypatch):
    outcomes = {}
    for pkg in BOTH:
        gate = __import__(f"{pkg.root}.evals.rerank_gate", fromlist=["run_gate"])
        monkeypatch.setattr(pkg.ingest, "now_utc", fake_clock())
        kwargs = {"device": "cpu"} if pkg is PORT else {}
        outcomes[pkg.root] = gate.run_gate(params_path=TWO_REGISTER, **kwargs)
    port, jax = outcomes[PORT.root], outcomes[JAX.root]
    assert {k: port[k] for k in EXACT_KEYS} == {k: jax[k] for k in EXACT_KEYS}
    for key in E2E_KEYS:
        assert port[key] == pytest.approx(jax[key], abs=E2E_MRR_ATOL), key
    assert port["failures"] == [] and port["queries"] > 0
    assert port["neural_mrr"] > port["lexical_mrr"] + 0.10


def test_rerank_gate_without_params_names_the_training_item(port_store):
    """Without ``params_path`` the gate no longer refuses, naming the
    training item: it builds the relevance triples and trains."""
    from cadence_rag_tpu_torch.evals.rerank_gate import run_gate

    outcome = run_gate(device="cpu", steps=2, fixture_phase=False, min_margin=-1.0,
                       min_mrr=0.0)
    assert outcome["triples"] > 100 and outcome["final_loss"] is not None
    assert outcome["two_register"] and outcome["queries"] > 0


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_qwen3_bench_runs_the_tiny_preset(capsys):
    from cadence_rag_tpu_torch.evals import qwen3_bench

    qwen3_bench.run("tiny", [(2, 16), (3, 32)], 2, device="cpu")
    head, *rows = _json_lines(capsys)
    assert head["preset"] == "tiny" and head["device"] == "cpu"
    assert [(r["batch"], r["seq"], r["out_dim"]) for r in rows] == [(2, 16, 32),
                                                                    (3, 32, 32)]


def test_qwen3_coresident_bench_serves_the_tiny_preset(port_store, monkeypatch, capsys):
    from cadence_rag_tpu_torch.evals import qwen3_coresident_bench as bench
    from cadence_rag_tpu_torch.models.qwen3 import Qwen3EmbeddingProvider

    monkeypatch.setattr(Qwen3EmbeddingProvider, "_instance", None)
    monkeypatch.setattr(sys, "argv", ["bench", "--n", "4096", "--batch", "8",
                                      "--iters", "2", "--preset", "tiny",
                                      "--lex-dim", "256", "--device", "cpu"])
    bench.main()
    *phases, result = _json_lines(capsys)
    assert [p["phase"] for p in phases] == ["qwen3_init", "index_populate",
                                            "first_batch"]
    assert result["model"] == "qwen3-shaped-64d2L-synthetic"
    assert result["device"] == "cpu" and result["peak_allocated_gb"] is None
    assert result["value"] > 0 and result["iters"] == 2


@pytest.mark.parametrize("module", ["qwen3_bench", "qwen3_coresident_bench",
                                    "rerank_gate"])
def test_model_harnesses_default_to_the_card(monkeypatch, module):
    """Each harness's ``--device`` defaults to ``cuda`` and raises without a
    card, before any work."""
    harness = __import__(f"cadence_rag_tpu_torch.evals.{module}", fromlist=["main"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["harness", "--params", TWO_REGISTER] if module == "rerank_gate" else ["harness"]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        harness.main()
