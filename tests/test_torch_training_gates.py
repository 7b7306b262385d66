"""The training gates (``evals/paraphrase_gate.py``, ``evals/rerank_gate.py``'s
training branch) in both packages on the CPU, at a reduced step count.

Each gate builds the same store from the paraphrase corpus (the same call
ids, one clock), curates the same
training data (pairs and negatives, relevance and teacher triples: held bit
for bit in ``test_torch_train_scripts.py``) and draws the same batches from
the same seeded initial weights. The packages then train apart by bf16
roundings of the gradients (``test_torch_training.py``), so the trained
models' metrics agree within a band, not exactly:

- the paraphrase gate at one step: the corpus counts and the stub's MRR
  identical; the step's loss (the seeded initial weights on the first
  batch) within LOSS_ATOL (read: 3.1e-4 of 6.87: temperature 0.05 scales
  the vectors' bf16 differences by 20) and the tuned MRR within
  PARAPHRASE_MRR_BAND (read: identical). Longer runs part: at 600 steps and
  1024-d vectors the JAX package read 0.5343 and the port 0.6653 on the
  CPU, from the same data and batches;
- the rerank gate's two-register training: the triple and query counts,
  the shuffled and lexical MRRs identical; the neural and hybrid MRRs
  within RERANK_MRR_BAND at RERANK_STEPS steps; the end-to-end MRRs within
  the served lane's E2E_MRR_ATOL (``test_torch_model_evals.py``: K1 orders
  exact lexical ties by group);
- JAX's ``test_training_path_smoke`` (``tests/integration/
  test_rerank_gate.py``) restated on the port.
"""

import itertools
import uuid

import pytest

from torch_parity import BOTH, JAX, PORT, fake_clock, one_thread, port_store  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

PARAPHRASE_STEPS = 1
PARAPHRASE_MRR_BAND = 0.02
LOSS_ATOL = 1e-3
RERANK_STEPS = 60
RERANK_MRR_BAND = 0.08
E2E_MRR_ATOL = 0.02


def _gate(pkg, name):
    return __import__(f"{pkg.root}.evals.{name}", fromlist=["run_gate"]).run_gate


def _run_both(name, monkeypatch, **kwargs):
    outcomes = {}
    for pkg in BOTH:
        monkeypatch.setattr(pkg.ingest, "now_utc", fake_clock())
        # the same call ids: the pairs are read in call id order
        ids = itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
        extra = {"device": "cpu"} if pkg is PORT else {}
        outcomes[pkg.root] = _gate(pkg, name)(**kwargs, **extra)
    return outcomes[PORT.root], outcomes[JAX.root]


def test_paraphrase_gate_matches_jax(port_store, monkeypatch):
    port, jax = _run_both("paraphrase_gate", monkeypatch, steps=PARAPHRASE_STEPS)
    for key in ("queries", "train_calls", "eval_calls", "train_pairs", "stub_mrr"):
        assert port[key] == jax[key], key
    assert port["neural_mrr"] == pytest.approx(jax["neural_mrr"], abs=PARAPHRASE_MRR_BAND)
    assert port["final_loss"] == pytest.approx(jax["final_loss"], abs=LOSS_ATOL)
    assert 0.0 < port["neural_mrr"] <= 1.0


def test_rerank_gate_training_matches_jax(port_store, monkeypatch):
    port, jax = _run_both("rerank_gate", monkeypatch, steps=RERANK_STEPS,
                          min_margin=-1.0, min_mrr=0.0, fixture_phase=False)
    for key in ("queries", "triples", "shuffled_mrr", "lexical_mrr", "two_register"):
        assert port[key] == jax[key], key
    for key in ("neural_mrr", "hybrid_mrr"):
        assert port[key] == pytest.approx(jax[key], abs=RERANK_MRR_BAND), key
    for key in ("e2e_off_mrr", "e2e_lexical_mrr"):
        assert port[key] == pytest.approx(jax[key], abs=E2E_MRR_ATOL), key
    assert port["e2e_neural_mrr"] == pytest.approx(
        jax["e2e_neural_mrr"], abs=E2E_MRR_ATOL + RERANK_MRR_BAND)


def test_training_path_smoke(port_store):
    """``tests/integration/test_rerank_gate.py::test_training_path_smoke``:
    triples build, two-register training runs, eval produces MRRs."""
    from cadence_rag_tpu_torch.evals.rerank_gate import run_gate

    outcome = run_gate(device="cpu", steps=60, min_margin=-1.0, min_mrr=0.0,
                       fixture_phase=False)
    assert outcome["triples"] > 100
    assert outcome["queries"] > 10
    assert 0.0 <= outcome["neural_mrr"] <= 1.0
    assert outcome["final_loss"] is not None
