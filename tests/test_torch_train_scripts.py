"""The training scripts (``scripts/train_embedder.py``,
``scripts/train_reranker.py``) against the JAX package's, on the CPU.

- ``tests/integration/test_train_script.py`` and
  ``tests/integration/test_rerank_distill.py`` restated on the port (their
  calls name the CPU: the port's scripts train on the card by default);
- the host data both packages train from, on one corpus ingested into each
  package's store under the same call ids (the pairs are read in call id
  order, and the ingest draws uuid4s): ``corpus_pairs``,
  ``mine_hard_negatives``, ``build_triples`` and ``attach_priors`` give the
  same texts, in the same order, and the same priors, bit for bit;
- ``train_embedder --device cuda`` without a card raises before it reads
  the store.
"""

import itertools
import sys
import uuid

import numpy as np
import pytest

from torch_parity import BOTH, JAX, PORT, one_thread, port_store  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TRAIN_TEXTS = [
    f"utterance {i} about the object store and ECONNRESET retries "
    f"with tiering to SSD and version v2.{i}.0 on the cluster"
    for i in range(24)
]
TOPICS = [
    "object store tiering to SSD cut the tail latency",
    "ECONNRESET storm traced to the gateway upgrade",
    "lenovo BOM finalized before the dell bake-off",
    "azure migration needs private endpoints for cutover",
    "certificate expiry caused the HTTP 503 errors",
    "quota exhaustion throttled the export pipeline",
]


def _ingest_training_corpus(pkg):
    s = pkg.schemas
    pkg.ingest.ingest_transcript(
        s.CallRef(external_id="train-1"),
        [s.UtteranceIn(speaker="A", start_ts_ms=i * 1000, end_ts_ms=i * 1000 + 900,
                       text=t) for i, t in enumerate(TRAIN_TEXTS)],
        s.ChunkingOptions(target_tokens=15, max_tokens=30, overlap_tokens=0),
    )


def _ingest_distill_corpus(pkg):
    s = pkg.schemas
    for c in range(6):
        texts = [
            f"{TOPICS[(c + j) % len(TOPICS)]} variant {c}-{j} with "
            f"v{c}.{j}.0 details"
            for j in range(4)
        ]
        pkg.ingest.ingest_transcript(
            s.CallRef(external_id=f"rr-{c}"),
            [s.UtteranceIn(speaker="A", start_ts_ms=j * 1000,
                           end_ts_ms=j * 1000 + 900, text=t)
             for j, t in enumerate(texts)],
            s.ChunkingOptions(target_tokens=12, max_tokens=30, overlap_tokens=0),
        )
    pkg.pipeline.run_embedding_backfill(batch_size=16)


def _ingest_both(monkeypatch, *ingests):
    """The same corpus into each package's store, with the same call ids."""
    for pkg in BOTH:
        ids = itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
        for ingest in ingests:
            ingest(pkg)


def _script(pkg, name):
    return __import__(f"{pkg.root}.scripts.{name}", fromlist=["main"])


@pytest.fixture()
def training_corpus(port_store):
    _ingest_training_corpus(PORT)
    return port_store


@pytest.fixture()
def distill_corpus(port_store):
    _ingest_distill_corpus(PORT)
    return port_store


# -- tests/integration/test_train_script.py ----------------------------------------
def test_pairs_from_store(training_corpus):
    from cadence_rag_tpu_torch.scripts.train_embedder import corpus_pairs

    pairs = corpus_pairs()
    assert len(pairs) >= 4
    for anchor, positive in pairs:
        assert anchor and positive


def test_training_run_saves_params(training_corpus, tmp_path, monkeypatch):
    from cadence_rag_tpu_torch.models.embedder import load_params
    from cadence_rag_tpu_torch.scripts.train_embedder import main

    out = str(tmp_path / "tuned.npz")
    monkeypatch.setattr(
        sys, "argv",
        ["train_embedder", "--out", out, "--steps", "3", "--batch", "4",
         "--d-model", "32", "--n-layers", "1", "--device", "cpu"],
    )
    main()
    model, cfg = load_params(out, "cpu")
    assert cfg.d_model == 32
    assert cfg.embed_dim == int(training_corpus.embeddings_dim)


def test_train_embedder_on_cuda_without_a_card_raises(training_corpus, tmp_path,
                                                      monkeypatch):
    import torch

    from cadence_rag_tpu_torch.scripts import train_embedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(train_embedder, "corpus_pairs", lambda **kw: pytest.fail(
        "read the store before naming its device"))
    monkeypatch.setattr(sys, "argv", ["train_embedder", "--out",
                                      str(tmp_path / "x.npz"), "--device", "cuda"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_embedder.main()
    assert not (tmp_path / "x.npz").exists()


# -- tests/integration/test_rerank_distill.py --------------------------------------
def test_triples_have_teacher_margin(distill_corpus):
    from cadence_rag_tpu_torch.scripts.train_reranker import build_triples

    triples = build_triples(30, seed=0)
    assert len(triples) >= 16
    for query, hi, lo in triples:
        assert query and hi and lo and hi != lo


def test_distilled_ordering_beats_random(distill_corpus, tmp_path):
    from cadence_rag_tpu_torch.scripts.train_reranker import (
        build_triples,
        pairwise_agreement,
        train,
    )

    triples = build_triples(60, seed=0)
    holdout = triples[: len(triples) // 5]
    train_set = triples[len(holdout):]
    out = str(tmp_path / "rr.npz")
    train(train_set, out_path=out, steps=250, batch=16, lr=3e-4, d_model=128,
          n_layers=2, vocab_buckets=4096, max_len=64, device="cpu")
    fidelity = pairwise_agreement(holdout, out, device="cpu")
    assert fidelity >= 0.62, fidelity


def test_neural_rerank_with_tuned_weights_serves(distill_corpus, tmp_path, monkeypatch):
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence
    from cadence_rag_tpu_torch.models.reranker import NeuralReranker
    from cadence_rag_tpu_torch.schemas import RetrieveRequest
    from cadence_rag_tpu_torch.scripts.train_reranker import build_triples, train

    triples = build_triples(40, seed=1)
    out = str(tmp_path / "rr.npz")
    train(triples, out_path=out, steps=30, batch=16, lr=1e-3, d_model=64,
          n_layers=1, vocab_buckets=4096, max_len=64, device="cpu")
    monkeypatch.setattr(distill_corpus, "rerank_enabled", True)
    monkeypatch.setattr(distill_corpus, "reranker_params_path", out)
    try:
        for provider in ("neural", "neural_raw"):
            monkeypatch.setattr(distill_corpus, "rerank_provider", provider)
            NeuralReranker.reset()
            resp = retrieve_evidence(RetrieveRequest(query="ECONNRESET gateway upgrade"))
            assert resp["quotes"], provider
            assert resp["notes"]["retrieval"]["reranked_from"] is not None
    finally:
        NeuralReranker.reset()


def test_hybrid_band_preserves_teacher_order(distill_corpus, monkeypatch):
    from cadence_rag_tpu_torch.core.index import get_index
    from cadence_rag_tpu_torch.engine.rerank import TEACHER_BAND, _lexical_scores, rerank
    from cadence_rag_tpu_torch.models.reranker import NeuralReranker
    from cadence_rag_tpu_torch.store.db import get_store

    with get_store().read() as conn:
        rows = conn.execute("SELECT chunk_id FROM chunks LIMIT 10").fetchall()
    doc_ids = [int(r["chunk_id"]) for r in rows]
    index = get_index()
    query = "ECONNRESET storm gateway upgrade"
    teacher = _lexical_scores(query, "chunks", "chunk_id", "text", doc_ids,
                              index.chunks.doc_freq, index.chunks.count)
    monkeypatch.setattr(distill_corpus, "rerank_enabled", True)
    monkeypatch.setattr(distill_corpus, "rerank_provider", "neural")
    monkeypatch.setattr(distill_corpus, "reranker_params_path", "")
    NeuralReranker.reset()  # random weights: adversarial tie-breaker
    try:
        ranked = [(d, {"bm25"}, 1.0 / (60 + i)) for i, d in enumerate(doc_ids)]
        out = rerank(query, ranked, "chunks", index.chunks.doc_freq, index.chunks.count,
                     topk=len(doc_ids), provider="neural")
        order = [d for d, _, _ in out]
        for i, a in enumerate(order):
            for b in order[i + 1:]:
                assert teacher.get(b, 0) - teacher.get(a, 0) < 2 * TEACHER_BAND, (a, b)
    finally:
        NeuralReranker.reset()


# -- the host data, JAX package against the port ------------------------------------
def test_embedder_training_data_identical(port_store, monkeypatch):
    _ingest_both(monkeypatch, _ingest_training_corpus, _ingest_distill_corpus)
    got = {}
    for pkg in BOTH:
        script = _script(pkg, "train_embedder")
        pairs = script.corpus_pairs(seed=3)
        got[pkg.root] = (pairs, script.mine_hard_negatives(pairs),
                         script.identifier_pool(pairs))
    assert got[PORT.root] == got[JAX.root]
    pairs, negatives, pool = got[PORT.root]
    assert len(pairs) > 40 and sum(n is not None for n in negatives) > 20 and pool


def test_reranker_training_data_identical(port_store, monkeypatch):
    _ingest_both(monkeypatch, _ingest_distill_corpus)
    got = {}
    for pkg in BOTH:
        script = _script(pkg, "train_reranker")
        triples = script.build_triples(40, seed=2)
        got[pkg.root] = (triples, script.attach_priors(triples))
    assert got[PORT.root] == got[JAX.root]
    assert len(got[PORT.root][0]) >= 16
    priors = np.array([t[3:] for t in got[PORT.root][1]])
    assert np.isfinite(priors).all() and priors.any()
