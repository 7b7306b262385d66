"""The port's /retrieve engine against the JAX package's, on the CPU.

Both packages ingest the same corpus into stores and indexes of their own
(tests/torch_parity.py) and answer the same requests: every request shape
of tests/integration/test_engine_retrieve.py, alone and in one batch, with
device RRF on and off, without a provider, with a failing provider, with
coalesced duplicates, at a batch size that is not a power of two. Also held
to the JAX package: ``set_embeddings`` (through the backfill),
``rebuild_index_from_store`` and the real gate's metrics.

Tolerances: retrieved ids, evidence packs and lane ranks are identical; debug
lane scores agree within 1e-5 and fused RRF scores within 1e-6.
"""

import numpy as np
import pytest
import torch

from torch_parity import (
    BOTH,
    JAX,
    PORT,
    assert_same_merged,
    assert_same_response,
    ingest_corpus,
    port_store,  # noqa: F401  (fixture)
    request_bodies,
    set_both,  # noqa: F401  (fixture)
)

NAMES = list(request_bodies({"ext-B": "00000000-0000-4000-8000-000000000000"}))


@pytest.fixture()
def corpus(port_store):
    """{package root: {external_id: call_id}} after ingest and backfill."""
    return {pkg.root: ingest_corpus(pkg) for pkg in BOTH}


def _serve(pkg, calls, names, batch=True):
    bodies = request_bodies(calls[pkg.root])
    reqs = [pkg.request(bodies[n]) for n in names]
    if batch:
        return pkg.retrieve.retrieve_evidence_batch(reqs)
    return [pkg.retrieve.retrieve_evidence(r) for r in reqs]


@pytest.mark.parametrize("name", NAMES)
def test_each_request_alone(corpus, name):
    got = _serve(PORT, corpus, [name], batch=False)[0]
    want = _serve(JAX, corpus, [name], batch=False)[0]
    assert_same_response(got, want)


def test_all_requests_in_one_batch(corpus):
    """One micro-batch mixing every shape: several planner groups (scoped
    and unscoped, debug on the host merge, the rest on device RRF)."""
    got = _serve(PORT, corpus, NAMES)
    want = _serve(JAX, corpus, NAMES)
    assert len(got) == len(NAMES)
    for g, w in zip(got, want):
        assert_same_response(g, w)
    by_name = dict(zip(NAMES, got))
    assert by_name["pack"]["quotes"] and by_name["ids_only"]["retrieved_ids"]
    port_calls = corpus[PORT.root]
    for name, ext in (("dates", "ext-D"), ("call_ids", "ext-B"), ("tags", "ext-B")):
        quotes = by_name[name]["quotes"]
        assert quotes and {q["call_id"] for q in quotes} == {port_calls[ext]}, name
    assert by_name["many_identifiers"]["debug"]["lanes"]["chunks"]["tech_tokens"]
    assert by_name["empty"]["notes"] == {"error": "empty query"}


@pytest.mark.parametrize("device_rrf", [True, False])
def test_fused_lists_match(corpus, set_both, device_rrf):
    """The fused (RRF) list of every plan, from the device RRF program
    (debug plans excepted) or from the host merge."""
    set_both("device_rrf_enabled", device_rrf)
    plans = {}
    for pkg in BOTH:
        bodies = request_bodies(corpus[pkg.root])
        ps = pkg.retrieve._prepare_plans([pkg.request(bodies[n]) for n in NAMES])
        pkg.retrieve._collect_plans(pkg.retrieve._dispatch_plans(ps))
        plans[pkg.root] = ps
    for name, p, j in zip(NAMES, plans[PORT.root], plans[JAX.root]):
        if j.empty:
            assert p.empty
            continue
        assert (p.chunk_mode, p.artifact_mode) == (j.chunk_mode, j.artifact_mode), name
        assert bool(p.chunk_lanes) == bool(j.chunk_lanes), name
        assert_same_merged(p, j)


QUERIES_8 = ["ECONNRESET object store errors", "object store tiering SSD",
             "lenovo BOM bake-off", "azure migration review",
             "kafka consumer lag", "supermicro pricing", "renewal forecast emea",
             "JIRA-7749 fix shipped"]


def test_batch_of_five_matches_the_padded_batch(corpus):
    """One planner group of 5: the port dispatches it at batch 5, the JAX
    package pads it to 8. The real rows' responses agree, and agree with
    the port's own group of 8 that holds them and three more queries."""
    def serve(pkg, n):
        return pkg.retrieve.retrieve_evidence_batch([
            pkg.request({"query": q, "return_style": "ids_only"})
            for q in QUERIES_8[:n]])

    got, want, eight = serve(PORT, 5), serve(JAX, 5), serve(PORT, 8)
    assert all(r["retrieved_ids"] for r in got)
    for g, w, e in zip(got, want, eight):
        assert_same_response(g, w)
        assert_same_response(g, e, want_pkg=PORT)


def test_lexical_only_without_provider(corpus, set_both):
    set_both("embeddings_provider", "")
    set_both("embeddings_base_url", "")
    names = ["pack", "ids_only", "call_ids", "debug"]
    got = _serve(PORT, corpus, names)
    want = _serve(JAX, corpus, names)
    for g, w in zip(got, want):
        assert_same_response(g, w)
    assert got[0]["notes"]["retrieval"]["planner"] == "lexical_only"
    assert got[0]["quotes"]


def test_failing_provider_degrades_the_dense_lane(corpus, monkeypatch):
    for pkg in BOTH:
        err = pkg.provider.EmbeddingError

        def boom(texts, err=err):
            raise err("max batch size <= 8")

        monkeypatch.setattr(pkg.retrieve, "embed_texts", boom)
    names = ["pack", "debug", "ids_only"]
    got = _serve(PORT, corpus, names)
    want = _serve(JAX, corpus, names)
    for g, w in zip(got, want):
        assert_same_response(g, w)
    notes = got[0]["notes"]["retrieval"]
    assert notes["planner"] == "lexical_only" and notes["dense_error"]


def test_coalesced_duplicates(corpus):
    names = ["pack", "pack", "ids_only", "pack", "ids_only"]
    got = _serve(PORT, corpus, names)
    want = _serve(JAX, corpus, names)
    for g, w in zip(got, want):
        assert_same_response(g, w)
    assert len({r["query_id"] for r in got}) == len(names)
    assert_same_response(got[3], got[0], want_pkg=PORT)


def test_pipelined_and_two_phase_match_batched(corpus):
    bodies = request_bodies(corpus[PORT.root])
    batches = [[PORT.request(bodies[n]) for n in chunk]
               for chunk in (NAMES[:5], NAMES[5:10], NAMES[10:])]
    batched = [PORT.retrieve.retrieve_evidence_batch(b) for b in batches]
    piped = list(PORT.retrieve.retrieve_evidence_pipelined(batches, depth=2))
    handle = PORT.retrieve.dispatch_evidence_batch(batches[0])
    two_phase = PORT.retrieve.finish_evidence_batch(handle)
    for want, got in zip(batched, piped):
        for g, w in zip(got, want):
            assert_same_response(g, w, want_pkg=PORT)
    for g, w in zip(two_phase, batched[0]):
        assert_same_response(g, w, want_pkg=PORT)


STAGES = ("plan", "tech", "featurize", "embed", "planner", "enqueue",
          "collect", "store_rows", "assemble")


def test_stage_spans_in_the_event_ring(corpus):
    """With the event ring on, each batch leaves one ``retrieve.<stage>``
    span per host stage, sized by its unique plans; the answers are the
    JAX package's all the same. With the ring off it stays empty."""
    from cadence_rag_tpu_torch.utils import events

    names = ["pack", "ids_only", "pack", "call_ids"]
    events.enable()
    try:
        got = _serve(PORT, corpus, names)
        spans = [ev for ev in events.drain() if ev["tag"].startswith("retrieve.")]
    finally:
        events.disable()
    for g, w in zip(got, _serve(JAX, corpus, names)):
        assert_same_response(g, w)
    assert [ev["tag"] for ev in spans] == [f"retrieve.{s}" for s in STAGES]
    assert all(ev["batch"] == 3 and ev["s"] >= 0 for ev in spans)
    _serve(PORT, corpus, names)
    assert events.drain() == []


def test_ids_only_fast_path_matches_per_plan_assembly(corpus, monkeypatch):
    assert PORT.rrf.available()
    names = ["ids_only", "empty_ids_only", "ids_only_scoped", "pack"]
    fast = _serve(PORT, corpus, names)
    monkeypatch.setattr(PORT.rrf, "ids_only_format", lambda *a, **k: None)
    slow = _serve(PORT, corpus, names)
    for f, s in zip(fast, slow):
        assert_same_response(f, s, want_pkg=PORT)
    assert fast[0]["retrieved_ids"]


def test_backfill_sets_the_same_embeddings(corpus):
    """``set_embeddings`` through the backfill leaves the port's rows,
    flags and counters as the JAX package's (bf16 rows bit for bit)."""
    for name in ("chunks", "artifact_chunks"):
        p = PORT.index.get_index().corpus(name)
        j = JAX.index.get_index().corpus(name)
        ps, js = p.state_arrays(), j.state_arrays()
        np.testing.assert_array_equal(ps["emb"], js["emb"].astype(np.float32))
        np.testing.assert_array_equal(ps["has_emb"], js["has_emb"])
        np.testing.assert_array_equal(ps["ids"], js["ids"])
        assert p.emb_rows == j.emb_rows == p.count


def test_set_embeddings_direct(port_store):
    """Some rows, an unknown id and a second write of a row: rows written,
    flags and ``emb_rows`` as the JAX package gives them."""
    for pkg in BOTH:
        ingest_corpus(pkg, backfill=False)
    rng = np.random.default_rng(5)
    dim = int(PORT.settings.embeddings_dim)
    ids = [1, 3, 999_999, 4, 3]
    vecs = rng.standard_normal((len(ids), dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs[4] = vecs[1]
    p = PORT.index.get_index().chunks
    j = JAX.index.get_index().chunks
    assert p.set_embeddings(ids, vecs) == j.set_embeddings(ids, vecs) == 4
    ps, js = p.state_arrays(), j.state_arrays()
    np.testing.assert_array_equal(ps["emb"], js["emb"].astype(np.float32))
    np.testing.assert_array_equal(ps["has_emb"], js["has_emb"])
    assert p.emb_rows == j.emb_rows
    np.testing.assert_array_equal(p.position_of(ids), j.position_of(ids))
    assert bool(p.has_emb[0]) and p.has_emb.dtype == torch.bool


def test_unembedded_rows_stay_out_of_the_dense_lane(port_store):
    for pkg in BOTH:
        ingest_corpus(pkg, backfill=False)
    body = {"query": "ECONNRESET object store gateway", "debug": True}
    got = PORT.retrieve.retrieve_evidence(PORT.request(body))
    want = JAX.retrieve.retrieve_evidence(JAX.request(body))
    assert_same_response(got, want)
    lanes = got["debug"]["lanes"]["chunks"]
    assert lanes["bm25"] and lanes["dense"] == []


def test_rebuild_from_store_matches(corpus):
    names = ["pack", "ids_only", "dates", "debug"]
    before = _serve(PORT, corpus, names)
    counts = {}
    for pkg in BOTH:
        live = pkg.index.get_index()
        n = (live.chunks.count, live.artifacts.count)
        pkg.index.reset_index()
        if pkg is PORT:
            pkg.index.get_index("cpu")
        counts[pkg.root] = pkg.ingest.rebuild_index_from_store()
        assert counts[pkg.root] == n
    assert counts[PORT.root] == counts[JAX.root]
    got = _serve(PORT, corpus, names)
    want = _serve(JAX, corpus, names)
    for g, w, b in zip(got, want, before):
        assert_same_response(g, w)
        assert_same_response(g, b, want_pkg=PORT)


def test_real_gate_matches(port_store):
    got = PORT.real_gate.run_gate(device="cpu")
    want = JAX.real_gate.run_gate()
    assert got["metrics"] == want["metrics"]
    assert got["failures"] == [] == want["failures"]
    assert got["metrics"]["mrr"] >= 0.60 and got["metrics"]["recall@20"] >= 0.80
