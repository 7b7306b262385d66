"""Shared set-up of the tests that hold the port's engine and server to the
JAX package's (tests/test_torch_engine.py, tests/test_torch_serve.py).

Each package gets its own temporary SQLite store and its own index, with the
same settings (conftest's ``tmp_store`` sizes: 64-d embeddings, 1024-wide
lexical signatures, capacity 256, the stub embedder); the port's index lives
on the CPU. The same corpus goes into both in the same order, so SQLite
gives the same chunk and artifact ids; call ids are uuid4s, so responses are
compared with each call id replaced by its ``external_id``.
"""

import copy
import dataclasses
import importlib
import itertools
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from cadence_rag_tpu.config import settings as jax_settings
from cadence_rag_tpu_torch.config import settings as port_settings

DEBUG_SCORE_ATOL = 1e-5    # lane scores: f32 sums taken in another order
RRF_SCORE_ATOL = 1e-6      # fused scores: f32 (device RRF) or f64 sums of 1/(60+r)


class Package:
    """The modules of one package that the tests drive, by their names."""

    def __init__(self, root: str):
        self.root = root
        for attr, name in (
            ("retrieve", "engine.retrieve"), ("ingest", "ingest.ingest"),
            ("pipeline", "embed.pipeline"), ("provider", "embed.provider"),
            ("schemas", "schemas"), ("index", "core.index"),
            ("db", "store.db"), ("testing", "serve.testing"),
            ("real_gate", "evals.real_gate"), ("rrf", "native.rrf"),
        ):
            setattr(self, attr, importlib.import_module(f"{root}.{name}"))
        self.settings = importlib.import_module(f"{root}.config").settings

    def request(self, body: dict):
        return self.schemas.RetrieveRequest.model_validate(body)

    def call_ext(self) -> dict:
        """{call_id: external_id} of every call in this package's store."""
        with self.db.get_store().read() as conn:
            rows = conn.execute("SELECT call_id, external_id FROM calls").fetchall()
        return {r["call_id"]: r["external_id"] for r in rows}


JAX = Package("cadence_rag_tpu")
PORT = Package("cadence_rag_tpu_torch")
BOTH = (JAX, PORT)


def fake_clock(start=datetime(2025, 6, 1, tzinfo=timezone.utc)):
    """A ``now_utc`` that advances one second a call: calls created without
    a start time get the same start seconds in both packages (the tech
    lane ranks by recency, so wall-clock seconds would make the packages'
    rankings depend on when each ingest ran)."""
    ticks = itertools.count()
    return lambda: start + timedelta(seconds=next(ticks))


@pytest.fixture()
def port_store(tmp_store, tmp_path, monkeypatch):
    """conftest's store and index for the JAX package, and the same for the
    port: its settings take the JAX package's values and a store file of
    its own, and its index is created on the CPU. Each package's ingest
    reads a clock of its own that starts at the same second."""
    for pkg in BOTH:
        monkeypatch.setattr(pkg.ingest, "now_utc", fake_clock())
    for field in dataclasses.fields(port_settings):
        monkeypatch.setattr(port_settings, field.name, getattr(tmp_store, field.name))
    monkeypatch.setattr(port_settings, "store_path", str(tmp_path / "port.db"))
    PORT.ingest.set_store_only(False)
    PORT.db.reset_store()
    PORT.index.reset_index()
    PORT.provider.reset_embed_cache()
    PORT.index.get_index("cpu")
    yield port_settings
    PORT.db.reset_store()
    PORT.index.reset_index()
    PORT.provider.reset_embed_cache()


@pytest.fixture()
def set_both(monkeypatch):
    """Set one setting in both packages."""
    def put(name, value):
        monkeypatch.setattr(jax_settings, name, value)
        monkeypatch.setattr(port_settings, name, value)
    return put


# -- the corpus of tests/integration/test_engine_retrieve.py, plus a call with
# many identifiers and a call with a fixed start date ---------------------------
CALL_A_TEXTS = [
    "we saw ECONNRESET errors from the object store gateway last night",
    "the lenovo build needs a new BOM before the bake-off with dell",
    "tiering to SSD fixed the latency spike on the ingest path",
    "let's schedule the azure migration review for next sprint",
]
CALL_B_TEXTS = [
    "quarterly pipeline review went well, acme is moving to stage four",
    "the customer asked about pricing for the supermicro variant",
    "legal needs the updated msa before we can countersign",
    "renewal forecast looks strong for the emea region this quarter",
]
CALL_D_TEXTS = [
    "the kafka consumer lag on broker-7 doubled after the v3.2.1 upgrade",
    "we will rebalance partitions before the freeze and watch the lag",
]
DATED = datetime(2024, 1, 15, 9, 30, tzinfo=timezone.utc)
OPTS = {"target_tokens": 30, "max_tokens": 60, "overlap_tokens": 5}


def _utterances(pkg, texts):
    return [pkg.schemas.UtteranceIn(speaker=["Ana", "Raj"][i % 2],
                                    start_ts_ms=i * 5000,
                                    end_ts_ms=i * 5000 + 4500, text=t)
            for i, t in enumerate(texts)]


def ingest_corpus(pkg, backfill: bool = True) -> dict:
    """Ingest the corpus into ``pkg``; -> {external_id: call_id}."""
    s = pkg.schemas
    opts = s.ChunkingOptions(**OPTS)
    calls = {}
    calls["ext-A"], _, _ = pkg.ingest.ingest_transcript(
        s.CallRef(title="infra debrief", external_id="ext-A"),
        _utterances(pkg, CALL_A_TEXTS), opts)
    pkg.ingest.ingest_analysis(s.CallRef(call_id=calls["ext-A"]), [
        s.AnalysisArtifactIn(kind="action_items",
                             content="- send BOM to lenovo\n- verify ECONNRESET fix\n"),
        s.AnalysisArtifactIn(kind="summary",
                             content="Team debugged object store resets and agreed on SSD tiering."),
    ])
    calls["ext-B"], _, _ = pkg.ingest.ingest_transcript(
        s.CallRef(title="sales sync", external_id="ext-B", tags=["sales"]),
        _utterances(pkg, CALL_B_TEXTS), opts)
    calls["manytok"], _, _ = pkg.ingest.ingest_transcript(
        s.CallRef(external_id="manytok"),
        [s.UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                       text="the fix shipped in JIRA-7749 yesterday")],
        s.ChunkingOptions(target_tokens=10, max_tokens=30, overlap_tokens=0))
    calls["ext-D"], _, _ = pkg.ingest.ingest_transcript(
        s.CallRef(title="streaming review", external_id="ext-D", started_at=DATED),
        _utterances(pkg, CALL_D_TEXTS), opts)
    pkg.ingest.ingest_analysis(s.CallRef(call_id=calls["ext-D"]), [
        s.AnalysisArtifactIn(kind="decisions",
                             content="1. rebalance kafka partitions before the freeze\n"
                                     "2. pin brokers at v3.2.1\n"),
    ])
    if backfill:
        pkg.pipeline.run_embedding_backfill(batch_size=8)
    return calls


def request_bodies(calls: dict) -> dict:
    """Every request shape of tests/integration/test_engine_retrieve.py,
    by name, with call ids from ``calls``."""
    decoys = " ".join(f"SVC-{1000 + i}" for i in range(14))
    return {
        "pack": {"query": "ECONNRESET object store errors"},
        "many_identifiers": {"query": f"status of {decoys} JIRA-7749", "debug": True},
        "call_ids": {"query": "ECONNRESET object store",
                     "filters": {"call_ids": [calls["ext-B"]]}},
        "external_id": {"query": "pipeline review quarterly",
                        "filters": {"external_id": "ext-B"}},
        "tags": {"query": "supermicro pricing", "filters": {"call_tags": ["sales"]}},
        "dates": {"query": "kafka consumer lag rebalance",
                  "filters": {"date_from": "2024-01-01T00:00:00+00:00",
                              "date_to": "2024-02-01T00:00:00+00:00"}},
        "budget": {"query": "ECONNRESET lenovo BOM SSD tiering azure",
                   "budget": {"max_evidence_items": 3, "max_total_chars": 200}},
        "limits": {"query": "ECONNRESET BOM lenovo object store SSD"},
        "ids_only": {"query": "object store tiering SSD", "return_style": "ids_only"},
        "ids_only_scoped": {"query": "pipeline review acme", "return_style": "ids_only",
                            "filters": {"call_ids": [calls["ext-B"]]}},
        "debug": {"query": "ECONNRESET errors", "debug": True},
        "debug_ids_only": {"query": "kafka rebalance v3.2.1", "debug": True,
                           "return_style": "ids_only"},
        "empty": {"query": "   "},
        "empty_ids_only": {"query": "", "return_style": "ids_only"},
    }


def normalize(resp: dict, ext_of: dict):
    """-> (response without its per-request and per-package fields, call
    ids as external ids; the debug lanes, compared on their own)."""
    out = copy.deepcopy(resp)
    out.pop("query_id")
    lanes = None
    if "debug" in out:
        out["debug"].pop("timings_ms")
        lanes = out["debug"].pop("lanes")
    notes = out.get("notes", {}).get("retrieval")
    if notes is not None:
        notes.pop("timings_ms")
        notes.pop("ann_expected_recall")
    for item in out.get("quotes", []) + out.get("artifacts", []):
        item["call_id"] = ext_of[item["call_id"]]
    return out, lanes


def assert_lanes_match(got, want):
    if want is None:
        assert got is None
        return
    assert got.keys() == want.keys()
    for corpus in want:
        assert got[corpus].keys() == want[corpus].keys(), corpus
        for lane, rows in want[corpus].items():
            mine = got[corpus][lane]
            assert len(mine) == len(rows), (corpus, lane)
            for g, w in zip(mine, rows):
                assert {k: v for k, v in g.items() if k != "score"} == \
                    {k: v for k, v in w.items() if k != "score"}, (corpus, lane)
                if w["score"] is None:
                    assert g["score"] is None
                else:
                    assert abs(g["score"] - w["score"]) <= DEBUG_SCORE_ATOL, (corpus, lane)


def assert_same_response(port_resp, jax_resp, want_pkg=JAX):
    """The port's response is the JAX package's (or, with ``want_pkg``
    PORT, another of the port's), apart from query_id, timings, call ids
    (mapped through external ids) and debug lane scores (within
    DEBUG_SCORE_ATOL)."""
    p, p_lanes = normalize(port_resp, PORT.call_ext())
    j, j_lanes = normalize(jax_resp, want_pkg.call_ext())
    assert p == j
    assert_lanes_match(p_lanes, j_lanes)
    notes = port_resp.get("notes", {}).get("retrieval")
    if notes is not None:
        assert notes["ann_expected_recall"] is None


def assert_same_merged(port_plan, jax_plan):
    """The fused lists of one plan: ids, lane masks and lane names
    identical, scores within RRF_SCORE_ATOL."""
    for got, want in ((port_plan.chunk_merged, jax_plan.chunk_merged),
                      (port_plan.artifact_merged, jax_plan.artifact_merged)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        assert tuple(got[3]) == tuple(want[3])
        np.testing.assert_allclose(np.asarray(got[1], np.float64),
                                   np.asarray(want[1], np.float64),
                                   rtol=0, atol=RRF_SCORE_ATOL)
