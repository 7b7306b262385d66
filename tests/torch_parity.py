"""Shared set-up of the tests that hold the port's engine and server to the
JAX package's (tests/test_torch_engine.py, tests/test_torch_serve.py), and
``mirror_tests``, which compiles one of the JAX package's own test files
against the port.

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
import re
import sys
import types
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from cadence_rag_tpu.config import settings as jax_settings
from cadence_rag_tpu_torch.config import settings as port_settings
from cadence_rag_tpu_torch.device import set_models_device
from cadence_rag_tpu_torch.engine import planner as PORT_PLANNER

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
            ("sync", "ingest.sync"), ("fs_queue", "ingest.fs_queue"),
            ("errors", "utils.errors"), ("checkpoint", "core.checkpoint"),
            ("vocab", "core.vocab"), ("featurize", "ingest.featurize"),
            ("hashing", "ops.hashing"), ("rerank", "engine.rerank"),
            ("api", "serve.api"),
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


TESTS = Path(__file__).resolve().parent
# the port's index has no default device: where a mirrored test makes the
# process-wide index anew, it asks for the CPU
_CPU_INDEX = ('__import__("cadence_rag_tpu_torch.core.index", '
              'fromlist=["get_index"]).get_index("cpu")')
ON_CPU = (
    (r"(?<!def )\breset_index\(\)", f"(reset_index(), {_CPU_INDEX})"),
    (r"\bget_index\(\)", 'get_index("cpu")'),
    (r"\brestore_index\(([^()]*(?:\([^()]*\))?[^()]*)\)",
     r'restore_index(\1, get_index("cpu"))'),
)


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or getattr(obj, "_pytestfixturefunction", None) is not None)


def mirror_tests(into: dict, stem: str, rel: str, drop=None, rewrites=(),
                 port=True):
    """Compile one of the JAX package's own test files against the port and
    bind its tests (prefixed with ``stem``) and fixtures into the test
    module whose globals are ``into``. The package's name is rewritten where
    it names a module (an import line, a dotted path in a string) and the
    ``tmp_store`` fixture's where it stands as a whole word (it becomes
    ``port_tmp_store``, which the test module defines); any other mention of
    the package fails here instead of passing rewritten. ``rewrites`` are
    further (pattern, replacement) pairs; ``drop`` maps a class name to the
    test methods (or None to a list of module-level tests) that do not
    apply to the port and are held by tests of the module's own instead.
    -> the compiled module. With ``port=False`` the file stays the JAX
    package's (only ``rewrites`` apply): the same cases run against the
    reference under the same rewrites."""
    source = (TESTS / rel).read_text()
    assert "cadence_rag_tpu_torch" not in source
    if port:
        source = re.sub(r"^(\s*(?:from|import)\s+)cadence_rag_tpu\b",
                        r"\1cadence_rag_tpu_torch", source, flags=re.M)
        source = re.sub(r"([\"'])cadence_rag_tpu\.", r"\1cadence_rag_tpu_torch.",
                        source)
        assert not re.search(r"cadence_rag_tpu(?!_torch\b)", source), rel
        source = re.sub(r"\btmp_store\b", "port_tmp_store", source)
    for pattern, replacement in rewrites:
        source = re.sub(pattern, replacement, source)
    module = types.ModuleType(f"{into['__name__']}.{stem}")
    module.__file__ = str(TESTS / rel)
    sys.modules[module.__name__] = module
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    for cls, methods in (drop or {}).items():
        for method in methods:
            if cls is None:
                del module.__dict__[method]
            else:
                delattr(vars(module)[cls], method)
    for name, obj in list(vars(module).items()):
        if getattr(obj, "__module__", None) != module.__name__ and not _is_fixture(obj):
            continue
        if name.startswith("Test") and isinstance(obj, type):
            into[f"Test_{stem}_{name[4:]}"] = obj
        elif name.startswith("test_") and callable(obj):
            into[f"test_{stem}_{name[5:]}"] = obj
        elif _is_fixture(obj):
            assert name not in into or into[name] is obj, name
            into[name] = obj
    return module


# The JAX package's API, request-path and store test files that run against
# the port as they stand (``tests/test_torch_mirrored_*.py``), with the port's
# router client asked for the CPU. Files that define fixtures of one name
# (``client``, ``corpus``) go to different test files.
MIRRORED_FILES = {
    "api": "integration/test_api.py",
    "edge_cases": "integration/test_edge_cases.py",
    "http_server": "integration/test_http_server.py",
    "batcher": "integration/test_batcher.py",
    "batch_retrieve": "integration/test_batch_retrieve.py",
    "concurrency": "integration/test_concurrency.py",
    "delete_compact": "integration/test_delete_compact.py",
    "store_sync": "integration/test_store_sync.py",
    "embed_cache": "unit/test_embed_cache.py",
    "embed_pipeline": "unit/test_embed_pipeline.py",
    "locks": "unit/test_locks.py",
    "schemas": "unit/test_schemas.py",
    "store": "unit/test_store.py",
    "chunking": "unit/test_chunking.py",
}
CLIENT_ON_CPU = ((r"\bTestClient\(\)", 'TestClient(device="cpu")'),)


def mirror_files(into: dict, stems, drop=None) -> None:
    """``mirror_tests`` for each of ``stems`` (keys of ``MIRRORED_FILES``),
    the router client on the CPU; ``drop`` maps a stem to its drop map."""
    for stem in stems:
        mirror_tests(into, stem, MIRRORED_FILES[stem], drop=(drop or {}).get(stem),
                     rewrites=CLIENT_ON_CPU)


def assert_mirrored_against_the_port(module_name: str, stems) -> None:
    """Each compiled file's names come from the port, none from the JAX
    package."""
    for stem in stems:
        names = vars(sys.modules[f"{module_name}.{stem}"])
        assert not any(getattr(v, "__module__", "").startswith("cadence_rag_tpu.")
                       for v in names.values()), stem


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
    its own, and its index and in-process models live on the CPU. Each
    package's ingest reads a clock of its own that starts at the same
    second."""
    for pkg in BOTH:
        monkeypatch.setattr(pkg.ingest, "now_utc", fake_clock())
    for field in dataclasses.fields(port_settings):
        monkeypatch.setattr(port_settings, field.name, getattr(tmp_store, field.name))
    monkeypatch.setattr(port_settings, "store_path", str(tmp_path / "port.db"))
    def reset():
        PORT.ingest.set_store_only(False)
        PORT.db.reset_store()
        PORT.index.reset_index()
        PORT.sync.reset_syncer()
        PORT.provider.reset_embed_cache()

    reset()
    PORT.index.get_index("cpu")
    # the in-process models (models/*) live beside the index
    set_models_device("cpu")
    yield port_settings
    reset()


@pytest.fixture()
def one_thread():
    """One intra-op torch thread for the test: the training loops are
    thousands of small ops, which a test worker sharing the machine's cores
    with others runs far faster without parallel regions."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
        # the port's own table of K1's recall on the card, flat in ef
        want = (min(r for _case, r in PORT_PLANNER.MEASURED_ANN_RECALL)
                if notes["hnsw_ef_search"] is not None else None)
        assert notes["ann_expected_recall"] == want


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
