"""The port's HTTP surface against the JAX package's, on the CPU.

Both packages serve through their in-process router clients
(``serve.testing.TestClient``; the port's on ``device="cpu"``), take the same
ingest requests and answer the same reads and retrievals; one test drives
the port's aiohttp server over a real socket with the micro-batcher on. The
port's ``startup`` must raise for every setting whose feature is not ported,
and for a card that is not there, and start and serve with the in-process
models' and the row-sharded mesh's settings (a gang's settings raise as the
JAX package's do where they cannot make a gang); no route is left unserved:
the routes that once answered "not ported" answer as the JAX package's do.
"""

import asyncio
import sqlite3
import sys
import urllib.error
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (
    JAX,
    PORT,
    assert_same_response,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)

TEXTS = [
    "the ECONNRESET storm started after the object store upgrade",
    "rolling back to v2.3.1 stopped the resets immediately",
    "we should pin the client library and add retries",
]
BATCH_TEXTS = ["kafka consumer lag on broker-7 after the rebalance",
               "the azure landing zone needs private endpoints"]
NOT_PORTED = [
    ("GET", "/ingest/jobs"),
    ("GET", "/ingest/jobs/00000000-0000-4000-8000-000000000001"),
    ("DELETE", "/calls/00000000-0000-4000-8000-000000000001"),
]
TWO_REGISTER = str(Path(__file__).resolve().parent.parent / "artifacts" /
                   "reranker" / "two_register_v1.npz")
# (settings, a word of the message, the ROADMAP item it names); item 6's
# settings (the in-process models) are ported and now start and serve
UNPORTED_SETTINGS = [
    ({"rerank_enabled": True, "rerank_provider": "neural",
      "reranker_params_path": TWO_REGISTER}, "RERANK_PROVIDER=neural", "item 6"),
    ({"rerank_enabled": True, "rerank_provider": "neural_raw",
      "reranker_params_path": TWO_REGISTER}, "RERANK_PROVIDER=neural_raw", "item 6"),
    ({"dist_coordinator": "localhost:1234"}, "DIST_COORDINATOR", "item 7"),
    ({"mesh_shape": "data:4"}, "MESH_SHAPE", "item 7"),
    ({"mesh_shape": "data:2,model:2"}, "MESH_SHAPE", "item 7"),
    ({"profiler_port": 9999}, "PROFILER_PORT", "item 2"),
    ({"embeddings_provider": "neural"}, "EMBEDDINGS_PROVIDER", "item 6"),
    ({"embeddings_provider": "qwen3", "qwen3_preset": "tiny", "embeddings_dim": 32},
     "EMBEDDINGS_PROVIDER", "item 6"),
]


def _transcript(texts, external_id, title=None, tags=None):
    return {
        "call_ref": {"external_id": external_id, "title": title, "tags": tags},
        "transcript": {"format": "json_turns", "content": [
            {"speaker": ["Ana", "Raj"][i % 2], "start_ts_ms": i * 4000,
             "end_ts_ms": i * 4000 + 3500, "text": t}
            for i, t in enumerate(texts)]},
        "options": {"target_tokens": 25, "max_tokens": 50, "overlap_tokens": 4},
    }


@pytest.fixture()
def clients(port_store, set_both):
    """{package root: TestClient} after startup, both with the syncer off."""
    from cadence_rag_tpu_torch.serve.metrics import registry

    set_both("store_sync_interval_s", 0.0)
    registry.reset()
    return {JAX.root: JAX.testing.TestClient(),
            PORT.root: PORT.testing.TestClient(device="cpu")}


@pytest.fixture()
def seeded(clients):
    """The same ingest requests through both routers -> {root: call_id}."""
    calls = {}
    for root, client in clients.items():
        resp = client.post("/ingest/transcript", json=_transcript(
            TEXTS, "api-call-1", title="incident review", tags=["ops"]))
        assert resp.status_code == 200, resp.json()
        call_id = calls[root] = resp.json()["call_id"]
        resp = client.post("/ingest/analysis", json={
            "call_ref": {"call_id": call_id},
            "artifacts": [{"kind": "action_items",
                           "content": "- pin client to v2.3.1\n- add retry budget\n"}],
        })
        assert resp.status_code == 200, resp.json()
        resp = client.post("/ingest/transcript/batch", json=[
            _transcript([t], f"batch-{i}") for i, t in enumerate(BATCH_TEXTS)])
        assert resp.status_code == 200 and resp.json()["failed"] == 0
        resp = client.post("/ingest/call", json={"call_ref": {"external_id": "bare"}})
        assert resp.status_code == 200 and resp.json()["created"]
    return calls


def _both(clients, method, path, **kw):
    return [clients[pkg.root].request(method, path, **kw) for pkg in (PORT, JAX)]


def test_health_and_diagnostics(clients):
    port, jax = _both(clients, "GET", "/health")
    assert port.status_code == jax.status_code == 200
    db = port.json()["db"]
    assert db["schema_version"] == jax.json()["db"]["schema_version"]
    assert db["torch_version"] == torch.__version__ and "jax_version" not in db
    port, jax = _both(clients, "GET", "/diagnostics")
    assert port.json()["status"] == jax.json()["status"] == "ok"
    assert port.json()["index"]["device"] == "cpu"
    p, j = port.json()["index"], jax.json()["index"]
    assert p["mesh"] is None and j["mesh"] is None
    assert p["embedding_dtype"] == j["embedding_dtype"] == "bfloat16"


def test_ingest_responses_match(seeded, clients):
    for pkg in (PORT, JAX):
        ext = pkg.call_ext()
        assert sorted(ext.values()) == ["api-call-1", "bare", "batch-0", "batch-1"]
    port, jax = _both(clients, "GET", "/index/stats")
    p, j = port.json(), jax.json()
    for corpus in ("chunks", "artifact_chunks"):
        for key in ("count", "capacity", "embedded", "avgdl", "lexical_dim", "dim",
                    "emb_dtype", "tombstones", "ivf_built"):
            assert p[corpus][key] == j[corpus][key], (corpus, key)
    assert p["call_capacity"] == j["call_capacity"]
    assert p["prewarm_compiled"] == j["prewarm_compiled"] == 0
    # both syncers stand at their store's newest mutation
    assert p["sync"].keys() == j["sync"].keys()
    assert p["sync"]["store_seq"] == j["sync"]["store_seq"] > 0


def test_reads_match(seeded, clients):
    ext_p, ext_j = PORT.call_ext(), JAX.call_ext()
    port, jax = _both(clients, "GET", "/calls", params={"limit": 2})
    items = lambda r, ext: [(ext[c["call_id"]], c["title"], c["tags"])
                            for c in r.json()["items"]]
    assert items(port, ext_p) == items(jax, ext_j)
    assert (port.json()["next_cursor"] is None) == (jax.json()["next_cursor"] is None)
    port = clients[PORT.root].get(f"/calls/{seeded[PORT.root]}")
    jax = clients[JAX.root].get(f"/calls/{seeded[JAX.root]}")
    assert port.json()["counts"] == jax.json()["counts"]
    for path in ("/chunks/1", "/chunks/999"):
        port, jax = _both(clients, "GET", path)
        assert port.status_code == jax.status_code
        if port.status_code == 200:
            p, j = port.json(), jax.json()
            assert ext_p[p.pop("call_id")] == ext_j[j.pop("call_id")]
            assert p == j
    for evidence_id in ("Q-1", "A-1", "X-1"):
        port, jax = _both(clients, "POST", "/expand",
                          json={"evidence_id": evidence_id, "window_ms": 5000})
        assert port.status_code == jax.status_code
        if port.status_code == 200:
            p, j = port.json(), jax.json()
            assert ext_p[p.pop("call_id")] == ext_j[j.pop("call_id")]
            assert p == j


@pytest.mark.parametrize("style", ["evidence_pack_json", "ids_only"])
def test_retrieve_matches(seeded, clients, style):
    body = {"query": "ECONNRESET rollback v2.3.1", "return_style": style}
    port, jax = _both(clients, "POST", "/retrieve", json=body)
    assert port.status_code == jax.status_code == 200
    assert_same_response(port.json(), jax.json())
    batch = [body, {"query": "kafka lag", "debug": True},
             {"query": "pin the client", "filters": {"external_id": "api-call-1"}}]
    port, jax = _both(clients, "POST", "/retrieve/batch", json=batch)
    assert port.status_code == jax.status_code == 200
    for p, j in zip(port.json()["results"], jax.json()["results"]):
        assert_same_response(p, j)
    metrics = clients[PORT.root].get("/metrics").json()["endpoints"]
    assert metrics["POST /retrieve"]["count"] == 1
    assert metrics["POST /retrieve/batch"]["count"] == 1


def test_request_errors_match(clients):
    for method, path, body in (
        ("POST", "/retrieve", {"nope": 1}),
        ("POST", "/retrieve/batch", []),
        ("POST", "/ingest/analysis", {"call_ref": {"external_id": "x"}, "artifacts": []}),
        ("GET", "/calls/not-a-uuid", None),
        ("GET", "/no/such/route", None),
    ):
        port, jax = _both(clients, method, path, json=body)
        assert port.status_code == jax.status_code, path


@pytest.mark.parametrize("method,path", NOT_PORTED)
def test_unported_routes_say_so(clients, method, path):
    """No route is unported any more: the three that were (the job queue's
    and DELETE /calls/{id}) answer what the JAX package answers, here for
    an empty store."""
    port, jax = _both(clients, method, path)
    assert port.status_code == jax.status_code
    assert port.json() == jax.json()
    assert "not ported" not in str(port.json())


@pytest.mark.parametrize("values,word,item", UNPORTED_SETTINGS)
def test_startup_raises_for_unported_settings(port_store, monkeypatch, values, word, item):
    """Startup raises for a setting whose feature is not ported, naming its
    ROADMAP item. Item 6's settings (the in-process embedders and the
    cross-encoder) are ported: startup takes them, and the engine serves
    with them on the device startup named. Item 7 is ported:
    ``MESH_SHAPE=data:4`` starts and serves from four shards on the CPU,
    ``data:2,model:2`` from two shards replicated over the model axis, and
    ``DIST_COORDINATOR`` alone raises for the gang's size it lacks."""
    from cadence_rag_tpu_torch.models.embedder import NeuralEmbeddingProvider
    from cadence_rag_tpu_torch.models.qwen3 import Qwen3EmbeddingProvider
    from cadence_rag_tpu_torch.models.reranker import NeuralReranker
    from cadence_rag_tpu_torch.serve.api import startup
    from torch_parity import ingest_corpus

    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.0)
    for name, value in values.items():
        monkeypatch.setattr(PORT.settings, name, value)
    if item == "item 7" and "dist_coordinator" in values:
        with pytest.raises(RuntimeError, match="DIST_NUM_PROCESSES"):
            startup("cpu")
        return
    if item == "item 2":
        # ported: startup starts the trace listener (serve/profiler.py)
        from cadence_rag_tpu_torch.serve import profiler

        try:
            startup("cpu")
            assert values["profiler_port"] in profiler._servers
        finally:
            profiler.stop_server()
        return
    if item == "item 7":
        PORT.index.reset_index()
        startup("cpu")
        index = PORT.index.get_index()
        assert index.mesh.shape == {name: int(size) for name, size in (
            p.split(":") for p in values["mesh_shape"].split(","))}
        assert index.chunks.n_shards == index.mesh.shape["data"]
        ingest_corpus(PORT)
        resp = PORT.retrieve.retrieve_evidence(
            PORT.request({"query": "ECONNRESET object store errors"}))
        assert resp["quotes"]
        return
    if item != "item 6":
        with pytest.raises(RuntimeError, match=f"{word}.*ROADMAP Queue 1:? {item}"):
            startup("cpu")
        return
    for cls in (NeuralEmbeddingProvider, Qwen3EmbeddingProvider, NeuralReranker):
        monkeypatch.setattr(cls, "_instance", None)
    PORT.index.reset_index()            # an index of this setting's width
    startup("cpu")
    ingest_corpus(PORT)
    resp = PORT.retrieve.retrieve_evidence(
        PORT.request({"query": "ECONNRESET object store errors"}))
    notes = resp["notes"]["retrieval"]
    assert resp["quotes"] and notes["dense_error"] is None
    if "rerank_provider" in values:
        assert notes["reranked_from"] >= 1
        assert NeuralReranker.shared().device == torch.device("cpu")
    else:
        prefix = {"neural": "cadence-neural-embedder-256d4L",
                  "qwen3": "qwen3-shaped-64d2L"}[values["embeddings_provider"]]
        assert notes["dense_model_id"].startswith(prefix)


@pytest.mark.parametrize("values,message", [
    ({"dist_coordinator": "localhost:1234", "dist_num_processes": 2},
     "requires MESH_SHAPE"),
    ({"dist_coordinator": "localhost", "dist_num_processes": 2,
      "mesh_shape": "data:2"}, "cannot derive the op-log port"),
])
def test_gang_settings_raise_as_the_jax_package_does(port_store, monkeypatch,
                                                     values, message):
    """A gang without MESH_SHAPE, and a coordinator without a port (and no
    DIST_OPLOG_PORT), raise the JAX package's errors before any process
    group is joined."""
    from cadence_rag_tpu_torch.parallel import mesh
    from cadence_rag_tpu_torch.serve.api import startup

    for name, value in values.items():
        monkeypatch.setattr(PORT.settings, name, value)
    with pytest.raises(RuntimeError, match=message):
        startup("cpu")
    assert mesh.gang() is None


def test_startup_raises_for_a_store_with_a_vocab_head(port_store, monkeypatch):
    """A store with an applied vocab head starts now (startup activates it
    before it rebuilds the index); startup raises only for a head it cannot
    serve: one built for another LEXICAL_DIM, or one whose apply never
    finished."""
    from cadence_rag_tpu_torch.core import vocab
    from cadence_rag_tpu_torch.ingest import featurize
    from cadence_rag_tpu_torch.serve.api import startup

    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.0)
    store = PORT.db.get_store()
    with store.tx() as conn:
        conn.execute("INSERT INTO lex_vocab (version, head, dim, created_at, "
                     "applied, hashes) VALUES (1, 4, 1024, 'now', 1, ?)",
                     (sqlite3.Binary(np.arange(1, 5, dtype=np.uint64).tobytes()),))
    startup("cpu")
    assert featurize.active_vocab()[1] == 1 and featurize.active_vocab()[0].size == 4
    PORT.index.reset_index()
    monkeypatch.setattr(PORT.settings, "lexical_dim", 512)
    with pytest.raises(RuntimeError, match="LEXICAL_DIM=1024"):
        startup("cpu")
    monkeypatch.setattr(PORT.settings, "lexical_dim", 1024)
    PORT.index.reset_index()
    vocab.save_vocab(store, np.arange(1, 9, dtype=np.uint64), 1024)
    with pytest.raises(RuntimeError, match="never completed"):
        startup("cpu")


def test_startup_serves_what_it_used_to_refuse(port_store, monkeypatch):
    """``RERANK_ENABLED`` with the lexical provider, ``LEX_VOCAB_AUTO_REBUILD``
    and ``INDEX_MAX_DEVICE_ROWS`` start and serve."""
    from cadence_rag_tpu_torch.serve.api import startup

    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.0)
    for name, value in (("rerank_enabled", True), ("lex_vocab_auto_rebuild", True),
                        ("index_max_device_rows", 1), ("cold_block_rows", 8)):
        monkeypatch.setattr(PORT.settings, name, value)
    PORT.index.reset_index()
    client = PORT.testing.TestClient(device="cpu")
    assert client.post("/ingest/transcript",
                       json=_transcript(TEXTS, "served")).status_code == 200
    resp = client.post("/retrieve", json={"query": "ECONNRESET object store"}).json()
    assert resp["quotes"] and resp["notes"]["retrieval"]["reranked_from"] >= 1
    stats = client.get("/index/stats").json()["chunks"]
    assert stats["count"] == 1 and stats["cold_tier"]["count"] >= 1


def test_entry_points_default_to_the_card(port_store, monkeypatch):
    """``startup``, the test client and ``serve.http main`` default to
    cuda; without a card each raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from cadence_rag_tpu_torch.serve import http

    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.0)
    PORT.index.reset_index()
    with pytest.raises(RuntimeError, match="cuda"):
        PORT.testing.TestClient()
    monkeypatch.setattr(sys, "argv", ["serve", "--port", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        http.main()
    assert PORT.index._index is None


@pytest.mark.parametrize("shape", ["data:2", "data:8", "data:2,model:2"])
def test_diagnostics_name_the_mesh_as_the_jax_package_does(port_store, set_both,
                                                          monkeypatch, shape):
    """``index.mesh``: null unsharded (above), the index's axis sizes under
    ``MESH_SHAPE`` in both packages, every axis named (the JAX package's
    mesh over as many of the test process's eight CPU devices as the shape
    names)."""
    import math

    import jax

    from cadence_rag_tpu.parallel import mesh as jax_mesh

    axes = {name: int(n) for name, n in (p.split(":") for p in shape.split(","))}
    size = math.prod(axes.values())
    real = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh",
                        lambda spec=None, devices=None: real(spec, jax.devices()[:size]))
    set_both("store_sync_interval_s", 0.0)
    set_both("mesh_shape", shape)
    for pkg in (JAX, PORT):
        pkg.index.reset_index()
    clients = {JAX.root: JAX.testing.TestClient(),
               PORT.root: PORT.testing.TestClient(device="cpu")}
    port, jax = _both(clients, "GET", "/diagnostics")
    assert port.json()["index"]["mesh"] == jax.json()["index"]["mesh"] == axes


def test_profiler_port_serves_a_trace_of_what_is_served(seeded, clients, monkeypatch):
    """With ``PROFILER_PORT`` set, startup's listener answers ``GET
    /trace?ms=200`` with a Chrome trace of the process: retrieves served on
    another thread during the capture show as ``retrieve.dispatch``."""
    import json
    import socket
    import threading
    import urllib.request

    from cadence_rag_tpu_torch.serve import profiler
    from cadence_rag_tpu_torch.serve.api import startup

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setattr(PORT.settings, "profiler_port", port)
    startup("cpu")
    stop = threading.Event()
    served = []

    def serve():
        while not stop.is_set():
            served.append(clients[PORT.root].post(
                "/retrieve", json={"query": "ECONNRESET rollback v2.3.1"}).status_code)

    thread = threading.Thread(target=serve)
    thread.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/trace?ms=200", timeout=60) as resp:
            trace = json.loads(resp.read())
        with pytest.raises(urllib.error.HTTPError, match="422"):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/trace?ms=0", timeout=60)
    finally:
        stop.set()
        thread.join(60)
        profiler.stop_server()
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "retrieve.dispatch" in names, sorted(n for n in names if n)[:40]
    assert served and set(served) == {200}


def test_aiohttp_roundtrip_with_batching(seeded, monkeypatch):
    """The port's aiohttp app on a real socket: concurrent distinct
    /retrieve requests share a micro-batch; the generic routes, bad JSON
    (400) and a bad body (422) go through as in the JAX package."""
    from aiohttp.test_utils import TestClient as AioClient, TestServer

    from cadence_rag_tpu_torch.serve.http import make_app
    from cadence_rag_tpu_torch.serve.metrics import registry

    monkeypatch.setattr(PORT.settings, "retrieve_batch_window_ms", 20)
    registry.reset()

    async def scenario():
        async with AioClient(TestServer(make_app())) as client:
            health = await client.get("/health")
            assert health.status == 200 and (await health.json())["status"] == "ok"

            async def one(i):
                r = await client.post("/retrieve",
                                      json={"query": f"ECONNRESET object store {i}"})
                assert r.status == 200
                return await r.json()

            results = await asyncio.gather(*(one(i) for i in range(4)))
            bad = await client.post("/retrieve", data=b"{not json",
                                    headers={"Content-Type": "application/json"})
            invalid = await client.post("/retrieve", json={"nope": 1})
            metrics = await (await client.get("/metrics")).json()
            return results, bad.status, invalid.status, metrics

    results, bad, invalid, metrics = asyncio.run(scenario())
    assert all(body["quotes"] for body in results)
    sizes = [b["notes"]["retrieval"]["timings_ms"]["device_batch"] for b in results]
    assert max(sizes) >= 2.0
    assert (bad, invalid) == (400, 422)
    assert metrics["endpoints"]["POST /retrieve"]["count"] == 5
