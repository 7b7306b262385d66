"""The port's HTTP surface against the JAX package's, on the CPU.

Both packages serve through their in-process router clients
(``serve.testing.TestClient``; the port's on ``device="cpu"``), take the same
ingest requests and answer the same reads and retrievals; one test drives
the port's aiohttp server over a real socket with the micro-batcher on. The
port's ``startup`` must raise for every setting whose feature is not ported,
and for a card that is not there; the routes it does not serve yet answer
404 and say so.
"""

import asyncio
import sqlite3
import sys

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
UNPORTED_SETTINGS = [
    ("store_sync_interval_s", 1.0, "STORE_SYNC_INTERVAL_S"),
    ("rerank_enabled", True, "RERANK_ENABLED"),
    ("dist_coordinator", "localhost:1234", "DIST_COORDINATOR"),
    ("mesh_shape", "data:4", "MESH_SHAPE"),
    ("profiler_port", 9999, "PROFILER_PORT"),
    ("embeddings_provider", "neural", "EMBEDDINGS_PROVIDER"),
    ("embeddings_provider", "qwen3", "EMBEDDINGS_PROVIDER"),
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
    assert "mesh" not in port.json()["index"]


def test_ingest_responses_match(seeded, clients):
    for pkg in (PORT, JAX):
        ext = pkg.call_ext()
        assert sorted(ext.values()) == ["api-call-1", "bare", "batch-0", "batch-1"]
    port, jax = _both(clients, "GET", "/index/stats")
    p, j = port.json(), jax.json()
    for corpus in ("chunks", "artifact_chunks"):
        for key in ("count", "capacity", "embedded", "avgdl", "lexical_dim", "dim",
                    "tombstones", "ivf_built"):
            assert p[corpus][key] == j[corpus][key], (corpus, key)
    assert p["call_capacity"] == j["call_capacity"]
    assert {"prewarm_compiled", "sync"}.isdisjoint(p)


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
    resp = clients[PORT.root].request(method, path)
    assert resp.status_code == 404
    assert "not ported" in resp.json()["detail"] and "ROADMAP" in resp.json()["detail"]


@pytest.mark.parametrize("name,value,word", UNPORTED_SETTINGS)
def test_startup_raises_for_unported_settings(port_store, monkeypatch, name, value, word):
    from cadence_rag_tpu_torch.serve.api import startup

    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.0)
    monkeypatch.setattr(PORT.settings, name, value)
    with pytest.raises(RuntimeError, match=word):
        startup("cpu")


def test_startup_raises_for_a_store_with_a_vocab_head(port_store, monkeypatch):
    from cadence_rag_tpu_torch.serve.api import startup

    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.0)
    with PORT.db.get_store().tx() as conn:
        conn.execute("INSERT INTO lex_vocab (version, head, dim, created_at, "
                     "applied, hashes) VALUES (1, 4, 1024, 'now', 1, ?)",
                     (sqlite3.Binary(b"\0" * 32),))
    with pytest.raises(RuntimeError, match="vocab"):
        startup("cpu")


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
