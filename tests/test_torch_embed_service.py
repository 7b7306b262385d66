"""The /embed service, JAX package vs port, on the CPU.

``tests/integration/test_embed_service.py`` runs against the port as it
stands (``torch_parity.mirror_tests``: the wire contract with the stub, and
the port's HTTP provider consuming its own service). Then both packages'
services serve the committed ``tuned_small_v1.npz`` with ``--provider
neural`` on the same texts: the same model id and vectors within 1e-5 (the
port's plain path against XLA's bf16-operand products, summed in another
order); the port's backfill through its HTTP provider stores the in-process
provider's vectors; and without a card the service's default device raises.
"""

import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import BOTH, PORT, mirror_tests, port_store, set_both  # noqa: F401

VEC_ATOL = 1e-5
TUNED = str(Path(__file__).resolve().parent.parent / "artifacts" / "embedder" /
            "tuned_small_v1.npz")
TEXTS = ["the ledger replica fell behind after the failover",
         "rolling back to v2.3.1 stopped the resets on billing-api",
         "quota broker throttled the export runner overnight",
         "x"]


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_tests(globals(), "embed_service", "integration/test_embed_service.py")


def test_the_mirrored_tests_ran_against_the_port():
    mirrored = [n for n in globals() if n.startswith("Test_embed_service_")]
    assert sorted(mirrored) == ["Test_embed_service_EmbedService",
                                "Test_embed_service_SelfHostingLoop"]


def _neural(port_store, set_both, monkeypatch):
    from cadence_rag_tpu.models.embedder import NeuralEmbeddingProvider as JaxNeural
    from cadence_rag_tpu_torch.models.embedder import NeuralEmbeddingProvider

    set_both("embedder_params_path", TUNED)
    set_both("embeddings_dim", 1024)
    for cls in (JaxNeural, NeuralEmbeddingProvider):
        monkeypatch.setattr(cls, "_instance", None)
    PORT.index.reset_index()            # an index of the artifact's width
    PORT.index.get_index("cpu")


async def _post(app, texts):
    from aiohttp.test_utils import TestClient, TestServer

    async with TestClient(TestServer(app)) as client:
        health = await (await client.get("/health")).json()
        resp = await client.post("/embed", json={"texts": texts})
        assert resp.status == 200
        return health, await resp.json()


def test_neural_service_matches_jax(port_store, set_both, monkeypatch):
    """The same texts through both packages' neural services: the same
    model id, vectors within ``VEC_ATOL``."""
    _neural(port_store, set_both, monkeypatch)
    got = {}
    for pkg in BOTH:
        module = __import__(f"{pkg.root}.serve.embed_service",
                            fromlist=["make_embed_app"])
        kwargs = {"device": "cpu"} if pkg is PORT else {}
        got[pkg.root] = asyncio.run(_post(module.make_embed_app("neural", **kwargs),
                                          TEXTS))
    (jh, jb), (th, tb) = got["cadence_rag_tpu"], got["cadence_rag_tpu_torch"]
    assert th == jh and tb["model"] == jb["model"] == "cadence-neural-embedder-128d2L-tuned"
    want = np.asarray(jb["embeddings"], np.float32)
    have = np.asarray(tb["embeddings"], np.float32)
    assert have.shape == want.shape == (len(TEXTS), 1024)
    np.testing.assert_allclose(have, want, atol=VEC_ATOL, rtol=0)


def test_backfill_through_own_neural_service(port_store, set_both, monkeypatch):
    """The port's HTTP provider pointed at the port's neural service over a
    real socket: the backfill stores the in-process provider's vectors."""
    import threading

    from aiohttp.test_utils import TestServer

    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu_torch.ingest.ingest import ingest_transcript
    from cadence_rag_tpu_torch.models.embedder import NeuralEmbeddingProvider
    from cadence_rag_tpu_torch.schemas import CallRef, ChunkingOptions, UtteranceIn
    from cadence_rag_tpu_torch.serve.embed_service import make_embed_app
    from cadence_rag_tpu_torch.store.db import get_store

    _neural(port_store, set_both, monkeypatch)
    started, holder = threading.Event(), {}

    def run_server():
        loop = asyncio.new_event_loop()
        server = TestServer(make_embed_app("neural", device="cpu"))
        loop.run_until_complete(server.start_server())
        holder.update(port=server.port, loop=loop, server=server)
        started.set()
        loop.run_forever()
        loop.run_until_complete(server.close())
        loop.close()

    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    assert started.wait(timeout=60)
    try:
        monkeypatch.setattr(port_store, "embeddings_provider", "http")
        monkeypatch.setattr(port_store, "embeddings_base_url",
                            f"http://127.0.0.1:{holder['port']}")
        call_id, _n, n_chunks = ingest_transcript(
            CallRef(external_id="loop-neural"),
            [UtteranceIn(speaker="A", start_ts_ms=i * 1000, end_ts_ms=i * 1000 + 900,
                         text=t) for i, t in enumerate(TEXTS[:3])],
            ChunkingOptions(target_tokens=5, max_tokens=40, overlap_tokens=0))
        summary = run_embedding_backfill(batch_size=2, call_id=call_id)
    finally:
        holder["loop"].call_soon_threadsafe(holder["loop"].stop)
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert summary.rows_updated == n_chunks == 3
    assert summary.model_used == "cadence-neural-embedder-128d2L-tuned"
    with get_store().read() as conn:
        rows = conn.execute("SELECT text, embedding FROM chunks WHERE call_id = ? "
                            "ORDER BY chunk_id", (call_id,)).fetchall()
    stored = np.stack([np.frombuffer(r["embedding"], np.float32) for r in rows])
    local = NeuralEmbeddingProvider(device="cpu").embed([r["text"] for r in rows])
    np.testing.assert_allclose(stored, local.vectors, atol=VEC_ATOL, rtol=0)


def test_neural_service_defaults_to_the_card(port_store, set_both, monkeypatch):
    """``--device`` defaults to ``cuda``: without a card the neural service
    raises at startup instead of serving from the CPU; the stub needs no
    device."""
    import sys

    from cadence_rag_tpu_torch.serve import embed_service

    _neural(port_store, set_both, monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        embed_service.make_embed_app("neural")
    embed_service.make_embed_app("stub")
    monkeypatch.setattr(sys, "argv", ["embed_service"])
    seen = {}
    monkeypatch.setattr(embed_service, "make_embed_app",
                        lambda provider, device: seen.update(p=provider, d=device))
    monkeypatch.setattr("aiohttp.web.run_app", lambda app, **kw: seen.update(kw))
    embed_service.main()
    assert seen["p"] == "neural" and seen["d"] == "cuda" and seen["port"] == 9090
