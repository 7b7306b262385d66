"""``INDEX_EMBEDDING_DTYPE=int8`` on the served path, JAX package vs port,
on the CPU: the four cases of ``tests/integration/test_int8_index.py`` with
the setting on in both packages. The same corpus goes through both ingest
paths and backfills, and the engines answer the same requests: retrieved
ids identical, debug lane scores within 1e-5 (``tests/torch_parity.py``).
The port has no checkpoint module yet, so the round trip is through
``state_arrays`` / ``load_state``, within the port and from the JAX index.
"""

import numpy as np
import pytest
import torch

from torch_parity import (
    BOTH,
    JAX,
    PORT,
    assert_same_response,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)

TOPICS = [
    "object store tiering cut the checkout latency",
    "ECONNRESET storm traced to the gateway upgrade",
    "certificate expiry caused the outage window",
    "quota exhaustion throttled the export pipeline",
    "kafka consumer lag after the rebalance",
    "postgres vacuum stalls on the ledger table",
]
QUERIES = ["gateway upgrade connection resets", "certificate expiry outage",
           "kafka consumer lag", "tiering checkout latency detail 2-1"]


def test_int8_topk_matches_f32_ordering():
    """Quantized rows keep cosine units (the scale is restored) and the f32
    ranking, and the port's scores are the JAX package's."""
    import jax.numpy as jnp

    from cadence_rag_tpu.ops.topk import dense_scores as jax_scores
    from cadence_rag_tpu_torch.ops.topk import dense_scores

    rng = np.random.default_rng(0)
    docs = rng.standard_normal((2000, 64)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    qs = rng.standard_normal((8, 64)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    q8 = np.clip(np.rint(docs * 127.0), -127, 127).astype(np.int8)
    exact = dense_scores(torch.from_numpy(qs), torch.from_numpy(docs)).numpy()
    quant = dense_scores(torch.from_numpy(qs), torch.from_numpy(q8)).numpy()
    assert np.allclose(exact, quant, atol=0.05)
    for b in range(qs.shape[0]):
        top_f = set(np.argsort(-exact[b])[:10].tolist())
        top_q = set(np.argsort(-quant[b])[:10].tolist())
        assert len(top_f & top_q) >= 9, (b, top_f, top_q)
    np.testing.assert_allclose(
        quant, np.asarray(jax_scores(jnp.asarray(qs), jnp.asarray(q8))),
        rtol=0, atol=1e-5)


@pytest.fixture()
def int8_store(port_store, set_both):
    """Both packages with int8 rows: four calls of four chunks each through
    the ingest path and one artifact, then the backfill."""
    set_both("index_embedding_dtype", "int8")
    JAX.index.reset_index()
    PORT.index.reset_index()
    PORT.index.get_index("cpu")
    for pkg in BOTH:
        s = pkg.schemas
        for c in range(4):
            pkg.ingest.ingest_transcript(
                s.CallRef(external_id=f"i8-{c}"),
                [s.UtteranceIn(speaker="A", start_ts_ms=j * 1000,
                               end_ts_ms=j * 1000 + 900,
                               text=f"{TOPICS[(c + j) % len(TOPICS)]} detail {c}-{j}")
                 for j in range(4)],
                s.ChunkingOptions(target_tokens=12, max_tokens=30, overlap_tokens=0))
        # an artifact too: with either corpus empty the engine serves the
        # cold-start path, not the packed program
        pkg.ingest.ingest_analysis(s.CallRef(external_id="i8-0"), [
            s.AnalysisArtifactIn(kind="summary",
                                 content="Gateway upgrade caused the ECONNRESET storm.")])
        pkg.pipeline.run_embedding_backfill(batch_size=8)
    yield
    JAX.index.reset_index()
    PORT.index.reset_index()


def _serve(pkg, **extra):
    return pkg.retrieve.retrieve_evidence_batch(
        [pkg.request({"query": q, **extra}) for q in QUERIES])


def test_storage_dtype_and_dense_retrieval(int8_store):
    port, jax = PORT.index.get_index(), JAX.index.get_index()
    assert port.chunks.emb.dtype == torch.int8 and port.chunks.emb_rows > 0
    n = port.chunks.count
    emb = port.chunks.emb[:n].numpy()
    # genuinely quantized (not truncated to zero), and the JAX index's bytes
    assert np.abs(emb.astype(np.int32)).max() > 10
    np.testing.assert_array_equal(emb, np.asarray(jax.chunks.emb[:n]))
    for extra in ({"return_style": "ids_only"}, {"debug": True}, {}):
        got, want = _serve(PORT, **extra), _serve(JAX, **extra)
        for g, w in zip(got, want):
            assert_same_response(g, w)
    ids = _serve(PORT, return_style="ids_only")
    assert all(r["retrieved_ids"] for r in ids)
    debug = _serve(PORT, debug=True)[0]
    assert debug["notes"]["retrieval"]["lanes"]["dense"] is True
    assert debug["debug"]["lanes"]["chunks"]["dense"]


def test_state_roundtrip_preserves_int8(int8_store):
    """The checkpoint payload (``state_arrays``) restores the same int8 rows
    and the same answers, from the port's own state and from the JAX
    index's."""
    index = PORT.index.get_index()
    before = _serve(PORT, return_style="ids_only")
    emb_before = index.chunks.emb[: index.chunks.count].clone()
    for source in (index, JAX.index.get_index()):
        for name in ("chunks", "artifact_chunks"):
            state = source.corpus(name).state_arrays()
            assert state["emb"].dtype == np.int8
            index.corpus(name).load_state(state)
        assert index.chunks.emb.dtype == torch.int8
        assert torch.equal(index.chunks.emb[: index.chunks.count], emb_before)
        for g, w in zip(_serve(PORT, return_style="ids_only"), before):
            assert_same_response(g, w, want_pkg=PORT)


def test_ivf_build_under_int8(int8_store, set_both):
    """``build_ivf`` over int8 storage: k-means runs on the dequantized
    snapshot, and the probed dense mode serves the request path."""
    set_both("dense_ivf_enabled", True)
    set_both("ivf_min_rows", 4)
    index = PORT.index.get_index()
    state = index.chunks.build_ivf(n_clusters=4, nprobe=4)
    assert state.built_count == index.chunks.count and index.chunks.ivf_usable()
    cents = state.centroids.numpy()
    assert cents.dtype == np.float32
    assert 0.5 < np.linalg.norm(cents, axis=1).max() < 2.0
    # every cluster probed: the ivf lane ranks like the exact scan, so the
    # ids and evidence are the JAX engine's (which plans ann without an IVF
    # index); ivf scores with the f32 query, so its debug scores are not
    # held to the bf16-query lanes' 1e-5
    debug = _serve(PORT, debug=True)
    assert {r["notes"]["retrieval"]["dense_modes"]["chunks"] for r in debug} == {"ivf"}
    assert {r["debug"]["dense"]["modes"]["chunks"] for r in debug} == {"ivf"}
    for extra in ({}, {"return_style": "ids_only"}):
        for g, w in zip(_serve(PORT, **extra), _serve(JAX, **extra)):
            notes = g.get("notes", {}).get("retrieval")
            if notes is not None:
                for key in ("dense_modes", "planner"):
                    notes[key] = w["notes"]["retrieval"][key]
            assert_same_response(g, w)
