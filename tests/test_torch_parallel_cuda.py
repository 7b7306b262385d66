"""A row-sharded index on a CUDA card whose ``INDEX_INITIAL_CAPACITY`` does
not split into shards of K1's 1024-row block: the port rounds each shard up
to the block (as growth does) and serves, where it once raised.

Needs a card, so every test here carries the ``cuda`` marker and skips
without one. Run it on the card's machine (no jax there) with:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

TEXTS = ["the ECONNRESET storm started after the object store upgrade",
         "rolling back to v2.3.1 stopped the resets immediately",
         "kafka consumer lag on broker-7 after the rebalance"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def test_capacity_3000_under_data2_serves(cuda, tmp_path, monkeypatch):
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core import index as core_index
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence
    from cadence_rag_tpu_torch.ingest.ingest import ingest_transcript
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.parallel.mesh import make_mesh
    from cadence_rag_tpu_torch.schemas import (
        CallRef, ChunkingOptions, RetrieveRequest, UtteranceIn)
    from cadence_rag_tpu_torch.store.db import reset_store

    for name, value in (("store_path", str(tmp_path / "store.db")),
                        ("embeddings_provider", "stub"),
                        ("embeddings_base_url", ""), ("embeddings_dim", 64),
                        ("lexical_dim", 1024), ("index_initial_capacity", 3000),
                        ("store_sync_interval_s", 0.0)):
        monkeypatch.setattr(settings, name, value)
    reset_store()
    # MESH_SHAPE=data:2 over the one card, each shard on it
    index = core_index.DeviceIndexManager(
        cuda, mesh=make_mesh("data:2", devices=[cuda, cuda]))
    monkeypatch.setattr(core_index, "_index", index)
    try:
        for corpus in (index.chunks, index.artifacts):
            assert corpus.capacity == 4096 and corpus.shard_rows == 2048
        utts = [UtteranceIn(speaker="Ana", start_ts_ms=i * 4000,
                            end_ts_ms=i * 4000 + 3500, text=t)
                for i, t in enumerate(TEXTS)]
        ingest_transcript(CallRef(external_id="sharded"), utts,
                          ChunkingOptions(target_tokens=8, max_tokens=16,
                                          overlap_tokens=0))
        before = fused_scan.launches
        resp = retrieve_evidence(RetrieveRequest(
            query="kafka consumer lag broker-7 rebalance"))
        torch.cuda.synchronize()
        assert fused_scan.launches > before
        assert "kafka consumer lag" in resp["quotes"][0]["snippet"]
    finally:
        reset_store()
