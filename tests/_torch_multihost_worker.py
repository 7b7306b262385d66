"""Worker of tests/test_torch_multihost.py's engine-level gang test: the
port's counterpart of tests/integration/_multihost_engine_worker.py.

Run as: python _torch_multihost_worker.py <pid> <coordinator> <oplog_port>
        <checkpoint_path> <gang_checkpoint_path>

Process 0 (the leader) joins the gang, installs the op-log, restores a
checkpoint onto the gang's mesh, queries while the artifacts corpus is
still empty (the cold-start path: "query_single"), runs the embedding
backfill ("scatter_emb"), queries, ingests an analysis artifact and queries
through the packed path, deletes and compacts, builds the IVF index
("build_ivf", "query_ivf"), ingests a row into its overflow tail
("ivf_overflow"), saves format v3 ("checkpoint_shards") and prints one
"RESULT {json}" line. Process 1 replays the op-log. Both run with jax and
the JAX package blocked, on the CPU (gloo).
"""

import json
import sys
from datetime import datetime, timezone

for _name in ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu"):
    sys.modules[_name] = None


def main() -> int:
    pid = int(sys.argv[1])
    coordinator = sys.argv[2]
    oplog_port = int(sys.argv[3])
    ckpt, gang_ckpt = sys.argv[4], sys.argv[5]
    from cadence_rag_tpu_torch.core.index import get_index
    from cadence_rag_tpu_torch.device import set_models_device
    from cadence_rag_tpu_torch.parallel import mesh, oplog

    mesh.init_gang(coordinator, 2, pid, "cpu")
    index = get_index("cpu")
    set_models_device("cpu")
    if pid != 0:
        oplog.follower_main(index, "127.0.0.1", oplog_port)
        return 0
    oplog.install_leader(index, oplog_port, 1)
    from cadence_rag_tpu_torch.core.checkpoint import restore_index, save_index
    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.ingest.ingest import ingest_analysis, ingest_transcript
    from cadence_rag_tpu_torch.schemas import (
        AnalysisArtifactIn, CallRef, ChunkingOptions, RetrieveRequest, UtteranceIn,
    )

    def ids(query):
        return retrieve_evidence_batch(
            [RetrieveRequest(query=query, return_style="ids_only")]
        )[0]["retrieved_ids"]

    out = {}
    restore_index(ckpt, index)
    out["counts"] = [index.chunks.count, index.artifacts.count]
    out["restored"] = ids("kafka timeout incident")
    run_embedding_backfill(batch_size=16)
    out["embedded"] = int(index.chunks.emb_rows)
    out["dense"] = ids("kafka timeout incident")
    ingest_analysis(
        CallRef(external_id="seed-0"),
        [AnalysisArtifactIn(kind="summary",
                            content="kafka incident rollback summary")],
    )
    out["packed"] = ids("kafka rollback")
    doomed = index.chunks.h_ids[: index.chunks.count][::3].tolist()
    index.chunks.delete_ids(doomed)
    index.chunks.compact()
    out["compacted_count"] = int(index.chunks.count)
    out["post_compact"] = ids("kafka timeout incident")
    state = index.chunks.build_ivf(n_clusters=8, seed=7)
    out["ivf_plan"] = [state.built_count, state.n_clusters, state.nprobe]
    out["ivf_usable"] = bool(index.chunks.ivf_usable())
    out["ivf_ids"] = ids("kafka timeout incident")
    ingest_transcript(
        CallRef(external_id="post-ivf",
                started_at=datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)),
        [UtteranceIn(speaker="B", start_ts_ms=0, end_ts_ms=4000,
                     text="cache latency deploy rollback billing")],
        ChunkingOptions(target_tokens=16, max_tokens=32, overlap_tokens=0),
    )
    out["ivf_overflow"] = int(index.chunks.ivf.overflow_count)
    out["post_overflow_ids"] = ids("kafka timeout incident")
    meta = save_index(gang_ckpt, index)
    out["saved_format"] = int(meta["format_version"])
    out["saved_counts"] = [meta["counts"]["chunks"],
                           meta["counts"]["artifact_chunks"]]
    print("RESULT " + json.dumps(out), flush=True)
    oplog.leader().shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
