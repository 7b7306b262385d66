"""Streaming-ingest benchmark: batched embedding + incremental device insert.

Counterpart of ``cadence_rag_tpu/evals/ingest_bench.py`` (BASELINE.md gate
config 4: "streaming ingest lane: batched embedding (batch 32) with
incremental index insert on device"). Measures end-to-end docs/sec through
the real pipeline: synthetic transcripts -> chunking + tech tokens + lexical
featurization (native C++ when built) -> store commit -> device insert ->
stub-embedder backfill in batches of 32 -> device scatter.

Usage: python -m cadence_rag_tpu_torch.evals.ingest_bench [--calls 20]
       [--utterances 40] [--device cuda|cpu]

``--device`` names where the index lives: ``cuda`` (the default) raises
without a card; ``cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

from ..device import DeviceLike, resolve_device


def run_ingest_bench(n_calls: int = 20, utterances_per_call: int = 40,
                     device: DeviceLike = "cuda") -> dict:
    from ..config import settings
    from ..core.index import get_index, reset_index
    from ..store.db import reset_store

    device = resolve_device(device)
    workdir = Path(tempfile.mkdtemp(prefix="cadence_ingest_bench_"))
    saved = {
        key: getattr(settings, key)
        for key in ("store_path", "embeddings_provider", "embeddings_base_url")
    }
    settings.store_path = str(workdir / "bench.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    reset_store()
    reset_index()
    try:
        from ..embed.pipeline import run_embedding_backfill
        from ..ingest.ingest import ingest_transcript
        from ..schemas import CallRef, ChunkingOptions, UtteranceIn

        get_index(device)
        options = ChunkingOptions()
        t0 = time.perf_counter()
        total_chunks = 0
        for call in range(n_calls):
            utts = [
                UtteranceIn(
                    speaker=f"S{u % 3}",
                    start_ts_ms=u * 4000,
                    end_ts_ms=u * 4000 + 3500,
                    text=(
                        f"utterance {u} of call {call} discussing ECONNRESET "
                        f"and v2.{call}.{u} on the object store cluster node-"
                        f"{u} with tiering to SSD and the lenovo BOM review"
                    ),
                )
                for u in range(utterances_per_call)
            ]
            _cid, _n, chunks = ingest_transcript(
                CallRef(external_id=f"bench-{call}"), utts, options
            )
            total_chunks += chunks
        ingest_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        summary = run_embedding_backfill(batch_size=32, source="ingest_bench")
        embed_s = time.perf_counter() - t0

        index = get_index()
        total_utts = n_calls * utterances_per_call
        return {
            "calls": n_calls,
            "utterances": total_utts,
            "chunks": total_chunks,
            "ingest_s": round(ingest_s, 3),
            "ingest_utterances_per_s": round(total_utts / ingest_s, 1),
            "embed_rows": summary.rows_updated,
            "embed_s": round(embed_s, 3),
            "embed_rows_per_s": round(summary.rows_updated / max(embed_s, 1e-9), 1),
            "device_chunk_count": index.chunks.count,
        }
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        reset_index()
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    parser = argparse.ArgumentParser(description="streaming ingest benchmark")
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--utterances", type=int, default=40)
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    args = parser.parse_args()
    print(json.dumps(run_ingest_bench(args.calls, args.utterances,
                                      device=args.device)))


if __name__ == "__main__":
    main()
