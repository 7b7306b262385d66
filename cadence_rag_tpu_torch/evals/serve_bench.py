"""Full-stack serving benchmark: retrieve_evidence_batch end-to-end.

Counterpart of ``cadence_rag_tpu/evals/serve_bench.py``. The device program
alone is measured elsewhere; this measures the whole engine path a real
request takes — query featurization, filter resolution, planner estimates,
device dispatch (kernels K1 and K3 on the card), postprocessing, RRF, and
(for evidence packs) SQLite row fetches — so host overhead can't hide.

Usage: python -m cadence_rag_tpu_torch.evals.serve_bench [--chunks 50000]
       [--batch 64] [--iters 10] [--style ids_only|evidence_pack_json]
       [--threads 1] [--device cuda|cpu]

``--device`` names where the index lives: ``cuda`` (the default) raises
without a card; ``cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..device import DeviceLike, resolve_device

N_CALLS = 200


def _populate(n_chunks: int, n_calls: int = N_CALLS,
              device: DeviceLike = "cuda") -> None:
    """Synthetic device-side population + bulk store rows (API-level ingest
    at this scale would dominate setup time; the query path is measured).
    The first ``get_index`` names ``device``."""
    from ..core.index import get_index
    from ..store.db import get_store
    from .synth import bulk_store_rows, install_synthetic_corpus

    index = get_index(device)
    index.ensure_call_capacity(n_calls)
    n_art = max(n_chunks // 10, 16)
    install_synthetic_corpus(index.chunks, n_chunks, n_calls, seed=0)
    install_synthetic_corpus(index.artifacts, n_art, n_calls, seed=1)
    bulk_store_rows(get_store(), n_chunks, n_art, n_calls)


def _start_writer(stop_event, inserted_counter, rate_rows_s: float = 0.0,
                  device: DeviceLike = "cuda"):
    """Background ingest load: repeated slab inserts while queries run —
    measures the write path's impact on query tail latency. ``rate_rows_s``
    throttles the writer (0 = unthrottled): an unthrottled writer
    interleaves an insert dispatch per query dispatch, so a fixed rate is
    the apples-to-apples operational number. The index lives on
    ``device``."""
    import threading

    from ..core.index import DocRow, get_index

    def writer():
        from ..config import settings

        index = get_index(device)
        t_start = time.perf_counter()
        rng = np.random.default_rng(99)
        dim = int(settings.embeddings_dim)
        lex_dim = int(settings.lexical_dim)
        slots = int(settings.tech_hash_slots)
        next_id = 10_000_000
        while not stop_event.is_set():
            rows = []
            for _ in range(64):
                emb = rng.standard_normal(dim).astype(np.float32)
                emb /= np.linalg.norm(emb)
                sig = rng.integers(-4, 5, size=lex_dim).astype(np.int8)
                rows.append(DocRow(
                    doc_id=next_id, call_seq=0,
                    started_sec=1_700_000_000,
                    lex_sig=sig, lex_dl=10,
                    lex_touched=np.flatnonzero(sig)[:64].astype(np.int32),
                    tech=rng.integers(1, 5000, size=slots).astype(np.int32),
                    embedding=emb,
                ))
                next_id += 1
            index.chunks.insert(rows)
            inserted_counter[0] += len(rows)
            if rate_rows_s > 0:
                # sleep until the cumulative average matches the target
                ahead = (inserted_counter[0] / rate_rows_s
                         - (time.perf_counter() - t_start))
                if ahead > 0:
                    stop_event.wait(ahead)
        return

    thread = threading.Thread(target=writer, daemon=True)
    thread.start()
    return thread


def run_serve_bench(
    n_chunks: int, batch: int, iters: int, style: str, threads: int = 1,
    concurrent_ingest: bool = False, ingest_rate_rows_s: float = 0.0,
    device: DeviceLike = "cuda",
) -> dict:
    from ..config import settings
    from ..core.index import reset_index
    from ..store.db import reset_store

    device = resolve_device(device)
    workdir = Path(tempfile.mkdtemp(prefix="cadence_serve_bench_"))
    saved = {k: getattr(settings, k) for k in
             ("store_path", "embeddings_provider", "embeddings_base_url",
              "index_initial_capacity")}
    settings.store_path = str(workdir / "bench.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    settings.index_initial_capacity = 4096
    reset_store()
    reset_index()
    try:
        from ..engine.retrieve import retrieve_evidence_batch
        from ..schemas import RetrieveRequest

        t0 = time.perf_counter()
        _populate(n_chunks, device=device)
        setup_s = time.perf_counter() - t0

        queries = [
            "ECONNRESET rollback on the object store gateway",
            "tiering latency cluster retry budget",
            "lenovo bake-off azure rollout",
            "v2.3.1 gateway retry",
        ]
        reqs = [
            RetrieveRequest(query=queries[i % len(queries)],
                            return_style=style)
            for i in range(batch)
        ]
        retrieve_evidence_batch(reqs)  # first batch + warm
        retrieve_evidence_batch(reqs)
        import threading

        stop_event = threading.Event()
        inserted = [0]
        writer = None
        if concurrent_ingest:
            writer = _start_writer(stop_event, inserted, ingest_rate_rows_s,
                                   device=device)
        if threads > 1:
            # overlapped clients: one batch's host featurize/postprocess
            # runs while another owns the device (how the aiohttp
            # micro-batcher dispatches)
            pool = ThreadPoolExecutor(threads)
            t0 = time.perf_counter()
            futs = [pool.submit(retrieve_evidence_batch, reqs)
                    for _ in range(iters)]
            for f in futs:
                f.result()
            total = time.perf_counter() - t0
            pool.shutdown()
            stop_event.set()
            if writer is not None:
                writer.join(timeout=30)
            out = {
                "chunks": n_chunks, "batch": batch, "style": style,
                "threads": threads, "setup_s": round(setup_s, 1),
                "qps": round(batch * iters / total, 1),
            }
            if concurrent_ingest:
                out["concurrent_inserts"] = inserted[0]
                out["insert_rows_per_s"] = round(inserted[0] / total, 1)
            return out
        latencies = []
        t0 = time.perf_counter()
        for _ in range(iters):
            t1 = time.perf_counter()
            retrieve_evidence_batch(reqs)
            latencies.append(time.perf_counter() - t1)
        total = time.perf_counter() - t0
        stop_event.set()
        if writer is not None:
            writer.join(timeout=30)
        out = {
            "chunks": n_chunks,
            "batch": batch,
            "style": style,
            "setup_s": round(setup_s, 1),
            "qps": round(batch * iters / total, 1),
            "p50_batch_ms": round(float(np.percentile(latencies, 50)) * 1e3, 2),
            "p99_batch_ms": round(float(np.percentile(latencies, 99)) * 1e3, 2),
            # p99 of many iters can hide the ONE growth-copy batch; the max
            # is the honest tail for capacity-crossing runs
            "max_batch_ms": round(float(np.max(latencies)) * 1e3, 2),
            "p50_per_query_ms": round(
                float(np.percentile(latencies, 50)) * 1e3 / batch, 3
            ),
        }
        if concurrent_ingest:
            out["concurrent_inserts"] = inserted[0]
            out["insert_rows_per_s"] = round(inserted[0] / total, 1)
        return out
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        reset_store()
        reset_index()
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    parser = argparse.ArgumentParser(description="full-stack serving bench")
    parser.add_argument("--chunks", type=int, default=50_000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--style", default="ids_only",
                        choices=["ids_only", "evidence_pack_json"])
    parser.add_argument("--threads", type=int, default=1)
    parser.add_argument("--concurrent-ingest", action="store_true",
                        help="run a background slab-insert writer during "
                             "the timed loop (query p99 under write load)")
    parser.add_argument("--ingest-rate", type=float, default=0.0,
                        help="throttle the writer to N rows/s (0 = "
                             "unthrottled max-contention mode)")
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    args = parser.parse_args()
    print(json.dumps(run_serve_bench(
        args.chunks, args.batch, args.iters, args.style, args.threads,
        concurrent_ingest=args.concurrent_ingest,
        ingest_rate_rows_s=args.ingest_rate, device=args.device,
    )))


if __name__ == "__main__":
    main()
