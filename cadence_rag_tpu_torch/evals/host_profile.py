"""Host-side profile of the full-stack /retrieve path.

Counterpart of ``cadence_rag_tpu/evals/host_profile.py``. Answers "where do
the non-device milliseconds go" for ``retrieve_evidence_batch`` at benchmark
scale: cProfile over the warm serving loop, reporting top functions by
cumulative and self time plus the per-phase timings the engine already
stamps (embed_ms, device_ms, pack_ms).

Usage:
  python -m cadence_rag_tpu_torch.evals.host_profile [--chunks 1000000]
      [--batch 64] [--iters 10] [--style ids_only] [--lex-dim 4096]
      [--device cuda|cpu]

The first batch (kernel build on a fresh card, allocator warm-up) is timed
as "compile+first" and kept out of the profile, which covers only warm
iterations. ``--device`` names where the index lives: ``cuda`` (the
default) raises without a card; ``cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--chunks", type=int, default=1_000_000)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--style", default="ids_only",
                        choices=["ids_only", "evidence_pack_json"])
    parser.add_argument("--lex-dim", type=int, default=4096)
    parser.add_argument("--top", type=int, default=35)
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    args = parser.parse_args(argv)

    from ..config import settings
    from ..core.index import get_index, reset_index
    from ..device import resolve_device
    from ..store.db import get_store, reset_store
    from .synth import bulk_store_rows, install_synthetic_corpus

    device = resolve_device(args.device)
    workdir = Path(tempfile.mkdtemp(prefix="cadence_prof_"))
    settings.store_path = str(workdir / "bench.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    settings.lexical_dim = args.lex_dim
    settings.index_initial_capacity = 4096
    settings.rerank_enabled = False
    reset_store()
    reset_index()
    try:
        index = get_index(device)
        index.ensure_call_capacity(1024)
        n_art = max(args.chunks // 10, 1024)
        t0 = time.perf_counter()
        install_synthetic_corpus(index.chunks, args.chunks, 1024, seed=0)
        install_synthetic_corpus(index.artifacts, n_art, 1024, seed=1)
        if args.style != "ids_only":
            bulk_store_rows(get_store(), args.chunks, n_art, 1024)
        print(f"setup {time.perf_counter() - t0:.1f}s", flush=True)

        from ..engine.retrieve import retrieve_evidence_batch
        from ..schemas import RetrieveRequest

        queries = [
            "ECONNRESET rollback on the object store gateway",
            "tiering latency cluster retry budget",
            "lenovo bake-off azure rollout",
            "v2.3.1 gateway retry",
        ]
        reqs = [
            RetrieveRequest(query=queries[i % len(queries)],
                            return_style=args.style, debug=True)
            for i in range(args.batch)
        ]
        t0 = time.perf_counter()
        out = retrieve_evidence_batch(reqs)  # first batch
        print(f"compile+first {time.perf_counter() - t0:.1f}s", flush=True)
        retrieve_evidence_batch(reqs)  # warm

        # engine-stamped phase timings from one warm run
        out = retrieve_evidence_batch(reqs)
        dbg = out[0].get("debug") or {}
        print("engine timings_ms:",
              json.dumps(dbg.get("timings_ms", {}), default=float), flush=True)

        reqs_plain = [
            RetrieveRequest(query=queries[i % len(queries)],
                            return_style=args.style)
            for i in range(args.batch)
        ]
        retrieve_evidence_batch(reqs_plain)

        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(args.iters):
            retrieve_evidence_batch(reqs_plain)
        prof.disable()
        total = time.perf_counter() - t0
        qps = args.batch * args.iters / total
        print(f"profiled {args.iters} iters: {total:.2f}s  "
              f"{qps:.1f} QPS (profiler overhead included)", flush=True)

        for sort in ("cumulative", "tottime"):
            buf = io.StringIO()
            stats = pstats.Stats(prof, stream=buf)
            stats.sort_stats(sort).print_stats(args.top)
            text = buf.getvalue()
            # strip the long header boilerplate
            lines = text.splitlines()
            start = next(i for i, ln in enumerate(lines) if "ncalls" in ln)
            print(f"\n===== top by {sort} =====")
            print("\n".join(lines[start:start + args.top + 1]), flush=True)
    finally:
        reset_store()
        reset_index()
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
