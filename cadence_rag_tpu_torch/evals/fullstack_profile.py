"""Full-stack ceiling forensics.

Counterpart of ``cadence_rag_tpu/evals/fullstack_profile.py``. Two
questions, one process (one 1M-corpus setup):

A. Does device RRF or a deeper pipeline move the full stack? Back-to-back
   A/B at N trials per configuration: device_rrf on/off x serial, and
   pipelined depth 2/3.

B. Where do the pipeline bubbles go? A per-batch phase timeline (enqueue
   window, finish window, device span) shows what the single host thread
   was doing and what it was waiting on.

Usage (on the card):
  python -m cadence_rag_tpu_torch.evals.fullstack_profile \
      [--n 1000000] [--iters 20] [--trials 5] [--device cuda|cpu]
Prints one JSON line. ``--device`` names where the index lives: ``cuda``
(the default) raises without a card; ``cpu`` must be asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..device import DeviceLike

N_CALLS = 1024


def _setup_index(n: int, lex_dim: int, device: DeviceLike = "cuda"):
    """Live index + store, populated synthetically on ``device`` (the JAX
    package's ``bench.setup_index``). -> (index, workdir)"""
    from ..config import settings
    from ..core.index import get_index, reset_index
    from ..store.db import get_store, reset_store
    from .synth import bulk_store_rows, install_synthetic_corpus

    workdir = tempfile.mkdtemp(prefix="cadence_bench_")
    settings.store_path = os.path.join(workdir, "bench.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    settings.lexical_dim = lex_dim
    settings.index_initial_capacity = 4096
    settings.rerank_enabled = False
    # the corpus is static at ~95% fill: growth planning and its background
    # migration stay off so they cannot perturb the numbers
    settings.prewarm_growth_enabled = False
    reset_store()
    reset_index()
    index = get_index(device)
    index.ensure_call_capacity(N_CALLS)
    n_art = max(n // 10, 1024)
    install_synthetic_corpus(index.chunks, n, N_CALLS, seed=0)
    install_synthetic_corpus(index.artifacts, n_art, N_CALLS, seed=1)
    if not os.environ.get("BENCH_SKIP_PACK"):
        bulk_store_rows(get_store(), n, n_art, N_CALLS)
    return index, workdir


def _phase_timeline(batch: int, iters: int, depth: int) -> Dict:
    """Pipelined serving with explicit phase boundaries. For each batch:
    e0/e1 = dispatch (host prepare + enqueue) window, f0/f1 = finish
    (block on device + fuse + assemble) window; device_ms = dispatch t0
    -> collect-return, from plan timings."""
    from collections import deque

    from ..engine.retrieve import (
        dispatch_evidence_batch,
        finish_evidence_batch,
    )

    rows: List[Dict] = []
    window: deque = deque()
    t_start = time.perf_counter()
    for i in range(iters):
        reqs = _requests(batch, salt=1000 + i)
        e0 = time.perf_counter() - t_start
        handle = dispatch_evidence_batch(reqs)
        e1 = time.perf_counter() - t_start
        window.append((i, e0, e1, handle))
        if len(window) >= depth:
            j, je0, je1, h = window.popleft()
            f0 = time.perf_counter() - t_start
            finish_evidence_batch(h)
            f1 = time.perf_counter() - t_start
            dev = h[0][0].timings.get("device_ms") if h[0] else None
            rows.append({"i": j, "e0": je0, "e1": je1, "f0": f0,
                         "f1": f1, "device_ms": dev})
    while window:
        j, je0, je1, h = window.popleft()
        f0 = time.perf_counter() - t_start
        finish_evidence_batch(h)
        f1 = time.perf_counter() - t_start
        dev = h[0][0].timings.get("device_ms") if h[0] else None
        rows.append({"i": j, "e0": je0, "e1": je1, "f0": f0, "f1": f1,
                     "device_ms": dev})
    total = time.perf_counter() - t_start
    enqueue_s = sum(r["e1"] - r["e0"] for r in rows)
    finish_s = sum(r["f1"] - r["f0"] for r in rows)
    return {
        "depth": depth,
        "qps": round(batch * iters / total, 1),
        "total_s": round(total, 3),
        "enqueue_s": round(enqueue_s, 3),
        "finish_s": round(finish_s, 3),
        # the host thread's idle time: wall not spent in either phase
        "host_idle_s": round(total - enqueue_s - finish_s, 3),
        "device_ms_p50": round(float(np.median(
            [r["device_ms"] for r in rows if r["device_ms"]]
        )), 1),
        "per_batch": rows[:12],
    }


def _requests(batch: int, salt: int = 0):
    from ..schemas import RetrieveRequest

    templates = [
        "ECONNRESET rollback on the object store gateway build {}",
        "tiering latency cluster retry budget shard {}",
        "lenovo bake-off azure rollout phase {}",
        "v2.3.{} gateway retry",
    ]
    return [
        RetrieveRequest(
            query=templates[i % 4].format(salt * 131 + i // 4),
            return_style="ids_only",
        )
        for i in range(batch)
    ]


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--trials", type=int, default=5)
    parser.add_argument("--lex-dim", type=int, default=4096)
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    args = parser.parse_args(argv)

    from ..config import settings
    from ..device import resolve_device
    from ..engine.retrieve import retrieve_evidence_batch

    index, workdir = _setup_index(args.n, args.lex_dim,
                                  resolve_device(args.device))
    out: Dict = {"n": args.n, "batch": args.batch, "iters": args.iters}
    try:
        def serial_trial() -> float:
            reqs = _requests(args.batch, salt=int(time.time()) % 997)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                retrieve_evidence_batch(reqs)
            return args.batch * args.iters / (time.perf_counter() - t0)

        # -- A: device-RRF A/B, serial + pipelined ---------------------
        for rrf_on in (True, False):
            settings.device_rrf_enabled = rrf_on
            retrieve_evidence_batch(_requests(args.batch))  # first batch
            retrieve_evidence_batch(_requests(args.batch))  # warm
            tag = "rrf_on" if rrf_on else "rrf_off"
            runs = [round(serial_trial(), 1) for _ in range(args.trials)]
            out[f"serial_{tag}"] = {
                "qps_runs": runs,
                "qps_median": round(float(np.median(runs)), 1),
            }
            for depth in (2, 3):
                t = _phase_timeline(args.batch, args.iters, depth)
                out[f"pipelined_{tag}_d{depth}_qps"] = t["qps"]
        settings.device_rrf_enabled = True

        # -- B: phase timeline at the shipping config -------------------
        out["timeline_rrf_on_d3"] = _phase_timeline(
            args.batch, max(args.iters * 2, 40), 3
        )
        print(json.dumps(out))
    finally:
        import shutil

        from ..core.index import reset_index
        from ..store.db import reset_store

        reset_store()
        reset_index()
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
