"""A/B of the dispatch-time readback (``READBACK_PREFETCH_ENABLED``,
``DeviceIndexManager.query_both_packed_async``): serial and pipelined
(depth 2 and 3) full-stack QPS with the setting off and on, one process.

Counterpart of ``cadence_rag_tpu/evals/cta_ab.py``. The index and store are
``evals/fullstack_profile._setup_index``'s (the port's copy of the JAX
package's ``bench.setup_index``), the requests its ``_requests`` and the
pipelined runs its ``_phase_timeline``. With the setting on, the flat
output's pinned D2H copy is enqueued behind the program at dispatch; off,
``collect_packed`` requests it. The serial trials of off and on are
interleaved, so drift on the host hits both alike.

Usage (on the card):
  python -m cadence_rag_tpu_torch.evals.cta_ab [--n 262144] [--batch 128]
      [--iters 20] [--trials 3] [--lex-dim 4096] [--device cuda|cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=262144)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--trials", type=int, default=3)
    parser.add_argument("--lex-dim", type=int, default=4096)
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    args = parser.parse_args(argv)

    from ..config import settings
    from ..device import resolve_device
    from ..engine.retrieve import retrieve_evidence_batch
    from .fullstack_profile import _phase_timeline, _requests, _setup_index
    from .rtt_probe import device_name

    device = resolve_device(args.device)
    index, workdir = _setup_index(args.n, args.lex_dim, device)
    kept = settings.readback_prefetch_enabled
    out: Dict = {"n": args.n, "batch": args.batch, "iters": args.iters}
    try:
        retrieve_evidence_batch(_requests(args.batch))  # the kernels built
        retrieve_evidence_batch(_requests(args.batch))  # warm

        def serial_trial() -> float:
            reqs = _requests(args.batch, salt=int(time.time()) % 997)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                retrieve_evidence_batch(reqs)
            return args.batch * args.iters / (time.perf_counter() - t0)

        runs = {"off": [], "on": []}
        for _ in range(args.trials):
            for tag, flag in (("off", False), ("on", True)):
                settings.readback_prefetch_enabled = flag
                runs[tag].append(round(serial_trial(), 1))
        for tag in ("off", "on"):
            out[f"serial_{tag}"] = {
                "qps_runs": runs[tag],
                "qps_median": round(float(np.median(runs[tag])), 1),
            }
        for tag, flag in (("off", False), ("on", True)):
            settings.readback_prefetch_enabled = flag
            for depth in (2, 3):
                t = _phase_timeline(args.batch, args.iters, depth)
                out[f"pipelined_{tag}_d{depth}"] = {
                    "qps": t["qps"], "enqueue_s": t["enqueue_s"],
                    "finish_s": t["finish_s"],
                    "host_idle_s": t["host_idle_s"],
                }
        out["device"] = device_name(device)
        print(json.dumps(out))
    finally:
        import shutil

        from ..core.index import reset_index
        from ..store.db import reset_store

        settings.readback_prefetch_enabled = kept
        reset_store()
        reset_index()
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
