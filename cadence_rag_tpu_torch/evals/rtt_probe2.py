"""The cost of a fresh packed-buffer upload inside a round trip: staged but
unused, staged and used, resident, and a depth-2 pipeline of fresh uploads.

Counterpart of ``cadence_rag_tpu/evals/rtt_probe2.py``, which runs at import;
the sizes are flags here (``rtt_probe.add_size_flags``), at its sizes by
default, over ``rtt_probe.PackedProbe``'s index, batch and packed program
(kernels K1 and K3 on the card). Each key is a p50 in ms over ``--iters``:

============================  ==============================  ==========================
key                           JAX probe                       here
============================  ==============================  ==========================
resident                      input already on the device     the same
fresh_upload_unused           ``jnp.asarray(packed)`` each    ``core/index._stage`` each
                              iteration, the program reads    iteration, the program reads
                              the resident buffer             the resident buffer
fresh_upload_used             the program reads the fresh     the program reads the fresh
                              upload                          upload
pipelined_fresh_per_batch_ms  depth 2 in flight, a fresh      the same, each output read
                              upload per batch (what the      back on its own when the
                              server does): wall / batches    window is full
============================  ==============================  ==========================

The staging is the port's one upload path (``_stage``: a pinned host copy
from PyTorch's caching host allocator, then a non-blocking H2D over PCIe);
the readback is the pinned D2H copy ``collect_packed`` waits for. Beside the
JAX keys, the caching allocators' part: ``stage_first_ms`` is the probe's
first ``_stage`` of the packed buffer, synchronized (its pinned buffer
allocated), ``stage_cached_ms`` a later one (reused from the cache), and
``readback_first_ms`` / ``readback_cached_ms`` the same for the first and a
later pinned readback of the output.

Usage:
  python -m cadence_rag_tpu_torch.evals.rtt_probe2 [--device cuda|cpu]
      [--rows 262144] [--artifact-rows 26214] [--batch 128] [--iters 20]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque
from typing import Dict, Optional, Sequence

from .rtt_probe import PackedProbe, add_size_flags, device_name, p50_ms


def run(device="cuda", rows: int = 262144, artifact_rows: int = 26214,
        batch: int = 128, iters: int = 20) -> Dict:
    probe = PackedProbe(device, rows, artifact_rows, batch)
    packed = probe.packed()
    rec: Dict = {}

    def stage_synced():
        probe.stage(packed)
        probe.sync()

    rec["stage_first_ms"] = p50_ms(stage_synced, 1)[0]
    rec["stage_cached_ms"] = p50_ms(stage_synced, 1)[0]
    d_res = probe.stage(packed)
    out = probe.call(d_res)
    probe.sync()
    rec["readback_first_ms"] = p50_ms(lambda: probe.fetch(out), 1)[0]
    rec["readback_cached_ms"] = p50_ms(lambda: probe.fetch(out), 1)[0]

    rec["resident"] = p50_ms(lambda: probe.fetch(probe.call(d_res)), iters)[0]

    def fresh_unused():
        staged = probe.stage(packed)   # uploaded, the program ignores it
        probe.fetch(probe.call(d_res))
        del staged

    rec["fresh_upload_unused"] = p50_ms(fresh_unused, iters)[0]
    rec["fresh_upload_used"] = p50_ms(
        lambda: probe.fetch(probe.call(probe.stage(packed))), iters)[0]

    def pipelined() -> float:
        window: deque = deque()
        t0 = time.perf_counter()
        for _ in range(iters):
            window.append(probe.call(probe.stage(packed)))
            if len(window) > 2:
                probe.fetch(window.popleft())
        while window:
            probe.fetch(window.popleft())
        return (time.perf_counter() - t0) / iters * 1e3

    rec["pipelined_fresh_per_batch_ms"] = round(pipelined(), 3)
    rec["device"] = device_name(probe.device)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    add_size_flags(parser)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, args.rows, args.artifact_rows, args.batch,
                         args.iters)))


if __name__ == "__main__":
    main()
