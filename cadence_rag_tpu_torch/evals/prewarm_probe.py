"""What a background growth costs the serving thread.

Counterpart of ``cadence_rag_tpu/evals/prewarm_probe.py``. A ticker thread
runs a small device program (a 256 x 256 f32 product, read back) in a loop
and records the gaps between completions, each under the phase it ended
in; the largest gap of a phase is the worst stall that phase can cause a
query. Meanwhile the main thread does what the port's growth does at the
fill threshold, on a corpus of ``--rows`` rows held full: the
``GrowthPrewarmer`` plans the next capacity and starts the background
``GrowthMigration`` (``core/index.py``), the migration allocates the new
buffers and copies the rows on a side stream, and the insert that crosses
the capacity swaps them in.

The JAX probe's phases ``lower`` and ``compile`` (``lower_s``,
``compile_s``) time the ahead-of-time compile of the next capacity's
program; eager PyTorch compiles nothing per shape, so they have no work
here. The port's phases are named after what they do:

===========  =================================================  =========
phase        work                                               seconds
===========  =================================================  =========
idle         before any work                                    --
prewarm      ``GrowthPrewarmer.maybe_prewarm``: the plan        prewarm_s
             (``plan_next_capacity``) and the migration's start
alloc        the migration's allocation and tail fill           alloc_s
             (``index.migration_alloc``, its thread)
copy         the migration's copy (``index.migration_copy``)    copy_s
migrate      the rest of the wait for the migration to be       migrate_s
             ready (thread start, hand-over)                    (whole)
swap         the insert that crosses the capacity               swap_s
             (``index.growth_swap``; the whole insert:          (the swap)
             ``crossing_insert_s``)
post         after the swap                                     --
===========  =================================================  =========

A device allocation that misses PyTorch's cache (``cudaMalloc``) may wait for
the ticker's stream, and the copy competes with it for the device: the two
are separate phases, read from the index's own ``utils/events`` spans.
Every row held before the growth must read back after it: the probe raises
otherwise.

Usage:
  python -m cadence_rag_tpu_torch.evals.prewarm_probe [--device cuda|cpu]
      [--rows 524288] [--batch 128]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

N_CALLS = 1024
SPAN_PHASES = {"index.migration_alloc": "alloc", "index.migration_copy": "copy",
               "index.growth_swap": "swap"}
PHASES = ("idle", "prewarm", "alloc", "copy", "migrate", "swap", "post")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--rows", type=int, default=524288)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--dim", type=int, default=1024)
    parser.add_argument("--lex-dim", type=int, default=4096)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, args.rows, args.batch, args.dim,
                         args.lex_dim)))


def run(device="cuda", rows: int = 524288, batch: int = 128, dim: int = 1024,
        lex_dim: int = 4096) -> Dict:
    from ..config import settings
    from ..core.index import DocRow, get_index, reset_index
    from ..device import resolve_device
    from ..utils import events
    from .rtt_probe import device_name
    from .synth import install_synthetic_corpus

    dev = resolve_device(device)
    settings.embeddings_dim = dim
    settings.lexical_dim = lex_dim
    settings.index_initial_capacity = 4096
    settings.index_max_device_rows = 0
    settings.growth_migration_enabled = True
    # the prewarmer fires once the corpus is full at this size
    settings.prewarm_growth_enabled = True
    settings.prewarm_fill_fraction = 0.75
    settings.prewarm_min_capacity = min(int(settings.prewarm_min_capacity), rows)
    reset_index()
    index = get_index(dev)
    index.ensure_call_capacity(N_CALLS)
    index.prewarmer.note_batch(batch)
    corpus = index.chunks
    install_synthetic_corpus(corpus, rows, N_CALLS, seed=0)
    install_synthetic_corpus(index.artifacts, 1024, N_CALLS, seed=1)
    count0, cap0 = corpus.count, corpus.capacity
    sample = torch.linspace(0, count0 - 1, min(4096, count0), device=dev).long()
    kept = [t[sample].clone() for t in corpus.device_arrays()]

    x = torch.ones((256, 256), dtype=torch.float32, device=dev)
    float((x @ x).sum())
    gaps = []
    stop = threading.Event()
    phase = {"name": "idle"}

    def ticker():
        last = time.monotonic()
        while not stop.is_set():
            float((x @ x).sum())   # waits for the device
            now = time.monotonic()
            gaps.append((phase["name"], now, now - last))
            last = now
            time.sleep(0.005)

    rec: Dict = {}
    events.enable()
    thread = threading.Thread(target=ticker, daemon=True, name="prewarm-ticker")
    thread.start()
    try:
        time.sleep(1.0)
        phase["name"] = "prewarm"
        t0 = time.perf_counter()
        started = index.prewarmer.maybe_prewarm()
        rec["prewarm_s"] = round(time.perf_counter() - t0, 3)
        mig = corpus._migration
        if not started or mig is None:
            raise RuntimeError("prewarm_probe: the prewarmer started no migration "
                               f"at {count0} rows of {cap0}")
        rec["cap0"], rec["new_cap"] = cap0, mig.new_cap
        phase["name"] = "migrate"
        t0 = time.perf_counter()
        if not mig.ready.wait(timeout=600):
            raise RuntimeError("prewarm_probe: the migration was not ready in 600 s")
        rec["migrate_s"] = round(time.perf_counter() - t0, 3)
        phase["name"] = "swap"
        t0 = time.perf_counter()
        vec = np.zeros(dim, np.float32)
        vec[0] = 1.0
        corpus.insert([DocRow(
            doc_id=count0 + 1, call_seq=0, started_sec=1, lex_sig=np.zeros(lex_dim, np.int8),
            lex_dl=0, lex_touched=np.zeros(0, np.int32),
            tech=np.zeros(corpus.tech_slots, np.int32), embedding=vec)])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["crossing_insert_s"] = round(time.perf_counter() - t0, 3)
        phase["name"] = "post"
        time.sleep(2.0)
    finally:
        stop.set()
        thread.join(timeout=10)
        spans = [ev for ev in events.drain() if ev["tag"] in SPAN_PHASES]
        events.disable()
    if corpus.capacity != mig.new_cap or corpus._migration is not None:
        raise RuntimeError(f"prewarm_probe: no swap (capacity {corpus.capacity}, "
                           f"target {mig.new_cap})")
    got = [t[sample] for t in corpus.device_arrays()]
    if not (all(torch.equal(g, w) for g, w in zip(got, kept))
            and corpus.count == count0 + 1 and corpus.contains([count0 + 1])[0]):
        raise RuntimeError("prewarm_probe: rows were lost across the growth")
    windows = [(SPAN_PHASES[ev["tag"]], ev["t"] - ev["s"], ev["t"]) for ev in spans]
    for ev in spans:
        rec[SPAN_PHASES[ev["tag"]] + "_s"] = ev["s"]

    def phase_of(name, at):
        for span, lo, hi in windows:
            if lo <= at <= hi:
                return span
        return name

    by_phase: Dict[str, list] = {}
    for name, at, gap in gaps:
        by_phase.setdefault(phase_of(name, at), []).append(gap)
    for name in PHASES:
        ph = by_phase.get(name)
        if ph:
            rec[f"tick_gap_{name}_p50_ms"] = round(float(np.percentile(ph, 50)) * 1e3, 3)
            rec[f"tick_gap_{name}_max_ms"] = round(float(max(ph)) * 1e3, 3)
            rec[f"ticks_{name}"] = len(ph)
    rec["rows_kept"] = True
    rec["platform"] = dev.type
    rec["device"] = device_name(dev)
    reset_index()
    return rec


if __name__ == "__main__":
    main()
