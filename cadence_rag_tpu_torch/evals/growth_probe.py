"""Where a growth stall goes: the phases of one capacity step, timed on
the device.

Counterpart of ``cadence_rag_tpu/evals/growth_probe.py``. A corpus of
``--rows`` rows, held exactly full, takes the steps of the synchronous
growth ``CorpusIndex._grow_to`` one at a time, each waited for:

- ``corpus_alloc_cap0``: the ``CorpusIndex`` at ``--rows``;
- ``fill_on_device``: its rows filled on the device (nothing crosses PCIe);
- ``cap0`` / ``new_cap``: the next capacity, from
  ``core/prewarm.plan_next_capacity``;
- ``alloc_new``: ``_alloc_device`` at the new capacity (allocation and the
  empty rows' fill);
- ``copy_<name>``: each device array's rows copied into the new one, as
  ``_grow_to`` copies them; then the host mirrors grow;
- ``insert_new_cap_cold`` / ``insert_new_cap_warm``: the first and the second
  256-row ``_write_slab`` at the new capacity;
- ``second_growth_total``: a second step from the new capacity, whole;
- the summary.

The JAX probe's cold/warm pair separates XLA's compile at a new shape from
its run. Eager PyTorch compiles nothing per shape, so here the pair measures
the first use of a shape: the caching allocator's misses (``cudaMalloc``)
and the first launches' workspaces. Every row written before a step must
read back unchanged after it: the probe raises otherwise (``rows_kept`` in
the summary).

Usage:
  python -m cadence_rag_tpu_torch.evals.growth_probe [--device cuda|cpu]
      [--rows 524288] [--emb-dtype bfloat16]
Prints one JSON line per phase and a summary line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

INSERT_ROWS = 256
SAMPLE_ROWS = 4096


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--rows", type=int, default=524288)
    parser.add_argument("--dim", type=int, default=1024)
    parser.add_argument("--lex-dim", type=int, default=4096)
    parser.add_argument("--tech-slots", type=int, default=16)
    parser.add_argument("--emb-dtype", default="bfloat16")
    args = parser.parse_args(argv)

    from ..core.index import DEVICE_ARRAYS, CorpusIndex
    from ..core.prewarm import plan_next_capacity
    from ..device import resolve_device
    from .rtt_probe import device_name

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def phase(name, t0, **kw):
        s = round(time.perf_counter() - t0, 3)
        print(json.dumps({"phase": name, **kw, "s": s}))
        return s

    rows = args.rows
    cap0 = rows  # exactly full, so the next insert grows
    t0 = time.perf_counter()
    corpus = CorpusIndex(
        "chunks", dim=args.dim, lex_dim=args.lex_dim,
        tech_slots=args.tech_slots, capacity=cap0, device=device,
        emb_dtype=args.emb_dtype,
    )
    sync()
    phase("corpus_alloc_cap0", t0)

    # the rows' device content made on the device; host mirrors set directly
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for r0 in range(0, cap0, 131072):
        r1 = min(cap0, r0 + 131072)
        x = torch.randn((r1 - r0, args.dim), generator=gen, device=device)
        if corpus.emb_dtype == torch.int8:
            x = torch.clamp(torch.round(x * 32.0), -127, 127)
        corpus.emb[r0:r1] = x.to(corpus.emb_dtype)
    corpus.started.fill_(1)
    corpus.has_emb.fill_(True)
    sync()
    corpus.count = cap0
    corpus.h_started[:] = 1
    corpus.h_has_emb[:] = True
    corpus.h_ids[:] = np.arange(cap0)
    corpus.emb_rows = cap0
    phase("fill_on_device", t0)
    sample = torch.linspace(0, cap0 - 1, min(SAMPLE_ROWS, cap0),
                            device=device).long()
    kept = {name: getattr(corpus, name)[sample].clone() for name in DEVICE_ARRAYS}

    def rows_kept() -> bool:
        return all(torch.equal(getattr(corpus, name)[sample], want)
                   for name, want in kept.items())

    new_cap = plan_next_capacity(corpus, cap0 + 1)
    print(json.dumps({"cap0": cap0, "new_cap": int(new_cap)}))

    # -- the steps of _grow_to: allocation, then one copy per array
    t0 = time.perf_counter()
    old = corpus.device_arrays()
    corpus.capacity = new_cap
    corpus._alloc_device(new_cap)
    sync()
    t_alloc = phase("alloc_new", t0)
    copies = {}
    for name, prev in zip(DEVICE_ARRAYS, old):
        t0 = time.perf_counter()
        getattr(corpus, name)[: prev.shape[0]].copy_(prev)
        sync()
        copies[name] = phase(f"copy_{name}", t0)
    del old, prev
    corpus._grow_host_mirrors(new_cap)
    copied = rows_kept()

    # -- the first and second slab write at the new capacity
    slab = {
        "emb": corpus._encode_emb_host(np.zeros((INSERT_ROWS, args.dim), np.float32)),
        "lex": np.zeros((INSERT_ROWS, args.lex_dim), np.int8),
        "tech": np.zeros((INSERT_ROWS, args.tech_slots), np.int32),
        "call": np.zeros(INSERT_ROWS, np.int32),
        "started": np.ones(INSERT_ROWS, np.int32),
        "has": np.ones(INSERT_ROWS, bool),
    }
    for name in ("insert_new_cap_cold", "insert_new_cap_warm"):
        t0 = time.perf_counter()
        with corpus.lock:
            corpus._write_slab(corpus.count, corpus.count + INSERT_ROWS, slab)
            corpus.count += INSERT_ROWS
        sync()
        phase(name, t0)

    # -- a second step from the new capacity, whole (shapes seen before)
    cap2 = plan_next_capacity(corpus, new_cap + 1)
    if cap2 > new_cap:
        t0 = time.perf_counter()
        with corpus.lock:
            corpus._grow_to(cap2)
        sync()
        phase("second_growth_total", t0, cap2=int(cap2))
    inserted = bool((corpus.started[cap0:corpus.count] == 1).all())
    summary = {
        "alloc_s": t_alloc,
        "copies_s": copies,
        "rows_kept": bool(copied and rows_kept() and inserted),
        "platform": device.type,
        "device": device_name(device),
    }
    print(json.dumps({"summary": summary}))
    if not summary["rows_kept"]:
        raise RuntimeError("growth_probe: a row written before a growth step "
                           "did not read back after it")


if __name__ == "__main__":
    main()
