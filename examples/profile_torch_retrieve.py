#!/usr/bin/env python3
"""Profile the PyTorch port's /retrieve device path on one CUDA card.

    python3 examples/profile_torch_retrieve.py [--out DIR]

Builds chip_smoke.py's index (1M synthetic chunks + 100k artifact chunks
plus known rows), then for the unscoped ("ann") and the scoped ("exact")
batch of 128 queries, and for the unscoped batch again once the chunks
have an IVF index ("ivf", built as chip_smoke.py's phase 8 builds it):
device time per warm batch by kernel name (kernel
rows of ``torch.profiler``'s ``key_averages()`` only, since an ``aten::``
row repeats the time of the kernels it launched), wall time and the
device's busy share. Last, the host split of one unscoped batch: enqueue
(``query_both_packed_async``), waiting on the device, ``collect_packed``.
Writes ``profile_main.json`` and one chrome trace per batch into DIR
(default ``chiprun_out``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

REPS = 3


def kernel_rows(prof, reps):
    """-> [(ms per batch, launches per batch, kernel name)], largest first."""
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0 and not e.key.startswith(("aten::", "cuda")):
            rows.append((dt / 1e3 / reps, e.count // reps, e.key[:110]))
    return sorted(rows, reverse=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=REPO / "chiprun_out")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 2
    opts.out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    index, texts, tokens = chip_smoke.build_index(dev, 1_000_000, 100_000, 16)
    out = {}
    for name in ("unscoped", "scoped", "ivf"):
        if name == "ivf":
            modes, args, out["ivf_index"] = chip_smoke.run_ivf_batch(
                index, texts, tokens, 128)
        else:
            args, modes, _expected = chip_smoke.plan_batch(
                index, texts, tokens, 128, name == "scoped")
        for _ in range(2):
            chip_smoke.serve_batch(index, args, modes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                chip_smoke.serve_batch(index, args, modes)
            wall_ms = (time.perf_counter() - t0) * 1e3 / REPS
        rows = kernel_rows(prof, REPS)
        dev_ms = sum(r[0] for r in rows)
        print(f"== {name} modes={modes} wall {wall_ms:.2f} ms/batch, device "
              f"kernels {dev_ms:.2f} ms/batch, busy share {dev_ms / wall_ms:.3f}")
        for ms, cnt, key in rows[:30]:
            print(f"  {ms:9.3f} ms  x{cnt:<4d} {key}")
        out[name] = {"modes": modes, "wall_ms": wall_ms, "device_ms": dev_ms,
                     "top": rows[:40]}
        prof.export_chrome_trace(str(opts.out / f"trace_{name}.json"))
    args, modes, _expected = chip_smoke.plan_batch(index, texts, tokens, 128,
                                                   False)
    split = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disp = index.query_both_packed_async(
            *args, chunk_ks=chip_smoke.CHUNK_KS,
            artifact_ks=chip_smoke.ARTIFACT_KS, chunk_mode=modes[0],
            artifact_mode=modes[1], recall_target=0.95, fuse_rrf=True)
        t1 = time.perf_counter()
        disp.done.synchronize()
        t2 = time.perf_counter()
        index.collect_packed(disp)
        t3 = time.perf_counter()
        split.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    print("enqueue / wait-device / collect ms per unscoped batch:",
          [tuple(round(x, 2) for x in r) for r in split])
    out["split_ms"] = split
    (opts.out / "profile_main.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.modules["jax"] = None  # type: ignore[assignment]
    sys.exit(main())
