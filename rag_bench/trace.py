"""The device trace of a traced run: ``torch.profiler`` over a steady part
of the window, read back from its Chrome trace.

``Profile`` starts the profiler and records a mark on this thread at a
known ``time.monotonic()``, which ties the trace's clock to the machine's
(the client's and the event ring's times).
``read`` returns the window's device operations (kernels, copies, sets)
clipped to it, their union (``busy_s``), the top operations by summed time
and the longest idle gaps, each named by the engine stage whose span
covers most of it.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

MARK = "rag_bench.mark"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160


def warm(cuda: bool) -> None:
    """A first, empty profile: the profiler's one-time start-up (CUPTI and
    its buffers, seconds with the interpreter lock held) falls into the
    set-up, not into the traced window."""
    from torch.profiler import ProfilerActivity, profile

    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[activity]):
        x = torch.zeros(1, device="cuda" if cuda else "cpu") + 1
        if cuda:
            torch.cuda.synchronize()
    del x


class Profile:
    """The profiler over [start, ``stop``]; ``read`` exports and reads its
    trace afterwards, once the window has closed, so the export's work does
    not fall into the window. On the card only device activity is traced
    (recording every CPU operation of the engine thread would slow it
    severalfold); the mark is then a CUDA event recorded by this thread on
    a stream of its own, whose runtime call the trace holds on this
    thread's id."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = cuda
        # the trace names a thread by its system id or by its pthread id
        # (kineto writes the low 32 bits)
        ident = threading.get_ident()
        self.tids = {threading.get_native_id(), ident, ident & 0xFFFFFFFF}
        activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
        self._prof = profile(activities=[activity])
        self._prof.__enter__()
        if cuda:
            stream, event = torch.cuda.Stream(), torch.cuda.Event()
            self.mark = time.monotonic()
            event.record(stream)
        else:
            with torch.profiler.record_function(MARK):
                self.mark = time.monotonic()
        self.end = None

    def stop(self) -> None:
        self.end = time.monotonic()
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def read(self, workdir) -> Dict[str, Any]:
        fd, path = tempfile.mkstemp(suffix=".json", dir=workdir)
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return read(events, self.mark, self.end, self.tids)


def _mark_ts(events: List[Dict[str, Any]], tids) -> float:
    """The trace's time of the mark: the named CPU region, or this
    thread's first ``cudaEventRecord`` (the trace's first one where it
    names no thread of this process so)."""
    for e in events:
        if e.get("name") == MARK and e.get("ph") == "X":
            return float(e["ts"])
    records = [e for e in events if e.get("ph") == "X"
               and "EventRecord" in str(e.get("name"))]
    mine = [e for e in records if e.get("tid") in tids]
    # a trace that names threads otherwise: the first event record, which
    # follows the profiler's start by the mark's microseconds
    records = mine or records
    if not records:
        seen = sorted({(e.get("name"), e.get("tid")) for e in events
                       if e.get("cat") == "cuda_runtime"}, key=str)[:20]
        raise RuntimeError(f"the trace holds no mark on thread {tids}: {seen}")
    return min(float(e["ts"]) for e in records)


def read(events: List[Dict[str, Any]], mark_monotonic: float,
         end_monotonic: float, tids=()) -> Dict[str, Any]:
    """Trace events -> {"window_s", "busy_s", "kernels": [{name, ts, dur,
    grid}] (ts in monotonic microseconds), "top": [[name, s]], "gaps"}."""
    shift = mark_monotonic * 1e6 - _mark_ts(events, tids)
    lo, hi = mark_monotonic * 1e6, end_monotonic * 1e6
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0 = float(e["ts"]) + shift
        t1 = t0 + float(e.get("dur", 0.0))
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 > t0:
            ops.append({"name": e.get("name", "?"), "ts": t0, "dur": t1 - t0,
                        "grid": (e.get("args") or {}).get("grid"),
                        "cat": e["cat"]})
    ops.sort(key=lambda o: o["ts"])
    intervals = []
    cur0 = cur1 = None
    for o in ops:
        a, b = o["ts"], o["ts"] + o["dur"]
        if cur1 is None or a > cur1:
            if cur1 is not None:
                intervals.append((cur0, cur1))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        intervals.append((cur0, cur1))
    busy = sum(b - a for a, b in intervals)
    by_name: Dict[str, float] = {}
    for o in ops:
        by_name[o["name"]] = by_name.get(o["name"], 0.0) + o["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps, prev = [], lo
    for a, b in intervals:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    return {
        "lo_us": lo, "hi_us": hi,
        "window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
        "kernels": [o for o in ops if o["cat"] == "kernel"],
        "top": [[name[:NAME_CHARS], dur * 1e-6] for name, dur in top],
        "gaps": sorted(gaps, key=lambda g: g[0] - g[1])[:TOP],
    }


def name_gaps(gaps: List[Tuple[float, float]], spans: List[Dict[str, Any]]
              ) -> List[List[Any]]:
    """Each idle gap (monotonic microseconds) -> ["host in <stage>", s]:
    the engine span that covers most of it, or "host outside the engine"."""
    stages = [(ev["t"] * 1e6 - ev["s"] * 1e6, ev["t"] * 1e6, ev["tag"])
              for ev in spans if ev["tag"].startswith("retrieve.") and "s" in ev]
    out = []
    for a, b in gaps:
        best: Optional[str] = None
        cover = 0.0
        for s0, s1, tag in stages:
            c = min(b, s1) - max(a, s0)
            if c > cover:
                best, cover = tag, c
        what = f"host in {best}" if best else "host outside the engine"
        out.append([what, (b - a) * 1e-6])
    return out
