"""In-process operational event log (bounded ring buffer).

Counterpart of ``cadence_rag_tpu/utils/events.py``: the index records what
its slow operations (growth, inserts) did and how long they took, and the
serving path what each request, batch and dispatch spent where
(``http.request``, ``batcher.batch``, the engine's ``retrieve.<stage>``
spans, ``index.dispatch``, the Qwen3 provider's ``embed.encode``), so that
a harness can drain the ring beside its latency samples. Costs one bool
check when disabled (the default); never used for control flow.

Times are ``time.monotonic()`` seconds. An event's ``t`` is when it was
recorded, a span's end, so ``t - s`` is its start; ``s`` is a span's wall
time and ``cpu`` the CPU time its thread used inside it
(``time.thread_time``), both to the microsecond: ``s - cpu`` is the time
the thread spent off the CPU (waiting for the interpreter lock, preempted,
or blocked). While the ring is enabled a ``gc.callbacks`` hook adds every
garbage collection's seconds, on any thread, to ``gc_seconds()``; it
records no event of its own, so gen-0 collections cannot flood the ring.

The ring takes no lock: ``deque.append`` and ``deque.popleft`` are atomic,
so a collection that runs in the middle of ``drain`` or ``record``, and
calls back into ``record``, neither deadlocks nor loses an event.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

_MAX = 8192
_events: "deque[Dict]" = deque(maxlen=_MAX)
_enabled = False
_gc_s = 0.0
_gc_t0: Optional[float] = None


def enabled() -> bool:
    return _enabled


def gc_seconds() -> float:
    """Seconds the garbage collector ran while the ring was enabled, summed
    since the process started."""
    return _gc_s


def _on_gc(phase: str, info: Dict) -> None:
    # collections never overlap: the collector runs one at a time, under
    # the interpreter lock
    global _gc_s, _gc_t0
    if phase == "start":
        _gc_t0 = time.perf_counter()
    elif _gc_t0 is not None:
        _gc_s += time.perf_counter() - _gc_t0
        _gc_t0 = None


def enable() -> None:
    global _enabled
    _events.clear()
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    _enabled = True


def disable() -> None:
    global _enabled, _gc_t0
    _enabled = False
    try:
        gc.callbacks.remove(_on_gc)
    except ValueError:      # not enabled, or disabled by another thread
        pass
    _gc_t0 = None


def record(tag: str, dur_s: Optional[float] = None, **kw) -> None:
    if not _enabled:
        return
    ev = {"t": time.monotonic(), "tag": tag}
    if dur_s is not None:
        ev["s"] = round(float(dur_s), 6)
    if kw:
        ev.update(kw)
    _events.append(ev)


@contextmanager
def timed(tag: str, **kw):
    if not _enabled:
        yield
        return
    # the CPU interval nests inside the wall one: cpu <= s
    t0 = time.monotonic()
    c0 = time.thread_time()
    try:
        yield
    finally:
        cpu = time.thread_time() - c0
        record(tag, time.monotonic() - t0, cpu=round(cpu, 6), **kw)


def drain(*, t0: Optional[float] = None,
          min_s: Optional[float] = None) -> List[Dict]:
    """Take every event recorded so far, oldest first. ``t0`` rebases
    timestamps; ``min_s`` keeps only events at least that long (events
    without a duration always pass). An event recorded while this runs is
    taken now or left for the next drain."""
    evs = []
    while True:
        try:
            evs.append(_events.popleft())
        except IndexError:
            break
    if t0 is not None:
        for ev in evs:
            ev["t"] = round(ev["t"] - t0, 3)
    if min_s is not None:
        evs = [ev for ev in evs if "s" not in ev or ev["s"] >= min_s]
    return evs
