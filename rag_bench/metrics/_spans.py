"""Shared by the span readers: the engine's ``retrieve.<stage>`` spans.

The engine records one span per stage of each batch it serves
(``engine/retrieve.py``, ``utils/events.py``); the run keeps those of the
measured window. A batch is one ``retrieve.plan`` span.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# the stages on the engine thread's host time; retrieve.collect, the wait on
# the device and the fusion after it, is the index API's own metric
HOST_STAGES = ("plan", "tech", "featurize", "embed", "planner", "enqueue",
               "store_rows", "assemble")


def mean_ms(ctx: Dict[str, Any], stages) -> Optional[float]:
    """Milliseconds a batch in ``stages`` (summed), or None with no batch."""
    spans: List[Dict[str, Any]] = ctx["spans"]
    batches = sum(1 for ev in spans if ev["tag"] == "retrieve.plan")
    if not batches:
        return None
    tags = {f"retrieve.{s}" for s in stages}
    total = sum(ev.get("s", 0.0) for ev in spans if ev["tag"] in tags)
    return 1e3 * total / batches
