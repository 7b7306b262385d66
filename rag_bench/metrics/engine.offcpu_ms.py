"""``engine.offcpu_ms``: the engine thread's time off the CPU inside its
host stages, a batch: wall seconds less the thread's CPU seconds (``s`` -
``cpu`` of each ``retrieve.<stage>`` span of ``HOST_STAGES``,
``utils/events.timed``): the wait for the interpreter lock, preemption and
blocking calls. None where the spans carry no ``cpu``."""

from rag_bench.metrics._spans import HOST_STAGES


def read(ctx):
    spans = ctx["spans"]
    tags = {f"retrieve.{s}" for s in HOST_STAGES}
    timed = [ev for ev in spans if ev["tag"] in tags and "cpu" in ev]
    batches = sum(1 for ev in spans if ev["tag"] == "retrieve.plan")
    if not timed or not batches:
        return None
    return 1e3 * sum(ev["s"] - ev["cpu"] for ev in timed) / batches
