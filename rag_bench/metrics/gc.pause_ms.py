"""``gc.pause_ms``: the garbage collector's time, on any thread, a batch:
each ``batcher.batch`` event's ``gc_s`` (the collections since the
batcher's previous batch, ``utils/events.py``'s hook) summed, over the
batches. None where the program records no such event."""


def read(ctx):
    batches = [ev for ev in ctx["spans"] if ev["tag"] == "batcher.batch"]
    return 1e3 * sum(ev["gc_s"] for ev in batches) / len(batches) if batches else None
