"""``batcher.queue_ms``: a request's mean wait from its arrival at the
micro-batcher to its batch starting on the engine thread (the batching
window, then the engine thread busy with the other batch): the
``batcher.batch`` events' ``queue_s`` (``serve/batcher.py``) summed, over
their ``size`` summed. None where the program records no such event."""


def read(ctx):
    batches = [ev for ev in ctx["spans"] if ev["tag"] == "batcher.batch"]
    size = sum(ev["size"] for ev in batches)
    return 1e3 * sum(ev["queue_s"] for ev in batches) / size if size else None
