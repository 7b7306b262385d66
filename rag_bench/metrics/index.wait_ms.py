"""``index.wait_ms``: the engine thread blocked on the card in
``collect_packed``, the mean over the window's dispatches (``wait_s`` of
the ``index.dispatch`` events, ``core/index.py``); ``index.collect_ms``
less this is the host's fusion after the wait. None where the program
records no such event."""


def read(ctx):
    waits = [ev["wait_s"] for ev in ctx["spans"] if ev["tag"] == "index.dispatch"]
    return 1e3 * sum(waits) / len(waits) if waits else None
