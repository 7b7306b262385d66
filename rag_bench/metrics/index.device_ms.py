"""``index.device_ms``: the card's time for one dispatch's program, from
before its packed batch's upload to its output's readback, on CUDA events
(``device_s`` of the ``index.dispatch`` events, ``core/index.py``), the
mean over the window's dispatches. Longer than the program's kernels where
the stream waits for the host to enqueue the rest of it. None where the
program records no such event."""


def read(ctx):
    times = [ev["device_s"] for ev in ctx["spans"]
             if ev["tag"] == "index.dispatch" and "device_s" in ev]
    return 1e3 * sum(times) / len(times) if times else None
