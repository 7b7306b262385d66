"""``encoder.device_ms``: the card's time for one query batch's encoder
forward, on CUDA events around it on its stream (``device_s`` of the
``embed.encode`` events, ``models/qwen3.py``), the mean over the window's
batches. None where the program records no such event."""

from rag_bench.metrics._encoder import events


def read(ctx):
    times = [ev["device_s"] for ev in events(ctx) if "device_s" in ev]
    return 1e3 * sum(times) / len(times) if times else None
