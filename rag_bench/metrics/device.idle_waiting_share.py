"""``device.idle_waiting_share``: the share of the traced window in which
no kernel runs on the card and the engine thread is in none of its
``retrieve.<stage>`` spans: the card idle while the engine waits for a
batch from the batcher. The idle intervals are rebuilt from the trace's
kernels (its gaps hold only the longest ten), so copies and sets count as
idle here, unlike in ``device.idle_share``."""


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0 or not trace["kernels"]:
        return None
    lo, hi = trace["lo_us"], trace["hi_us"]
    engine = [((ev["t"] - ev["s"]) * 1e6, ev["t"] * 1e6) for ev in ctx["spans"]
              if ev["tag"].startswith("retrieve.") and "s" in ev]
    if not engine:
        return None
    kernels = [(k["ts"], k["ts"] + k["dur"]) for k in trace["kernels"]]
    covered = _union((max(a, lo), min(b, hi)) for a, b in kernels + engine
                     if min(b, hi) > max(a, lo))
    return 100.0 * (1.0 - covered / (hi - lo))
