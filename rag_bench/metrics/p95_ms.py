"""``p95_ms``: the 95th percentile of the latency of every request sent in
the window, on the client's clock from send to the end of the response (a
failed request counts as the slowest)."""

from rag_bench.stats import percentile


def read(ctx):
    return percentile(ctx["latency_ms"], 95) if ctx["latency_ms"] else None
