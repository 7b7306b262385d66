"""``index.collect_ms``: the ``retrieve.collect`` span a batch: the wait on
the device program's output and the fusion after it
(``core/index.collect_packed``)."""

from rag_bench.metrics._spans import mean_ms


def read(ctx):
    return mean_ms(ctx, ("collect",))
