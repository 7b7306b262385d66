"""``engine.host_ms``: the engine thread's host time a batch, its
``retrieve.<stage>`` spans summed without ``retrieve.collect``."""

from rag_bench.metrics._spans import HOST_STAGES, mean_ms


def read(ctx):
    return mean_ms(ctx, HOST_STAGES)
