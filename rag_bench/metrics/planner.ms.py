"""``planner.ms``: the ``retrieve.planner`` span a batch (the dense-mode
planner, ``core/index.estimate_candidates`` for each query)."""

from rag_bench.metrics._spans import mean_ms


def read(ctx):
    return mean_ms(ctx, ("planner",))
