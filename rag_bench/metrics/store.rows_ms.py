"""``store.rows_ms``: the ``retrieve.store_rows`` span a batch (one
SQLite read per table of every candidate row the batch's packs may
quote)."""

from rag_bench.metrics._spans import mean_ms


def read(ctx):
    return mean_ms(ctx, ("store_rows",))
