"""``encoder.pad_share``: the share of the positions the query encoder
computed that were padding: 100 x (1 - real tokens / batch x sequence
bucket), summed over the window's ``embed.encode`` events. None where the
program records no such event."""

from rag_bench.metrics._encoder import events


def read(ctx):
    evs = events(ctx)
    positions = sum(ev["positions"] for ev in evs)
    if not positions:
        return None
    return 100.0 * (1.0 - sum(ev["tokens"] for ev in evs) / positions)
