"""``encoder.mfu``: the query encoder's share of the card's dense bf16
peak: the window's useful operations (``_encoder.useful_flop`` of each
``embed.encode`` event's ``tokens`` and ``pairs``) over its summed
``device_s`` at ``peaks.BF16_FLOP_S``. None where the program records no
such event or no configuration names the encoder."""

from rag_bench import peaks
from rag_bench.metrics._encoder import events, useful_flop


def read(ctx):
    enc = ctx["config"].get("query_encoder")
    timed = [ev for ev in events(ctx) if "device_s" in ev and "pairs" in ev]
    spent = sum(ev["device_s"] for ev in timed)
    if enc is None or spent <= 0:
        return None
    flop = sum(useful_flop(enc, ev["tokens"], ev["pairs"]) for ev in timed)
    return 100.0 * flop / (spent * peaks.BF16_FLOP_S)
