"""``k1.lex_pieces``: the lexical pieces K1 issues a 32-wide K slab, the
mean over the window's dispatches (``lex_pieces`` of the ``index.dispatch``
events, ``core/index.py``: the difference of K1's own device counter,
``ops/fused_scan.counters``, copied in stream order before and after the
dispatch's program and read with its readback, over its two launches): 1
where every bucket of a query holds one f16 weight (the fp16 route's h
alone), up to 3 (h, m and l in every slab). None where the program records
no such field."""


def read(ctx):
    pieces = [ev["lex_pieces"] for ev in ctx["spans"]
              if ev["tag"] == "index.dispatch" and "lex_pieces" in ev]
    return sum(pieces) / len(pieces) if pieces else None
