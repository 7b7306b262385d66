"""``k1_roofline``: K1's least time over its device time, in the traced
window: each launch's least time (``peaks.k1_least_s``) summed, over the
launches' summed durations."""

from rag_bench import peaks
from rag_bench.metrics._kernels import launches, mean_dispatch


def read(ctx):
    shape = mean_dispatch(ctx)
    if shape is None:
        return None
    cfg = ctx["config"]
    emb_bytes = 2 if cfg["embedding_dtype"] in ("bfloat16", "float16") else 1
    least = spent = 0.0
    for ev, corpus, rows in launches(ctx, "fused_scan_kernel"):
        least += peaks.k1_least_s(rows, shape["batch"], int(cfg["embedding_dim"]),
                                  int(cfg["lexical_dim"]), emb_bytes,
                                  shape["dense"][corpus])
        spent += ev["dur"] * 1e-6
    return 100.0 * least / spent if spent > 0 else None
