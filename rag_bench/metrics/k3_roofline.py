"""``k3_roofline``: K3's least time over its device time, in the traced
window: each launch's least time (``peaks.k3_least_s``) summed, over the
launches' summed durations."""

from rag_bench import peaks
from rag_bench.metrics._kernels import launches, mean_dispatch
from rag_bench.reference.search import lane_ks


def read(ctx):
    shape = mean_dispatch(ctx)
    if shape is None:
        return None
    cfg = ctx["config"]
    least = spent = 0.0
    for ev, corpus, rows in launches(ctx, "tech_topk_kernel"):
        least += peaks.k3_least_s(rows, int(cfg["tech_slots"]), round(shape["batch"]),
                                  round(shape["width"]), round(shape["nonzero"]),
                                  lane_ks(cfg, corpus)["tech"])
        spent += ev["dur"] * 1e-6
    return 100.0 * least / spent if spent > 0 else None
