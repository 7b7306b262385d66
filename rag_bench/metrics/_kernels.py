"""Shared by the roofline readers: a kernel's launches in the traced
window, each with the corpus it scanned.

A launch's rows are its grid's first dimension times 1024 (K1 and K3 both
give a CTA 1024 rows), which names the corpus by its capacity; its batch is
the mean batch of the window's dispatches, which sets only the filter
mask's share of K1's bytes and K3's compares.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

from rag_bench.traffic import corpus as gen

CTA_ROWS = 1024


def launches(ctx: Dict[str, Any], needle: str
             ) -> Iterator[Tuple[Dict[str, Any], str, int]]:
    """-> (kernel event, corpus, rows) for each launch whose name holds
    ``needle``."""
    trace = ctx.get("trace")
    if not trace:
        return
    caps = {gen.capacity(ctx["config"], c): c for c in gen.CORPORA}
    for ev in trace["kernels"]:
        if needle not in ev["name"] or not ev.get("grid"):
            continue
        rows = int(ev["grid"][0]) * CTA_ROWS
        corpus = caps.get(rows)
        if corpus is not None:
            yield ev, corpus, rows


def mean_dispatch(ctx: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The traced window's dispatches: mean batch, mean nonzero tech
    columns a batch, widest tech query, and each corpus's dense flag."""
    ds = ctx.get("dispatches") or []
    if not ds:
        return None
    return {
        "batch": sum(d["batch"] for d in ds) / len(ds),
        "nonzero": sum(d["nonzero"] for d in ds) / len(ds),
        "width": sum(d["width"] for d in ds) / len(ds),
        "dense": {"chunks": all(d["dense"] and d["chunk_mode"] == "ann" for d in ds),
                  "artifacts": all(d["dense"] and d["artifact_mode"] == "ann"
                                   for d in ds)},
    }
