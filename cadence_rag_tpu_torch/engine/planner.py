"""Dense-lane planner: exact scan, IVF or approximate per query.

Counterpart of ``cadence_rag_tpu/engine/planner.py`` (reference
app/retrieve.py:267-287): zero candidates -> exact; scoped filters with a
masked candidate count at or under the exact-scan threshold -> exact; an
IVF index that is usable, enabled (``settings.dense_ivf_enabled``) and a
candidate count of at least ``settings.ivf_min_rows`` -> ivf; otherwise
ann. In the port "exact" is an f32 matmul plus the tie-safe exact top-k,
"ivf" the probed-cluster scan of ``ops/ivf.py``, and "ann" kernel K1's
top-1-per-group candidates (one of every 8 rows kept, then an exact top-k).
"""

from __future__ import annotations

from cadence_rag_tpu.config import settings


def choose_dense_mode(
    estimated_rows: int, scoped: bool, ivf_available: bool = False
) -> str:
    if estimated_rows <= 0:
        return "exact"
    if scoped and estimated_rows <= max(
        int(settings.embeddings_exact_scan_threshold), 0
    ):
        return "exact"
    if (
        ivf_available
        and settings.dense_ivf_enabled
        and estimated_rows >= int(settings.ivf_min_rows)
    ):
        return "ivf"
    return "ann"


def recall_target_for_ef_search(ef_search: int) -> float:
    """The reference's ef_search knob as a recall target, the same
    saturating map as the JAX planner (anchored at ef 80 ->
    ``settings.ann_recall_target``, clamped below the anchor). The port's
    ann lane has a fixed candidate partition, so the target is carried in
    the dispatch signature but does not change the scan."""
    base = float(settings.ann_recall_target)
    anchor = 80.0
    ef = max(1, int(ef_search))
    if ef <= anchor:
        return float(min(0.999, base))
    scaled = 1.0 - (1.0 - base) * (anchor / ef) ** 0.5
    return float(min(0.999, max(0.5, scaled)))
