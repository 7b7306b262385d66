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

from ..config import settings


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


# Recall@10 of the port's ``ann`` lane (kernel K1's fixed candidate
# partition, one winner of every 8 rows, then an exact top-k) against the
# masked exact scan: ``chip_smoke.py``'s recall phase (the ANN recall gate,
# 1,048,576 clustered 1024-d rows, 64 queries) on an NVIDIA H100 80GB HBM3
# at a 700 W power limit. (filter density, mask shape) -> recall@10. That
# phase reads these cases on the card in every run and fails if one falls
# below its entry here by more than one neighbour of the 640 (a tie taken
# in another order); the gate's own floor is 0.95.
MEASURED_ANN_RECALL = (
    ((1.0, "contiguous"), 1.0000),
    ((0.003, "contiguous"), 0.9922),
    ((0.05, "random"), 1.0000),
)


def expected_recall_for_ef_search(ef_search: int) -> float:
    """The recall@10 the ``ann`` lane was measured to deliver: the lowest
    entry of ``MEASURED_ANN_RECALL``, for every ``ef_search``. Counterpart
    of the JAX planner's calibrated lookup, but flat: ``ef_search`` does
    not move the port's scan. The JAX package feeds the knob's recall
    target to ``lax.approx_max_k``; the port's ann lane is K1's fixed
    partition, which no target widens or narrows, so a larger ef buys no
    recall and a smaller one saves no time."""
    del ef_search
    return min(recall for _case, recall in MEASURED_ANN_RECALL)
