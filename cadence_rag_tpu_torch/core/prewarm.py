"""Growth planning: which capacity the next growth allocates, and when the
background migration toward it starts.

Counterpart of the planning half of ``cadence_rag_tpu/core/prewarm.py``.
That module also compiles the next capacity's query program ahead of time,
because XLA compiles one program per corpus capacity; eager PyTorch compiles
nothing per shape (kernels K1-K3 take the row count as a run-time argument),
so the AOT-compile half has no counterpart here and is left out. What stays:

- ``plan_next_capacity``: a doubling when the device has room for it, else
  the largest step of capacity/8 that fits, else the doubling all the same
  (the growth itself then surfaces the out-of-memory error);
- ``free_hbm_bytes``: free device memory from ``torch.cuda.mem_get_info``
  plus what PyTorch's caching allocator holds unused; None on the CPU, where
  the static ``PREWARM_HBM_BUDGET_GB`` applies instead;
- ``GrowthPrewarmer``: once a corpus passes ``PREWARM_FILL_FRACTION`` of a
  capacity of at least ``PREWARM_MIN_CAPACITY`` it plans that corpus's next
  capacity, remembers it (``growth_cap`` hands the same number to the growth
  itself) and starts the background ``GrowthMigration`` toward it
  (``core/index.py``), where the JAX prewarmer starts the migration once its
  program is warm. One migration at a time: two would hold both corpora's
  old and new buffers at once.
"""

from __future__ import annotations

import logging
import threading
from typing import TYPE_CHECKING, Dict, Optional, Set, Tuple

import torch

from ..config import settings

if TYPE_CHECKING:  # pragma: no cover
    from .index import CorpusIndex, DeviceIndexManager

logger = logging.getLogger(__name__)


def free_hbm_bytes(device: Optional[torch.device] = None) -> Optional[int]:
    """Free device memory in bytes, or None where the device reports none
    (the CPU). What CUDA reports free, plus the blocks PyTorch's
    caching allocator holds but has not handed out: an allocation can take
    either."""
    if device is None or device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(free) + max(int(cached), 0)


def _corpus_row_bytes(corpus) -> int:
    return (
        corpus.dim * corpus.emb_dtype.itemsize
        + corpus.lex_dim            # int8 signature
        + corpus.tech_slots * 4 + 16  # call/started/has_emb + slack
    )


def plan_next_capacity(corpus, need: int, batch: int = 128,
                       free: Optional[int] = None) -> int:
    """The capacity the NEXT growth should allocate: a doubling when it
    fits the device, else the largest fraction-of-capacity step (multiples
    of cap/8) that does, so growth keeps working on a nearly full device
    instead of standing down. ``free`` is the free device memory in bytes
    (default: ``free_hbm_bytes`` of the corpus's device); where the device
    reports none, the static budget applies."""
    cap = corpus.capacity
    doubled = cap
    while doubled < max(need, cap + 1):
        doubled *= 2
    row = _corpus_row_bytes(corpus)
    if free is None:
        free = free_hbm_bytes(getattr(corpus, "device", None))
    if free is None:
        budget = float(settings.prewarm_hbm_budget_gb) * (1 << 30)

        # old + new buffers coexist mid-growth; score planes grow by the
        # capacity delta
        def fits(c: int) -> bool:
            return (cap + c) * row + 3 * batch * (c - cap) * 4 <= budget
    else:
        headroom = free * 0.85  # slack for the programs' temporaries

        def fits(c: int) -> bool:
            # growth allocates a FULL new buffer set (the old one stays
            # live until the copy lands and is not part of ``free``);
            # score planes grow only by the capacity delta
            return c * row + 3 * batch * (c - cap) * 4 <= headroom
    if fits(doubled):
        return doubled
    step = max(cap // 8, 8)
    candidate = cap + step * max(1, -(-(need - cap) // step))
    best = 0
    while candidate < doubled:
        if fits(candidate):
            best = candidate  # largest fitting step wins
        candidate += step
    if best >= max(need, cap + 1):
        return best
    return doubled  # nothing fits: keep the doubling contract


class GrowthPrewarmer:
    """Plans each corpus's next capacity and starts its background
    migration. The name is the JAX package's; nothing is compiled here."""

    def __init__(self, manager: "DeviceIndexManager"):
        self._manager = manager
        self._lock = threading.Lock()
        self._batch = 128
        self._skip_warned: Set[Tuple[int, int]] = set()
        # (corpus_name, current_cap) -> the capacity the next growth
        # should allocate (and the running migration's target)
        self._planned: Dict[Tuple[str, int], int] = {}

    def note_batch(self, batch: int) -> None:
        """Record a served batch size: the planner sizes the score planes'
        growth by the largest one seen."""
        if batch > self._batch:
            self._batch = int(batch)

    def _target_caps(self) -> Tuple[int, int]:
        """Per-corpus NEXT-growth capacity: the planned one for a corpus
        near growth, the current capacity otherwise."""
        frac = float(settings.prewarm_fill_fraction)
        min_cap = int(settings.prewarm_min_capacity)

        def target(corpus: "CorpusIndex") -> int:
            cap = corpus.capacity
            if cap >= min_cap and corpus.count >= frac * cap:
                planned = plan_next_capacity(corpus, cap + 1, self._batch)
                with self._lock:
                    self._planned[(corpus.name, cap)] = planned
                return planned
            return cap

        return target(self._manager.chunks), target(self._manager.artifacts)

    def growth_cap(self, corpus: "CorpusIndex", need: int) -> int:
        """The capacity an actual growth should allocate — the planned
        target when one is recorded and still sufficient, else a fresh
        plan: the capacity growth picks is the one being migrated to."""
        with self._lock:
            planned = self._planned.get((corpus.name, corpus.capacity))
        if planned is not None and planned >= need:
            return planned
        return plan_next_capacity(corpus, need)

    def _fits(self, corpus: "CorpusIndex", cap: int) -> bool:
        """Can the device hold ``corpus`` grown to ``cap`` at all, beside
        what it holds now? (``plan_next_capacity`` answers the doubling
        when nothing fits; starting a migration toward it would only fail
        in the background.)"""
        row = _corpus_row_bytes(corpus)
        planes = 3 * self._batch * (cap - corpus.capacity) * 4
        free = free_hbm_bytes(corpus.device)
        if free is None:
            budget = float(settings.prewarm_hbm_budget_gb) * (1 << 30)
            other = (self._manager.artifacts
                     if corpus is self._manager.chunks
                     else self._manager.chunks)
            held = other.capacity * _corpus_row_bytes(other)
            return (corpus.capacity + cap) * row + held + planes <= budget
        return cap * row + planes <= free * 0.85

    def maybe_prewarm(self) -> bool:
        """Start the background migration of a corpus that is near its
        growth (the fuller one first). -> True if one was started."""
        if not settings.prewarm_growth_enabled:
            return False
        chunks, arts = self._manager.chunks, self._manager.artifacts
        chunk_cap, art_cap = self._target_caps()
        todo = []
        if chunk_cap != chunks.capacity:
            todo.append((chunks, chunk_cap, arts))
        if art_cap != arts.capacity:
            todo.append((arts, art_cap, chunks))
        if not todo:
            return False
        if len(todo) == 2 and (
            chunks.count * arts.capacity < arts.count * chunks.capacity
        ):
            todo.reverse()
        for corpus, cap, other in todo:
            if not self._fits(corpus, cap):
                if (corpus.capacity, cap) not in self._skip_warned:
                    self._skip_warned.add((corpus.capacity, cap))
                    logger.warning(
                        "prewarm.skipped_memory corpus=%s cap=%s "
                        "(provision INDEX_INITIAL_CAPACITY upfront at this "
                        "scale)", corpus.name, cap,
                    )
                continue
            # one migration at a time: two would hold BOTH corpora's
            # old+new buffer pairs
            if other._migration is not None:
                return False
            return corpus.start_migration(cap)
        return False
