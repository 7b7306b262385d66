"""Filter resolution: RetrieveFilters -> device mask inputs.

The reference resolves external_id to call_ids and renders SQL WHERE
clauses per lane (reference: app/retrieve.py:46-120). Here every filter
becomes (a) a per-call boolean bitmap over the call registry and (b) an
epoch-second date window — the device gathers the bitmap through each
document's call index (ops/masks.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

import numpy as np

from ..core.index import INT32_MAX, INT32_MIN
from ..schemas import RetrieveFilters
from ..store.db import Store
from ..utils.timeutil import epoch_sec


@dataclasses.dataclass
class ResolvedFilters:
    allowed_calls: np.ndarray   # (call_capacity,) bool
    date_min: int
    date_max: int
    scoped: bool                # planner input (app/retrieve.py:267-274)
    call_ids: Optional[List[str]]  # resolved explicit scoping, or None
    # value for bitmap slots beyond this plan's width: the background
    # syncer can grow call capacity between planning and dispatch, and a
    # batch's plans may then hold different widths. True = the filter
    # did not constrain call seqs (new calls stay visible); False = seqs
    # were resolved explicitly (new calls are out of scope).
    pad_allowed: bool = True

    @property
    def unfiltered(self) -> bool:
        return not self.scoped

    def allowed_at(self, call_capacity: int) -> np.ndarray:
        """This plan's bitmap padded/clipped to ``call_capacity`` (the
        dispatch-time width). Without this, np.stack over mixed widths
        raises and fails the whole micro-batch, and estimate's
        ``allowed[h_call]`` gather can IndexError on rows of calls
        created after planning."""
        a = self.allowed_calls
        if a.shape[0] == call_capacity:
            return a
        out = np.full(call_capacity, self.pad_allowed, dtype=bool)
        w = min(a.shape[0], call_capacity)
        out[:w] = a[:w]
        return out


# The unfiltered request shares ONE read-only all-true bitmap: building a
# fresh np.ones(call_capacity) per plan is avoidable host work on every
# unfiltered request. Nothing downstream mutates the
# resolved bitmap (np.stack copies it into the device batch), and the
# write=False flag makes any future mutation fail loudly. Keyed by
# capacity; only the latest capacity is kept (it only grows).
_unfiltered_cache: dict = {}


def _unfiltered(call_capacity: int) -> ResolvedFilters:
    cached = _unfiltered_cache.get(call_capacity)
    if cached is None:
        allowed = np.ones(call_capacity, dtype=bool)
        allowed.setflags(write=False)
        cached = ResolvedFilters(
            allowed, int(INT32_MIN) + 1, int(INT32_MAX), False, None
        )
        _unfiltered_cache.clear()
        _unfiltered_cache[call_capacity] = cached
    return cached


def resolve_filters(
    store: Store,
    filters: Optional[RetrieveFilters],
    call_capacity: int,
) -> ResolvedFilters:
    if filters is None:
        return _unfiltered(call_capacity)

    allowed = np.ones(call_capacity, dtype=bool)
    date_min = int(INT32_MIN) + 1
    date_max = int(INT32_MAX)
    call_ids: Optional[Set[str]] = None

    if filters.call_ids:
        call_ids = {str(c) for c in filters.call_ids}

    if filters.external_id:
        with store.read() as conn:
            if filters.external_source is None:
                rows = conn.execute(
                    "SELECT call_id FROM calls WHERE external_id = ?",
                    (filters.external_id,),
                ).fetchall()
            else:
                rows = conn.execute(
                    "SELECT call_id FROM calls WHERE external_id = ? "
                    "AND COALESCE(external_source,'') = ?",
                    (filters.external_id, filters.external_source or ""),
                ).fetchall()
        resolved = {row["call_id"] for row in rows}
        call_ids = (call_ids & resolved) if call_ids else resolved

    seq_constraint: Optional[Set[int]] = None
    if call_ids is not None:
        seq_constraint = set()
        if call_ids:
            placeholders = ",".join("?" * len(call_ids))
            with store.read() as conn:
                rows = conn.execute(
                    f"SELECT call_seq FROM calls WHERE call_id IN ({placeholders})",
                    sorted(call_ids),
                ).fetchall()
            seq_constraint = {int(r["call_seq"]) for r in rows}

    if filters.call_tags:
        # inverted tag map (migration 5) — the reference's `tags && :arr`
        # GIN lookup analogue; O(matches), not a scan of all calls
        wanted = sorted({str(t) for t in filters.call_tags})
        placeholders = ",".join("?" * len(wanted))
        with store.read() as conn:
            rows = conn.execute(
                f"SELECT DISTINCT call_seq FROM call_tags "
                f"WHERE tag IN ({placeholders})",
                wanted,
            ).fetchall()
        tag_seqs: Set[int] = {int(r["call_seq"]) for r in rows}
        seq_constraint = (
            tag_seqs if seq_constraint is None else (seq_constraint & tag_seqs)
        )

    if seq_constraint is not None:
        allowed[:] = False
        for seq in seq_constraint:
            if 0 <= seq < call_capacity:
                allowed[seq] = True

    if filters.date_from:
        date_min = epoch_sec(filters.date_from)
    if filters.date_to:
        date_max = epoch_sec(filters.date_to)

    scoped = call_ids is not None or bool(
        filters.date_from or filters.date_to or filters.call_tags
    )
    return ResolvedFilters(
        allowed, date_min, date_max, scoped,
        sorted(call_ids) if call_ids is not None else None,
        pad_allowed=seq_constraint is None,
    )
