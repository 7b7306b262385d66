"""Filter scoping as a (B, N) bool plane.

Counterpart of ``cadence_rag_tpu/ops/masks.py``: every supported filter is
call-level, so a filter is a per-query bitmap over the call registry
gathered through each row's call index, plus a date range over call-start
seconds. Rows whose ``started_sec`` is ``INT32_MIN`` are invalid (padding
and tombstones) and never match.
"""

from __future__ import annotations

import torch

INT32_MIN = -2147483648
INT32_MAX = 2147483647


def filter_mask(
    call_idx: torch.Tensor,       # (N,) int32 index into the call registry
    started_sec: torch.Tensor,    # (N,) int32; INT32_MIN marks invalid rows
    allowed_calls: torch.Tensor,  # (B, C) bool per-query call bitmap
    date_min: torch.Tensor,       # (B,) int32 inclusive
    date_max: torch.Tensor,       # (B,) int32 inclusive
) -> torch.Tensor:
    """-> (B, N) bool."""
    valid = started_sec != INT32_MIN
    in_call = allowed_calls.index_select(1, call_idx.long())
    after = started_sec[None, :] >= date_min[:, None]
    before = started_sec[None, :] <= date_max[:, None]
    return in_call & after & before & valid[None, :]
