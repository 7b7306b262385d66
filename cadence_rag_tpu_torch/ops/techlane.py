"""The plain tech-token lane: hash-set intersection + recency order.

Counterpart of ``cadence_rag_tpu/ops/techlane.py`` (the reference's
``tech_tokens && :arr ORDER BY call_started_at DESC, id ASC``). Each row
carries S slot-addressed int32 token hashes (0 = empty); the query
structure holds, per slot, up to C hashes that could live there, so the
compare is slot-aligned: query column c*S+s against doc slot s only.

Recency keys are the int32 start seconds bitcast to f32 (same order as the
integers for non-negative seconds); ties — every chunk of one call shares
its start second — go to the lowest row, which is ``id ASC`` because rows
are appended in id order. The lane itself is ``tech_keys.tech_topk_keys``:
kernel K3 (``ops/tech_keys.py``) on the card; on the CPU its plain version,
the order keys of ``tech_key_plane`` below.
"""

from __future__ import annotations

import torch

from .topk import NEG_INF

INT32_MIN = -2147483648


def tech_match(doc_tokens: torch.Tensor, q_tokens: torch.Tensor) -> torch.Tensor:
    """(N, S) doc hashes vs (B, S*C) query structure -> (B, N) bool."""
    n_cols = q_tokens.shape[1]
    slots = doc_tokens.shape[1]
    capacity = n_cols // slots
    if capacity * slots != n_cols:
        raise ValueError(f"query width {n_cols} is not a multiple of {slots}")
    match = torch.zeros(
        (q_tokens.shape[0], doc_tokens.shape[0]), dtype=torch.bool,
        device=doc_tokens.device,
    )
    for c in range(capacity):
        for s in range(slots):
            q_col = q_tokens[:, c * slots + s]
            match |= (q_col[:, None] == doc_tokens[None, :, s]) & (
                q_col[:, None] != 0
            )
    return match


def tech_key_plane(
    doc_tokens: torch.Tensor,
    started_sec: torch.Tensor,
    q_tokens: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """(B, N) f32 recency keys; non-matching or filtered rows carry -inf."""
    match = tech_match(doc_tokens, q_tokens)
    recency = started_sec.to(torch.int32).contiguous().view(torch.float32)
    return torch.where(
        match & mask, recency[None, :].expand_as(mask),
        torch.full(mask.shape, NEG_INF, dtype=torch.float32,
                   device=mask.device),
    )

