"""The plain lexical lane: f32 query x int8 signatures.

Counterpart of ``cadence_rag_tpu/ops/lexical.py``. The query stays f32
(``lexical.py:31``); int8 signature values widen exactly to f32. The serving
path scores this lane inside kernel K1 (``ops/fused_scan.py``); this module
is the plain reference both for K1's plain version and for tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .topk import NEG_INF, ROW_CHUNK, topk_lowest_index_first

# Minimum lexical score to count as a match (rows sharing no feature with
# the query score ~0 from signed-hash collision noise).
LEX_MATCH_THRESHOLD = 1e-3


def lexical_scores(q_lex: torch.Tensor, lex_w: torch.Tensor) -> torch.Tensor:
    """(B, D) f32 x (N, D) int8 -> (B, N) f32 BM25 scores."""
    q = q_lex.float()
    n = lex_w.shape[0]
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=lex_w.device)
    for r0 in range(0, n, ROW_CHUNK):
        r1 = min(n, r0 + ROW_CHUNK)
        torch.matmul(q, lex_w[r0:r1].float().T, out=out[:, r0:r1])
    return out


def lexical_mask_scores(
    scores: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Scores where the filter admits the row and the row matches, else -inf."""
    keep = mask & (scores > LEX_MATCH_THRESHOLD)
    return torch.where(keep, scores, torch.full_like(scores, NEG_INF))


def lexical_topk(
    q_lex: torch.Tensor, lex_w: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked lexical top-k (the JAX lane's approx_max_k is exact
    off-TPU, so this is its CPU behaviour)."""
    masked = lexical_mask_scores(lexical_scores(q_lex, lex_w), mask)
    return topk_lowest_index_first(masked, k)
