"""One corpus's three lanes over one filter mask.

Counterpart of ``cadence_rag_tpu/ops/fused.py``. The mask is built once per
corpus and feeds every lane:

- lexical, and dense in ``ann`` mode: kernel K1 (``ops/fused_scan.py``) —
  one pass over the corpus scores both, top-1 per group, then an exact
  top-k over the candidates;
- dense in ``exact`` mode: ``dense_scores`` (an f32 matmul over widened
  slabs, as the JAX package leaves it to XLA) and the tie-safe exact top-k;
- tech: kernel K3 (``ops/tech_keys.py``) and ``torch.topk`` over its keys.

On CPU tensors the kernels' plain versions run. Lane results are
``{name: (values f32 (B, k), positions int64 (B, k))}`` in the insertion
order lex, tech, dense that ``ops/pack.LANE_ORDER`` relies on.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .fused_scan import fused_topk
from .masks import filter_mask
from .tech_keys import tech_topk_keys
from .topk import dense_scores, masked_topk_exact

LaneResult = Tuple[torch.Tensor, torch.Tensor]


def _lanes_one_corpus(
    emb, lex_w, tech, call_idx, started_sec, has_emb,
    q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
    *, k_dense, k_lex, k_tech, dense_mode, dense_enabled,
) -> Dict[str, LaneResult]:
    mask = filter_mask(call_idx, started_sec, allowed_calls, date_min, date_max)
    dense_on = dense_enabled and dense_mode != "none"
    scan_dense = dense_on and dense_mode != "exact"
    scanned = fused_topk(
        q_emb, q_lex, emb, lex_w, mask, has_emb,
        k_dense=k_dense, k_lex=k_lex, dense=scan_dense,
    )
    out: Dict[str, LaneResult] = {"lex": scanned["lex"]}
    out["tech"] = tech_topk_keys(tech, started_sec, q_tech, mask, k_tech)
    if scan_dense:
        out["dense"] = scanned["dense"]
    elif dense_on:
        # rows without embeddings are excluded from the dense lane only
        dense_mask = mask & has_emb[None, :]
        out["dense"] = masked_topk_exact(
            dense_scores(q_emb, emb), dense_mask, k_dense
        )
    return out


def dual_corpus_retrieve(
    chunk_arrays: Sequence[torch.Tensor],
    artifact_arrays: Sequence[torch.Tensor],
    q_emb, chunk_q_lex, artifact_q_lex, q_tech, allowed_calls,
    date_min, date_max,
    *, chunk_ks: Tuple[int, int, int], artifact_ks: Tuple[int, int, int],
    chunk_mode: str = "exact", artifact_mode: str = "exact",
    dense_enabled: bool = True,
) -> Tuple[Dict[str, LaneResult], Dict[str, LaneResult]]:
    """Both corpora's six lanes (ks are (k_dense, k_lex, k_tech))."""
    chunks_out = _lanes_one_corpus(
        *chunk_arrays, q_emb, chunk_q_lex, q_tech,
        allowed_calls, date_min, date_max,
        k_dense=chunk_ks[0], k_lex=chunk_ks[1], k_tech=chunk_ks[2],
        dense_mode=chunk_mode, dense_enabled=dense_enabled,
    )
    artifacts_out = _lanes_one_corpus(
        *artifact_arrays, q_emb, artifact_q_lex, q_tech,
        allowed_calls, date_min, date_max,
        k_dense=artifact_ks[0], k_lex=artifact_ks[1], k_tech=artifact_ks[2],
        dense_mode=artifact_mode, dense_enabled=dense_enabled,
    )
    return chunks_out, artifacts_out
