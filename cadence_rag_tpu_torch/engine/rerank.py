"""Rerank lane: rescore the fused top candidates before pack assembly.

Counterpart of ``cadence_rag_tpu/engine/rerank.py``. Providers:

- ``lexical``: deterministic full-precision BM25 rescoring of the candidate
  set (f32 dot of the query idf vector with each candidate's stored
  signature, plus an exact tech-token overlap bonus) — no weights needed,
  gate-stable, the default;
- ``neural``: banded hybrid — the lexical teacher's score quantized to
  bands of ``TEACHER_BAND`` is the primary key, and the cross-encoder
  (``models/reranker.py``, ``RERANKER_PARAMS_PATH``) breaks ties within a
  band, so gold candidates that the teacher separates by more than a band
  keep their order;
- ``neural_raw``: the cross-encoder alone.

The cross-encoder runs on the device the process's entry point named
(``device.models_device()``).

Fused RRF order breaks ties for equal rerank scores (stable sort).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..ingest import featurize
from ..ingest.chunking import extract_tech_tokens
from ..store.db import get_store

TECH_OVERLAP_BONUS = 2.0
RankedItem = Tuple[int, Set[str], float]  # (doc_id, lane_hits, rrf_score)
# teacher-score quantization for the hybrid provider: int8-quantized
# signatures make sub-0.25 lexical score differences noise
TEACHER_BAND = 0.25


def _lexical_scores(
    query: str, table: str, id_col: str, text_col: str,
    doc_ids: Sequence[int], doc_freq: np.ndarray, n_docs: int,
) -> Dict[int, float]:
    store = get_store()
    placeholders = ",".join("?" * len(doc_ids))
    with store.read() as conn:
        rows = conn.execute(
            f"SELECT {id_col} AS i, lex_sig, tech_tokens FROM {table} "
            f"WHERE {id_col} IN ({placeholders})",
            [int(d) for d in doc_ids],
        ).fetchall()
    q_vec = featurize.query_lexical_vector(query, doc_freq, n_docs)
    q_tokens = {t.lower() for t in extract_tech_tokens(query)}
    scores: Dict[int, float] = {}
    for row in rows:
        sig = (
            np.frombuffer(row["lex_sig"], dtype=np.int8).astype(np.float32)
            if row["lex_sig"] else
            np.zeros_like(q_vec)
        )
        if sig.shape[0] != q_vec.shape[0]:
            sig = np.zeros_like(q_vec)
        score = float(q_vec @ sig)
        doc_tokens = {
            t.lower() for t in (json.loads(row["tech_tokens"]) or [])
        }
        score += TECH_OVERLAP_BONUS * len(q_tokens & doc_tokens)
        scores[int(row["i"])] = score
    return scores


def prior_for_texts(
    query: str, texts: Sequence[str], doc_freq: np.ndarray, n_docs: int,
    avgdl: float = 400.0,
) -> np.ndarray:
    """The frozen lexical prior computed from raw TEXT (training-time
    twin of ``_lexical_scores``, which reads stored signatures): BM25
    signature dot + exact tech-token overlap bonus. Same featurizer,
    same value the serving path feeds the prior-residual reranker."""
    if not texts:
        return np.zeros(0, np.float32)
    q_vec = featurize.query_lexical_vector(query, doc_freq, n_docs)
    q_tokens = {t.lower() for t in extract_tech_tokens(query)}
    sigs = featurize.lexical_signatures_batch(list(texts), avgdl)
    out = np.zeros(len(texts), np.float32)
    for i, ((sig, _touched, _dl), text) in enumerate(zip(sigs, texts)):
        score = float(q_vec @ sig.astype(np.float32))
        doc_tokens = {t.lower() for t in extract_tech_tokens(text)}
        score += TECH_OVERLAP_BONUS * len(q_tokens & doc_tokens)
        out[i] = score
    return out


def _neural_scores(
    query: str, table: str, id_col: str, text_col: str,
    doc_ids: Sequence[int],
    doc_freq: Optional[np.ndarray] = None, n_docs: int = 0,
) -> Dict[int, float]:
    from ..models.reranker import NeuralReranker

    store = get_store()
    placeholders = ",".join("?" * len(doc_ids))
    with store.read() as conn:
        rows = conn.execute(
            f"SELECT {id_col} AS i, {text_col} AS text FROM {table} "
            f"WHERE {id_col} IN ({placeholders})",
            [int(d) for d in doc_ids],
        ).fetchall()
    texts = [row["text"] for row in rows]
    model = NeuralReranker.shared()
    priors = None
    if model.cfg.prior_residual and doc_freq is not None:
        # score = frozen lexical prior + trained residual: feed the same
        # stored-signature rescore the lexical provider uses
        prior_map = _lexical_scores(
            query, table, id_col, text_col, doc_ids, doc_freq, n_docs
        )
        priors = np.array(
            [prior_map.get(int(row["i"]), 0.0) for row in rows],
            dtype=np.float32,
        )
    logits = model.score(query, texts, priors=priors)
    return {int(row["i"]): float(s) for row, s in zip(rows, logits)}


def rerank(
    query: str,
    ranked: List[RankedItem],
    corpus_name: str,
    doc_freq: np.ndarray,
    n_docs: int,
    *,
    topk: int,
    provider: str,
) -> List[RankedItem]:
    """Rescore the top ``topk`` candidates; the tail keeps RRF order."""
    head, tail = ranked[:topk], ranked[topk:]
    if not head:
        return ranked
    table, id_col, text_col = {
        "chunks": ("chunks", "chunk_id", "text"),
        "artifact_chunks": ("artifact_chunks", "artifact_chunk_id", "content"),
    }[corpus_name]
    doc_ids = [doc_id for doc_id, _, _ in head]
    if provider == "neural_raw":
        scores = _neural_scores(query, table, id_col, text_col, doc_ids,
                                doc_freq, n_docs)
    elif provider == "neural":
        teacher = _lexical_scores(
            query, table, id_col, text_col, doc_ids, doc_freq, n_docs
        )
        refine = _neural_scores(query, table, id_col, text_col, doc_ids,
                                doc_freq, n_docs)
        lo = min(refine.values(), default=0.0)
        hi = max(refine.values(), default=1.0)
        span = max(hi - lo, 1e-6)
        scores = {
            doc_id: (
                # primary: teacher band; secondary: neural in (0, 1)
                np.floor(teacher.get(doc_id, 0.0) / TEACHER_BAND)
                + 0.999 * (refine.get(doc_id, lo) - lo) / span
            )
            for doc_id in doc_ids
        }
    else:
        scores = _lexical_scores(
            query, table, id_col, text_col, doc_ids, doc_freq, n_docs
        )
    reordered = sorted(
        head,
        key=lambda item: scores.get(item[0], float("-inf")),
        reverse=True,
    )
    # Apply the rerank ORDER but keep the descending RRF score ladder: fused
    # scores stay on the RRF scale, so the ids_only chunk/artifact interleave
    # (sorted by score across kinds, app/retrieve.py:552-560) is unaffected
    # by the rerank provider's score units.
    rrf_ladder = sorted((rrf for _d, _l, rrf in head), reverse=True)
    return [
        (doc_id, lanes, ladder_score)
        for (doc_id, lanes, _), ladder_score in zip(reordered, rrf_ladder)
    ] + tail
