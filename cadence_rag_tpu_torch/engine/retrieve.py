"""/retrieve orchestration: the reference's hot path.

Counterpart of ``cadence_rag_tpu/engine/retrieve.py`` over the port's
index: the same plans, groups, lanes, fusion, coalescing, two-phase
dispatch/finish and assembly, so the same requests give the same responses.
What differs: each planner group is dispatched at its own batch size (the
JAX package pads it to a power of two because XLA compiles a program per
batch size; eager torch compiles nothing, and kernel K1 picks its query tile
at run time), the dispatch is a ``torch.profiler.record_function`` region,
``notes.retrieval.ann_expected_recall`` is None (the JAX package's
calibration table was measured for its own approximate top-k, not for the
port's), and the reranker (``settings.rerank_enabled``) is not ported yet.

Response-shape and ranking-semantics parity with the reference
(reference: app/retrieve.py:392-688):

- three lanes x two corpora, RRF (k=60) per corpus, lane top-ks
  50/10/50/10/50, budgets 8 items / 6000 chars, <=2 artifact chunks,
  <=2 quotes per call, 800-char snippets, `ids_only` and `debug` modes,
  dense degrade to lexical_only on provider failure;

but where the reference issues five SQL queries per request, all lanes for
BOTH corpora execute as ONE device program (ops/pack.py), and requests are
batchable: ``retrieve_evidence_batch`` coalesces many queries into one
device dispatch (grouped by planner mode) — the reference serves one query
per request (app/retrieve.py:427), we serve a device batch per dispatch.

Observability: query_id per request, per-lane debug traces, a
notes.retrieval config snapshot, plus per-phase timings; in the port also
one ``retrieve.<stage>`` span per host stage of a batch in the event ring
(``utils/events.py``, off unless enabled).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import settings
import torch

from ..core.index import get_index
from ..embed import EmbeddingError, embed_texts, embeddings_enabled
from ..ingest import featurize
from ..ingest.chunking import extract_tech_tokens
from ..logging_utils import get_logger
from ..ops.fusion import lane_mask_names, rrf_merge_rect
from ..schemas import Budget, RetrieveRequest
from ..store.db import get_store
from ..utils import events
from .filters import ResolvedFilters, resolve_filters
from .planner import choose_dense_mode, recall_target_for_ef_search

logger = get_logger(__name__)

RRF_K = 60
CHUNK_BM25_TOPK = 50
ARTIFACT_BM25_TOPK = 10
DENSE_CHUNK_TOPK = 50
DENSE_ARTIFACT_TOPK = 10
TECH_TOPK = 50
MAX_ARTIFACTS = 2
MAX_QUOTES_PER_CALL = 2
SNIPPET_CHARS = 800

RERANK_NOT_PORTED = (
    "RERANK_ENABLED: the reranker (engine/rerank.py, models/*) is not ported "
    "yet (ROADMAP Queue 1 item 6)"
)

# one lane's ranked output: (doc_ids int64 array, scores f32 array or None)
LaneRows = Tuple[np.ndarray, Optional[np.ndarray]]


def _clip(text: str, max_chars: int) -> str:
    if max_chars <= 0:
        return ""
    if len(text) <= max_chars:
        return text
    return text[: max_chars - 1].rstrip() + "…"


# ------------------------------------------------------------------ plan ----

@dataclasses.dataclass
class QueryPlan:
    payload: RetrieveRequest
    query_id: str
    query: str
    budget: Budget
    empty: bool = False
    tech_tokens: List[str] = dataclasses.field(default_factory=list)
    tech_dropped: int = 0
    q_tech: Optional[np.ndarray] = None
    q_lex_feats: Optional[tuple] = None
    resolved: Optional[ResolvedFilters] = None
    lex_vocab_gen: int = 0
    dense_enabled: bool = False
    dense_error: Optional[str] = None
    dense_model_id: Optional[str] = None
    q_emb: Optional[np.ndarray] = None
    chunk_mode: Optional[str] = None
    artifact_mode: Optional[str] = None
    chunk_candidates: int = 0
    artifact_candidates: int = 0
    chunk_lanes: Dict[str, LaneRows] = dataclasses.field(default_factory=dict)
    artifact_lanes: Dict[str, LaneRows] = dataclasses.field(default_factory=dict)
    # RRF-fused results set by _merge_plans: (ids, scores, lane_masks, names)
    chunk_merged: Optional[tuple] = None
    artifact_merged: Optional[tuple] = None
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


def _fast_uuid4() -> str:
    """RFC-4122 v4 string without the uuid.UUID object machinery
    (a batch mints one id per query). Same wire format as the reference's
    uuid4 query_id."""
    b = bytearray(os.urandom(16))
    b[6] = (b[6] & 0x0F) | 0x40
    b[8] = (b[8] & 0x3F) | 0x80
    h = b.hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def _make_plan(payload: RetrieveRequest) -> QueryPlan:
    query_id = _fast_uuid4()
    query = payload.query.strip()
    plan = QueryPlan(
        payload=payload,
        query_id=query_id,
        query=query,
        budget=payload.budget or Budget(),
    )
    # per-request trace at DEBUG; INFO gets one line per micro-batch
    # (_prepare_plans), not two per query
    if logger.isEnabledFor(10):  # logging.DEBUG
        logger.debug(
            "retrieve.start query_id=%s intent=%s return_style=%s debug=%s",
            query_id, payload.intent, payload.return_style, payload.debug,
        )
    if not query:
        plan.empty = True
        return plan
    plan.tech_tokens = extract_tech_tokens(query)
    # q_tech is filled by _tech_plans, q_lex_feats by _featurize_plans
    # (one native call per batch each)
    plan.dense_enabled = embeddings_enabled()
    plan.resolved = resolve_filters(
        get_store(), payload.filters, get_index().call_capacity
    )
    return plan


def _tech_plans(plans: Sequence[QueryPlan]) -> None:
    """Tech slot structures for the whole batch in one featurize call
    (the port's featurizer is pure Python: one placement loop per
    query)."""
    pending = [p for p in plans if not p.empty]
    if not pending:
        return
    results = featurize.query_tech_structures_batch(
        [p.tech_tokens for p in pending]
    )
    for plan, (structure, dropped) in zip(pending, results):
        plan.q_tech = structure
        plan.tech_dropped = dropped
        if dropped:
            logger.warning(
                "retrieve.tech_tokens_dropped query_id=%s dropped=%s of=%s",
                plan.query_id, dropped, len(plan.tech_tokens),
            )


def _featurize_plans(plans: Sequence[QueryPlan]) -> None:
    """Lexical query featurization for the whole batch in one featurize
    call (pure Python in the port: one hashing pass per query)."""
    pending = [p for p in plans if not p.empty]
    if not pending:
        return
    gen = featurize.active_vocab()[1]
    feats = featurize.query_lexical_features_batch(
        [p.query for p in pending]
    )
    for plan, triple in zip(pending, feats):
        plan.q_lex_feats = triple
        plan.lex_vocab_gen = gen


def _embed_plans(plans: Sequence[QueryPlan]) -> None:
    """One provider call embeds every dense-enabled query in the batch. On a
    batch failure each query retries INDIVIDUALLY so only the queries that
    actually fail degrade to lexical_only — per-request ladder parity with
    the reference (app/retrieve.py:425-431), where one poisoned query never
    degrades unrelated concurrent requests sharing the micro-batch."""
    pending = [p for p in plans if not p.empty and p.dense_enabled]
    if not pending:
        return
    t0 = time.perf_counter()
    try:
        embedded = embed_texts([p.query for p in pending])
        for plan, vector in zip(pending, embedded.vectors):
            plan.dense_model_id = embedded.model
            plan.q_emb = np.asarray(vector, dtype=np.float32)
    except EmbeddingError as exc:
        if len(pending) == 1:
            pending[0].dense_enabled = False
            pending[0].dense_error = str(exc)
        else:
            # Circuit breaker (VERDICT r2 weak #7): without it a
            # poisoned provider turns one failed batch into B serial
            # HTTP timeouts. After 3 consecutive individual failures the
            # rest of the batch degrades to lexical_only immediately.
            consecutive_failures = 0
            for plan in pending:
                if consecutive_failures >= 3:
                    plan.dense_enabled = False
                    plan.dense_error = (
                        "embedding provider circuit open "
                        f"(3 consecutive failures): {exc}"
                    )
                    continue
                try:
                    one = embed_texts([plan.query])
                    plan.dense_model_id = one.model
                    plan.q_emb = np.asarray(one.vectors[0], dtype=np.float32)
                    consecutive_failures = 0
                except EmbeddingError as one_exc:
                    plan.dense_enabled = False
                    plan.dense_error = str(one_exc)
                    consecutive_failures += 1
    embed_ms = (time.perf_counter() - t0) * 1e3
    for plan in pending:
        plan.timings["embed_ms"] = embed_ms


def _finish_planning(plan: QueryPlan) -> None:
    if plan.empty or not plan.dense_enabled:
        return
    index = get_index()
    resolved = plan.resolved
    allowed = resolved.allowed_at(index.call_capacity)
    plan.chunk_candidates = index.chunks.estimate_candidates(
        allowed, resolved.date_min, resolved.date_max,
        unfiltered=resolved.unfiltered,
    )
    plan.artifact_candidates = index.artifacts.estimate_candidates(
        allowed, resolved.date_min, resolved.date_max,
        unfiltered=resolved.unfiltered,
    )
    plan.chunk_mode = choose_dense_mode(
        plan.chunk_candidates, resolved.scoped,
        ivf_available=index.chunks.ivf_usable(),
    )
    # IVF deliberately covers the CHUNKS corpus only: artifacts are ~10x
    # smaller (reference fixture ratio; artifact lane top-k is 10 vs 50), so
    # their exact/ann matmul is already cheap and an IVF build would add a
    # second k-means + freshness tail for negligible HBM savings.
    plan.artifact_mode = choose_dense_mode(
        plan.artifact_candidates, resolved.scoped
    )


def _format_lanes(out: Dict[str, Any], row: int) -> Dict[str, LaneRows]:
    """Zero-copy row views into the rectangular lane blocks
    ({lane: (ids (B,k), scores (B,k), counts (B,))} from
    core.index.postprocess_lanes): slice each row to its valid prefix."""
    lanes: Dict[str, LaneRows] = {}
    ids, scores, counts = out["lex"]
    n = counts[row]
    lanes["bm25"] = (ids[row, :n], scores[row, :n])
    ids, _keys, counts = out["tech"]
    lanes["tech_tokens"] = (ids[row, :counts[row]], None)
    if "dense" in out:
        ids, scores, counts = out["dense"]
        n = counts[row]
        lanes["dense"] = (ids[row, :n], scores[row, :n])
    return lanes


def _dispatch_plans(plans: Sequence[QueryPlan]) -> List[Tuple]:
    """Group by (modes, dense) and ENQUEUE one device dispatch per group
    without blocking — returns (group, dispatch_handle, t0) tuples for
    ``_collect_plans``. The split lets a pipelined caller enqueue the
    next micro-batch while this one computes (back-to-back enqueues keep
    the device fed; blocking per batch leaves it idle during host
    work)."""
    index = get_index()
    runnable = [p for p in plans if not p.empty]
    # An online vocab rebuild (core/vocab.auto_rebuild_if_needed) may have
    # swapped the lexical layout between this batch's featurization and
    # its dispatch: re-featurize stale queries so they score the layout
    # the device rows now hold (one int compare per plan when nothing
    # changed).
    gen = featurize.active_vocab()[1]
    stale = [p for p in runnable if p.lex_vocab_gen != gen]
    if stale:
        _featurize_plans(stale)
        logger.info(
            "retrieve.requeried_lex_layout plans=%s gen=%s", len(stale), gen
        )
    groups: Dict[Tuple, List[QueryPlan]] = {}
    device_rrf = bool(settings.device_rrf_enabled)
    for plan in runnable:
        # debug mode needs per-lane ranks/scores, which the fused-RRF
        # program does not return — those plans group onto the host-merge
        # (oracle) path
        key = (plan.chunk_mode or "exact", plan.artifact_mode or "exact",
               plan.dense_enabled and plan.q_emb is not None,
               device_rrf and not plan.payload.debug)
        groups.setdefault(key, []).append(plan)

    pending: List[Tuple] = []
    for (chunk_mode, artifact_mode, dense_on, fuse_rrf), group in groups.items():
        t0 = time.perf_counter()
        # pad to the group's widest tech structure (an identifier-heavy
        # query escalates its per-slot capacity; zero blocks never match)
        tech_w = max(p.q_tech.shape[0] for p in group)
        q_tech = np.zeros((len(group), tech_w), dtype=np.int32)
        for row, p in enumerate(group):
            q_tech[row, : p.q_tech.shape[0]] = p.q_tech
        # pad every plan's bitmap to the dispatch-time call capacity:
        # ingest can grow it between planning and dispatch, and mixed
        # widths would fail the whole micro-batch (new calls stay visible
        # to unscoped plans via pad_allowed)
        cap = index.call_capacity
        allowed = np.stack([p.resolved.allowed_at(cap) for p in group])
        date_min = np.array([p.resolved.date_min for p in group], dtype=np.int32)
        date_max = np.array([p.resolved.date_max for p in group], dtype=np.int32)
        q_emb = (
            np.stack([p.q_emb for p in group]).astype(np.float32)
            if dense_on else None
        )
        # a named region in torch.profiler traces; no-op when none is active
        with torch.profiler.record_function("retrieve_device_dispatch"):
            disp = index.query_both_packed_async(
                q_emb, [p.q_lex_feats for p in group], q_tech,
                allowed, date_min, date_max,
                chunk_ks=(DENSE_CHUNK_TOPK, CHUNK_BM25_TOPK, TECH_TOPK),
                artifact_ks=(DENSE_ARTIFACT_TOPK, ARTIFACT_BM25_TOPK, TECH_TOPK),
                chunk_mode=chunk_mode,
                artifact_mode=artifact_mode,
                recall_target=recall_target_for_ef_search(
                    settings.embeddings_hnsw_ef_search
                ),
                fuse_rrf=fuse_rrf,
            )
        pending.append((group, disp, t0))
    return pending


def _rename_lanes(out: Dict[str, Any]) -> Dict[str, Any]:
    """Device lane keys -> API lane names, in the fixed declaration order
    the RRF tiebreak contract depends on (bm25, tech_tokens, dense)."""
    lanes = {"bm25": out["lex"], "tech_tokens": out["tech"]}
    if "dense" in out:
        lanes["dense"] = out["dense"]
    return lanes


def _collect_plans(pending: Sequence[Tuple]) -> None:
    """Block on each dispatched group, distribute lane row views, and
    RRF-fuse the whole group straight from the rectangular lane blocks
    (one vectorized+native pass, not a per-plan dict rebuild)."""
    index = get_index()
    for group, disp, t0 in pending:
        chunks_out, artifacts_out = index.collect_packed(disp)
        device_ms = (time.perf_counter() - t0) * 1e3
        if device_ms > 2000:
            events.record("query.slow_device", device_ms / 1e3,
                          batch=len(group))
        batch = len(group)
        served_mode = getattr(disp, "served_chunk_mode", None)
        if "__rrf__" in chunks_out:
            # device-fused RRF: merged rows come straight off the chip;
            # slice each plan's valid prefix (no host merge, no per-lane
            # postprocess — debug plans never take this path)
            c_ids, c_scores, c_masks, c_counts = chunks_out["__rrf__"]
            a_ids, a_scores, a_masks, a_counts = artifacts_out["__rrf__"]
            dense_on = disp.sig.dense_enabled
            names = (
                ("bm25", "tech_tokens", "dense")
                if dense_on else ("bm25", "tech_tokens")
            )
            for row, plan in enumerate(group):
                n = int(c_counts[row])
                plan.chunk_merged = (
                    c_ids[row, :n], c_scores[row, :n], c_masks[row, :n],
                    names,
                )
                n = int(a_counts[row])
                plan.artifact_merged = (
                    a_ids[row, :n], a_scores[row, :n], a_masks[row, :n],
                    names,
                )
                plan.timings["device_ms"] = device_ms
                plan.timings["device_batch"] = float(batch)
                if served_mode is not None and plan.chunk_mode is not None:
                    plan.chunk_mode = served_mode
            continue
        chunk_merged = rrf_merge_rect(_rename_lanes(chunks_out), k=RRF_K)
        artifact_merged = rrf_merge_rect(
            _rename_lanes(artifacts_out), k=RRF_K
        )
        for row, plan in enumerate(group):
            plan.chunk_lanes = _format_lanes(chunks_out, row)
            plan.artifact_lanes = _format_lanes(artifacts_out, row)
            plan.chunk_merged = chunk_merged[row]
            plan.artifact_merged = artifact_merged[row]
            plan.timings["device_ms"] = device_ms
            plan.timings["device_batch"] = float(batch)
            if served_mode is not None and plan.chunk_mode is not None:
                # notes/debug must report the mode that SERVED, not the
                # planned one (ivf can downgrade to ann at dispatch when
                # a compaction invalidated the index mid-flight)
                plan.chunk_mode = served_mode


def _execute_plans(plans: Sequence[QueryPlan]) -> None:
    _collect_plans(_dispatch_plans(plans))


# -------------------------------------------------------------- assembly ----

def _debug_lane(lane: LaneRows, id_field: str) -> List[Dict[str, Any]]:
    ids, scores = lane
    return [
        {
            id_field: int(doc_id),
            "rank": rank,
            "score": float(scores[rank - 1]) if scores is not None else None,
        }
        for rank, doc_id in enumerate(ids.tolist(), start=1)
    ]


@functools.lru_cache(maxsize=64)
def _static_notes_cached(
    dense_enabled: bool, chunk_mode: Optional[str],
    artifact_mode: Optional[str], dense_model_id: Optional[str],
    dense_error: Optional[str], reranked_from: Optional[int],
    ef_search: int,
) -> Dict[str, Any]:
    """The batch-invariant part of notes.retrieval, memoized by the few
    fields that vary (mode/flags), instead of rebuilding the ~25-key
    nested snapshot per query. Callers shallow-copy and add the per-query
    keys; nested
    values are treated as immutable (responses are serialized, never
    mutated)."""
    return {
        "planner": (
            "lexical_only"
            if not dense_enabled
            else (
                # label reflects the non-exact scan path actually
                # serving the dense lane (ivf > ann > exact)
                "ivf"
                if chunk_mode == "ivf" or artifact_mode == "ivf"
                else (
                    "ann"
                    if chunk_mode == "ann" or artifact_mode == "ann"
                    else "exact"
                )
            )
        ),
        "dense_topk": (
            max(DENSE_CHUNK_TOPK, DENSE_ARTIFACT_TOPK)
            if dense_enabled else 0
        ),
        "lex_topk": CHUNK_BM25_TOPK,
        "artifact_chunk_lex_topk": ARTIFACT_BM25_TOPK,
        "reranked_from": reranked_from,
        "bm25_chunk_topk": CHUNK_BM25_TOPK,
        "bm25_artifact_chunk_topk": ARTIFACT_BM25_TOPK,
        "tech_token_topk": TECH_TOPK,
        "lanes": {
            "bm25": True,
            "tech_tokens": True,
            "dense": dense_enabled,
        },
        "dense_model_id": dense_model_id,
        "dense_error": dense_error,
        "dense_modes": {
            "chunks": chunk_mode,
            "artifact_chunks": artifact_mode,
        },
        "hnsw_ef_search": ef_search if dense_enabled else None,
        "ann_recall_target": (
            recall_target_for_ef_search(ef_search)
            if dense_enabled else None
        ),
        # the JAX package reports the recall its own approximate top-k was
        # measured to reach at this ef; no such calibration exists for the
        # port's ann lane
        "ann_expected_recall": None,
    }


def _static_notes(dense_enabled, chunk_mode, artifact_mode,
                  dense_model_id, dense_error, reranked_from):
    return _static_notes_cached(
        dense_enabled, chunk_mode, artifact_mode, dense_model_id,
        dense_error, reranked_from,
        int(settings.embeddings_hnsw_ef_search),
    )


def _fetch_rows(table: str, id_col: str, columns: str,
                ids: Sequence[int]) -> Dict[int, Dict[str, Any]]:
    ids = list({int(i) for i in ids})
    if not ids:
        return {}
    store = get_store()
    out: Dict[int, Dict[str, Any]] = {}
    with store.read() as conn:
        for start in range(0, len(ids), 5000):
            window = ids[start:start + 5000]
            placeholders = ",".join("?" * len(window))
            rows = conn.execute(
                f"SELECT {columns} FROM {table} "
                f"WHERE {id_col} IN ({placeholders})",
                window,
            ).fetchall()
            out.update({int(r[id_col]): dict(r) for r in rows})
    return out


def _prefetch_rows(plans: Sequence["QueryPlan"]) -> Tuple[Dict, Dict]:
    """One store round-trip per table for the WHOLE batch (per-plan IN
    queries would cost 2 queries x batch)."""
    chunk_parts: List[np.ndarray] = []
    artifact_parts: List[np.ndarray] = []
    for plan in plans:
        if plan.empty or plan.payload.return_style == "ids_only":
            continue
        if plan.chunk_lanes:
            chunk_parts.extend(ids for ids, _ in plan.chunk_lanes.values())
            artifact_parts.extend(
                ids for ids, _ in plan.artifact_lanes.values()
            )
        else:
            # device-fused RRF path: lanes never reach the host — the
            # merged candidates are the (deduped) union of lane hits
            chunk_parts.append(plan.chunk_merged[0])
            artifact_parts.append(plan.artifact_merged[0])

    def _uniq(parts: List[np.ndarray]) -> List[int]:
        if not parts:
            return []
        return np.unique(np.concatenate(parts)).tolist()

    chunk_rows = _fetch_rows(
        "chunks", "chunk_id",
        "chunk_id, call_id, speaker, start_ts_ms, end_ts_ms, text",
        _uniq(chunk_parts),
    )
    artifact_rows = _fetch_rows(
        "artifact_chunks", "artifact_chunk_id",
        "artifact_chunk_id, artifact_id, call_id, kind, content",
        _uniq(artifact_parts),
    )
    return chunk_rows, artifact_rows


def _assemble(
    plan: QueryPlan,
    chunk_row_cache: Optional[Dict[int, Dict[str, Any]]] = None,
    artifact_row_cache: Optional[Dict[int, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    payload = plan.payload
    if plan.empty:
        if payload.return_style == "ids_only":
            return {"query_id": plan.query_id, "retrieved_ids": []}
        return {
            "query_id": plan.query_id,
            "intent": payload.intent,
            "budget": plan.budget.model_dump(),
            "artifacts": [],
            "quotes": [],
            "notes": {"error": "empty query"},
        }

    debug_payload = None
    if payload.debug:
        debug_payload = {
            "lanes": {
                "chunks": {
                    name: _debug_lane(rows, "chunk_id")
                    for name, rows in plan.chunk_lanes.items()
                },
                "artifacts": {
                    name: _debug_lane(rows, "artifact_chunk_id")
                    for name, rows in plan.artifact_lanes.items()
                },
            },
            "limits": {
                "bm25_chunk_topk": CHUNK_BM25_TOPK,
                "bm25_artifact_chunk_topk": ARTIFACT_BM25_TOPK,
                "tech_token_topk": TECH_TOPK,
                "dense_chunk_topk": DENSE_CHUNK_TOPK if plan.dense_enabled else 0,
                "dense_artifact_chunk_topk": (
                    DENSE_ARTIFACT_TOPK if plan.dense_enabled else 0
                ),
            },
            "dense": {
                "enabled": plan.dense_enabled,
                "model_id": plan.dense_model_id,
                "error": plan.dense_error,
                "modes": {
                    "chunks": plan.chunk_mode,
                    "artifact_chunks": plan.artifact_mode,
                },
                "candidate_rows": {
                    "chunks": plan.chunk_candidates,
                    "artifact_chunks": plan.artifact_candidates,
                },
            },
            "timings_ms": plan.timings,
        }

    chunk_ids, chunk_scores, chunk_masks, chunk_names = plan.chunk_merged
    artifact_ids, artifact_scores, artifact_masks, artifact_names = (
        plan.artifact_merged
    )

    reranked_from: Optional[int] = None
    if settings.rerank_enabled:
        raise RuntimeError(RERANK_NOT_PORTED)

    if payload.return_style == "ids_only":
        # sort by (-score, kind, id); artifacts sort before chunks on ties
        ids_all = np.concatenate([artifact_ids, chunk_ids])
        scores_all = np.concatenate([artifact_scores, chunk_scores])
        kinds_all = np.concatenate([
            np.zeros(artifact_ids.size, dtype=np.int8),
            np.ones(chunk_ids.size, dtype=np.int8),
        ])
        order = np.lexsort((ids_all, kinds_all, -scores_all))
        kind_name = ("artifact_chunk", "chunk")
        response: Dict[str, Any] = {
            "query_id": plan.query_id,
            "retrieved_ids": [
                f"{kind_name[k]}:{doc_id}"
                for k, doc_id in zip(
                    kinds_all[order].tolist(), ids_all[order].tolist()
                )
            ],
        }
        if debug_payload is not None:
            response["debug"] = debug_payload
        logger.info(
            "retrieve.complete query_id=%s mode=ids_only ids=%s dense=%s",
            plan.query_id, len(response["retrieved_ids"]), plan.dense_enabled,
        )
        return response

    # ----- evidence pack under budget -------------------------------------
    t0 = time.perf_counter()
    if artifact_row_cache is not None:
        artifact_rows = artifact_row_cache
    else:
        artifact_rows = _fetch_rows(
            "artifact_chunks", "artifact_chunk_id",
            "artifact_chunk_id, artifact_id, call_id, kind, content",
            artifact_ids.tolist(),
        )
    if chunk_row_cache is not None:
        chunk_rows = chunk_row_cache
    else:
        chunk_rows = _fetch_rows(
            "chunks", "chunk_id",
            "chunk_id, call_id, speaker, start_ts_ms, end_ts_ms, text",
            chunk_ids.tolist(),
        )

    budget = plan.budget
    max_items = budget.max_evidence_items
    remaining_chars = budget.max_total_chars
    artifacts_out: List[Dict[str, Any]] = []
    quotes_out: List[Dict[str, Any]] = []
    evidence_count = 0
    max_artifacts = min(MAX_ARTIFACTS, max_items)

    for pos in range(artifact_ids.size):
        if evidence_count >= max_items or len(artifacts_out) >= max_artifacts:
            break
        if remaining_chars <= 0:
            break
        doc_id = int(artifact_ids[pos])
        row = artifact_rows.get(doc_id)
        if row is None:
            continue
        snippet = _clip(row["content"], min(SNIPPET_CHARS, remaining_chars))
        remaining_chars -= len(snippet)
        lane_hits = lane_mask_names(int(artifact_masks[pos]), artifact_names)
        artifacts_out.append(
            {
                "evidence_id": f"A-{doc_id}",
                "call_id": row["call_id"],
                "artifact_id": row["artifact_id"],
                "artifact_chunk_id": doc_id,
                "kind": row["kind"],
                "snippet": snippet,
                "why_relevant": " + ".join(sorted(lane_hits)),
            }
        )
        evidence_count += 1

    quotes_per_call: Dict[str, int] = {}
    for pos in range(chunk_ids.size):
        if evidence_count >= max_items:
            break
        if remaining_chars <= 0:
            break
        doc_id = int(chunk_ids[pos])
        row = chunk_rows.get(doc_id)
        if row is None:
            continue
        call_id = row["call_id"]
        if quotes_per_call.get(call_id, 0) >= MAX_QUOTES_PER_CALL:
            continue
        snippet = _clip(row["text"], min(SNIPPET_CHARS, remaining_chars))
        remaining_chars -= len(snippet)
        lane_hits = lane_mask_names(int(chunk_masks[pos]), chunk_names)
        quotes_out.append(
            {
                "evidence_id": f"Q-{doc_id}",
                "call_id": call_id,
                "chunk_id": doc_id,
                "speaker": row["speaker"],
                "start_ts_ms": row["start_ts_ms"],
                "end_ts_ms": row["end_ts_ms"],
                "snippet": snippet,
                "why_relevant": " + ".join(sorted(lane_hits)),
            }
        )
        quotes_per_call[call_id] = quotes_per_call.get(call_id, 0) + 1
        evidence_count += 1
    plan.timings["pack_ms"] = (time.perf_counter() - t0) * 1e3

    retrieval_notes = dict(_static_notes(
        plan.dense_enabled, plan.chunk_mode, plan.artifact_mode,
        plan.dense_model_id, plan.dense_error, reranked_from,
    ))
    retrieval_notes["tech_tokens"] = plan.tech_tokens
    # >0 = identifiers that found no slot in the query structure and
    # cannot match (never silent: also logged)
    retrieval_notes["tech_tokens_dropped"] = plan.tech_dropped
    retrieval_notes["dense_candidate_rows"] = {
        "chunks": plan.chunk_candidates,
        "artifact_chunks": plan.artifact_candidates,
    }
    retrieval_notes["timings_ms"] = plan.timings
    response = {
        "query_id": plan.query_id,
        "intent": payload.intent,
        "budget": budget.model_dump(),
        "artifacts": artifacts_out,
        "quotes": quotes_out,
        "notes": {"retrieval": retrieval_notes},
    }
    if debug_payload is not None:
        response["debug"] = debug_payload
    logger.info(
        "retrieve.complete query_id=%s artifacts=%s quotes=%s dense=%s",
        plan.query_id, len(artifacts_out), len(quotes_out), plan.dense_enabled,
    )
    return response


# --------------------------------------------------------- coalescing ----

def _coalesce_payloads(
    payloads: Sequence[RetrieveRequest],
) -> Tuple[Sequence[RetrieveRequest], Optional[List[int]]]:
    """Deduplicate identical requests within one micro-batch.

    Every stage of the pipeline — tech-token extraction, featurization,
    embedding, filter resolution, the device lanes, RRF, assembly — is a
    deterministic function of the request payload, so two requests whose
    payloads serialize identically produce identical responses modulo
    query_id. A burst of the same hot query inside one batch window (the
    thundering-herd shape request-coalescing exists for) therefore plans,
    embeds, dispatches and assembles ONCE.

    Returns (unique_payloads, assignment) where assignment[i] is the
    index into unique_payloads serving original request i, or
    (payloads, None) when nothing coalesces (the common all-unique batch
    pays one key per request).
    """
    if not settings.retrieve_coalesce_enabled or len(payloads) < 2:
        return payloads, None
    seen: Dict[Any, int] = {}
    assign: List[int] = []
    unique: List[RetrieveRequest] = []
    for payload in payloads:
        if payload.filters is None:
            # common shape (no filters): a tuple key over the scalar
            # fields avoids the pydantic json dump
            key = (payload.query, payload.intent, payload.return_style,
                   payload.debug, payload.budget.max_evidence_items,
                   payload.budget.max_total_chars)
        else:
            key = payload.model_dump_json()
        slot = seen.get(key)
        if slot is None:
            slot = len(unique)
            seen[key] = slot
            unique.append(payload)
        assign.append(slot)
    if len(unique) == len(payloads):
        return payloads, None
    return unique, assign


def _fanout_coalesced(
    responses: List[Dict[str, Any]], assign: Optional[List[int]]
) -> List[Dict[str, Any]]:
    """Expand unique-request responses back to one per original request.

    The first request mapped to a unique slot gets the computed response
    verbatim; duplicates get a shallow copy with a fresh query_id (the
    only per-request field — responses are serialized, never mutated, so
    sharing the nested lists/dicts is safe, same convention as
    ``_static_notes``)."""
    if assign is None:
        return responses
    used: set = set()
    out: List[Dict[str, Any]] = []
    for slot in assign:
        response = responses[slot]
        if slot in used:
            duplicate = dict(response)
            duplicate["query_id"] = _fast_uuid4()
            logger.info(
                "retrieve.coalesced query_id=%s primary_query_id=%s",
                duplicate["query_id"], response["query_id"],
            )
            response = duplicate
        else:
            used.add(slot)
        out.append(response)
    return out


# ------------------------------------------------------------- public API ----

def _assemble_ids_only_batch(
    plans: Sequence[QueryPlan],
) -> Dict[int, Dict[str, Any]]:
    """Batched ids_only assembly for every eligible plan via the native
    formatter (native/rrf.ids_only_format): ordering identical to
    ``_assemble``'s per-plan lexsort (parity-tested), but the ~200
    "kind:id" strings per query materialize in one C pass instead of
    per-id Python f-strings.
    Returns {plan_index: response}; ineligible plans (debug payloads,
    evidence packs, empty queries, rerank on) fall back to ``_assemble``.
    """
    if settings.rerank_enabled:
        return {}
    eligible = [
        (i, p)
        for i, p in enumerate(plans)
        if not p.empty
        and p.payload.return_style == "ids_only"
        and not p.payload.debug
        and p.chunk_merged is not None
        and p.artifact_merged is not None
    ]
    if not eligible:
        return {}
    from ..native import rrf as native_rrf

    if not native_rrf.available():
        return {}

    def _flat(which: int):
        parts = [p for _, plan in eligible
                 for p in (plan.artifact_merged if which == 0
                           else plan.chunk_merged,)]
        sizes = np.array([part[0].size for part in parts], dtype=np.int64)
        plan_idx = np.repeat(
            np.arange(len(eligible), dtype=np.int32), sizes
        )
        if int(sizes.sum()) == 0:
            return plan_idx, np.zeros(0, np.int64), np.zeros(0, np.float64)
        ids = np.concatenate([part[0] for part in parts])
        scores = np.concatenate([part[1] for part in parts])
        return plan_idx, ids, scores

    a_plan, a_doc, a_score = _flat(0)
    c_plan, c_doc, c_score = _flat(1)
    result = native_rrf.ids_only_format(
        a_plan, a_doc, a_score, c_plan, c_doc, c_score, len(eligible)
    )
    if result is None:
        return {}
    counts, strings = result
    out: Dict[int, Dict[str, Any]] = {}
    offset = 0
    for j, (i, plan) in enumerate(eligible):
        end = offset + int(counts[j])
        out[i] = {
            "query_id": plan.query_id,
            "retrieved_ids": strings[offset:end],
        }
        offset = end
        if logger.isEnabledFor(10):  # logging.DEBUG; see _make_plan
            logger.debug(
                "retrieve.complete query_id=%s mode=ids_only ids=%s "
                "dense=%s", plan.query_id, int(counts[j]),
                plan.dense_enabled,
            )
    logger.info(
        "retrieve.complete_batch mode=ids_only n=%s ids_total=%s",
        len(eligible), int(counts.sum()),
    )
    return out


def _prepare_plans(payloads: Sequence[RetrieveRequest]) -> List[QueryPlan]:
    # each stage is a "retrieve.<stage>" span in the event ring
    # (utils/events.py; one bool check while the ring is off)
    n = len(payloads)
    with events.timed("retrieve.plan", batch=n):
        plans = [_make_plan(p) for p in payloads]
    if plans:
        logger.info(
            "retrieve.start_batch n=%s first_query_id=%s",
            len(plans), plans[0].query_id,
        )
    with events.timed("retrieve.tech", batch=n):
        _tech_plans(plans)
    with events.timed("retrieve.featurize", batch=n):
        _featurize_plans(plans)
    with events.timed("retrieve.embed", batch=n):
        _embed_plans(plans)
    with events.timed("retrieve.planner", batch=n):
        for plan in plans:
            _finish_planning(plan)
    return plans


def _finish_plans(plans: List[QueryPlan],
                  pending: Sequence[Tuple]) -> List[Dict[str, Any]]:
    n = len(plans)
    # the device wait, then the RRF fusion of each group (rect merge)
    with events.timed("retrieve.collect", batch=n):
        _collect_plans(pending)
    with events.timed("retrieve.store_rows", batch=n):
        chunk_rows, artifact_rows = _prefetch_rows(plans)
    with events.timed("retrieve.assemble", batch=n):
        fast = _assemble_ids_only_batch(plans)
        return [
            fast.get(i) or _assemble(plan, chunk_rows, artifact_rows)
            for i, plan in enumerate(plans)
        ]


def retrieve_evidence_batch(
    payloads: Sequence[RetrieveRequest],
) -> List[Dict[str, Any]]:
    """Serve many queries with one device dispatch per planner-mode group."""
    t0 = time.perf_counter()
    handle = dispatch_evidence_batch(payloads)
    t1 = time.perf_counter()
    out = finish_evidence_batch(handle)
    t2 = time.perf_counter()
    if t2 - t0 > 2.0:
        # stall attribution (utils/events.py): dispatch covers host
        # prepare + pack + enqueue; finish covers the device wait +
        # fuse + assemble (a >2 s device wait also logs
        # query.slow_device from _collect_plans)
        events.record("query.slow_batch", t2 - t0,
                      dispatch_s=round(t1 - t0, 3),
                      finish_s=round(t2 - t1, 3),
                      batch=len(payloads))
    return out


def dispatch_evidence_batch(payloads: Sequence[RetrieveRequest]):
    """Two-phase serving, phase 1: host prep + device ENQUEUE (returns a
    handle without blocking on the device). The serve-side batcher runs
    phase 1 of the next micro-batch while phase 2 of the previous one
    waits on device output — single-thread pipelining. Identical
    requests within the batch coalesce into one executed plan."""
    t0 = time.perf_counter()
    unique, assign = _coalesce_payloads(payloads)
    plans = _prepare_plans(unique)
    t1 = time.perf_counter()
    with events.timed("retrieve.enqueue", batch=len(plans)):
        pending = _dispatch_plans(plans)
    t2 = time.perf_counter()
    if t2 - t0 > 2.0:
        events.record("query.slow_dispatch", t2 - t0,
                      prepare_s=round(t1 - t0, 3),
                      enqueue_s=round(t2 - t1, 3),
                      batch=len(payloads))
    return plans, pending, assign


def finish_evidence_batch(handle) -> List[Dict[str, Any]]:
    """Two-phase serving, phase 2: block on the device, fuse, assemble."""
    plans, pending, assign = handle
    return _fanout_coalesced(_finish_plans(plans, pending), assign)


def retrieve_evidence_pipelined(batches, depth: int = 2):
    """Serve a STREAM of micro-batches with up to ``depth`` in flight on
    the device from a single thread: while batch i computes, batch i+1's
    host work (plan/embed/featurize/pack) runs and its program enqueues
    behind it. One thread + async dispatch: the device works through the
    enqueued programs while the thread prepares the next batch.

    Yields one List[response] per input batch, in order.
    """
    from collections import deque

    window: "deque" = deque()
    for payloads in batches:
        window.append(dispatch_evidence_batch(payloads))
        if len(window) >= max(depth, 1):
            yield finish_evidence_batch(window.popleft())
    while window:
        yield finish_evidence_batch(window.popleft())


def retrieve_evidence(payload: RetrieveRequest) -> Dict[str, Any]:
    return retrieve_evidence_batch([payload])[0]
