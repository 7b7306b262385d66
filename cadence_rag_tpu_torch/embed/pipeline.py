"""Embedding backfill pipeline with adaptive batch downshift.

Behavioral parity with the reference pipeline (reference:
app/embedding_pipeline.py): scan for rows with no embedding in both
corpora, embed in batches, and on provider "max batch size" errors parse
the limit out of the error text (else halve), retrying until singletons
fail hard. Vectors are persisted as blobs AND scattered into the device
index in the same pass — the device is the search index, the store is
durability.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..config import settings
from ..core.index import get_index
from ..ingest.chunking import PIPELINE_VERSION
from ..ingest.ingest import NER_CONFIG_DISABLED
from ..logging_utils import get_logger
from ..store.db import get_store
from ..utils.timeutil import now_utc, to_iso
from .provider import EmbeddingError, EmbeddingResult, embed_texts

logger = get_logger(__name__)

_LIMIT_PATTERNS = (
    re.compile(r"batch[- ]size[^0-9]{0,40}<=\s*(\d+)", re.IGNORECASE),
    re.compile(r"max(?:imum)?\s+batch[- ]size[^0-9]{0,40}(\d+)", re.IGNORECASE),
)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    table: str
    id_column: str
    text_column: str


TABLE_SPECS: Tuple[TableSpec, ...] = (
    TableSpec("chunks", "chunk_id", "text"),
    TableSpec("artifact_chunks", "artifact_chunk_id", "content"),
)


@dataclasses.dataclass(frozen=True)
class BackfillSummary:
    rows_updated: int
    calls_touched: int
    ingestion_runs_inserted: int
    model_used: str
    per_table: Dict[str, int]


def infer_batch_size_limit(error_message: str) -> Optional[int]:
    message = (error_message or "").strip()
    for pattern in _LIMIT_PATTERNS:
        match = pattern.search(message)
        if match:
            try:
                value = int(match.group(1))
            except (TypeError, ValueError):
                continue
            if value > 0:
                return value
    return None


def embed_texts_adaptive(
    texts: Sequence[str], batch_size: int,
    learned: Optional[Dict[str, int]] = None,
) -> EmbeddingResult:
    """``learned`` (optional dict) receives the final downshifted batch
    size under "batch_size" so a long backfill can carry the provider's
    real limit across pages instead of re-triggering the same oversized
    failure on every page."""
    cleaned = [t.strip() for t in texts if isinstance(t, str) and t.strip()]
    if not cleaned:
        raise EmbeddingError("embedding request requires at least one non-empty text")
    current = max(1, int(batch_size))
    vectors: List[List[float]] = []
    model = settings.embeddings_model_id
    index = 0
    while index < len(cleaned):
        upper = min(index + current, len(cleaned))
        window = cleaned[index:upper]
        try:
            result = embed_texts(window)
        except EmbeddingError as exc:
            if len(window) <= 1:
                raise
            inferred = infer_batch_size_limit(str(exc))
            if inferred is not None and inferred < len(window):
                current = max(1, inferred)
            else:
                current = max(1, len(window) // 2)
            continue
        vectors.extend(result.vectors)
        model = result.model
        index = upper
    if learned is not None:
        learned["batch_size"] = current
    return EmbeddingResult(vectors, model)


def _pending_rows(spec: TableSpec, limit: int, call_id: Optional[str]):
    store = get_store()
    sql = (
        f"SELECT {spec.id_column} AS row_id, call_id, "
        f"{spec.text_column} AS content FROM {spec.table} "
        f"WHERE embedding IS NULL AND {spec.text_column} IS NOT NULL "
        f"AND length(trim({spec.text_column})) > 0 "
    )
    params: list = []
    if call_id is not None:
        sql += "AND call_id = ? "
        params.append(call_id)
    sql += f"ORDER BY {spec.id_column} ASC LIMIT ?"
    params.append(limit)
    with store.read() as conn:
        return conn.execute(sql, params).fetchall()


def _write_vectors(spec: TableSpec, rows, vectors: Sequence[Sequence[float]]) -> None:
    if len(rows) != len(vectors):
        raise RuntimeError(
            f"row/vector mismatch for {spec.table}: "
            f"{len(rows)} rows vs {len(vectors)} vectors"
        )
    store = get_store()
    with store.tx() as conn:
        conn.executemany(
            f"UPDATE {spec.table} SET embedding = ? WHERE {spec.id_column} = ?",
            [
                (np.asarray(vec, dtype=np.float32).tobytes(), row["row_id"])
                for row, vec in zip(rows, vectors)
            ],
        )
    from ..ingest.ingest import store_only

    if store_only():
        # standalone backfill process: the store write above logged an
        # index mutation; the serving process's syncer scatters it
        return
    corpus = get_index().corpus(spec.table)
    corpus.set_embeddings(
        [row["row_id"] for row in rows],
        np.asarray(vectors, dtype=np.float32),
    )


def _record_runs(call_ids: Set[str], model_id: str, source: str) -> int:
    store = get_store()
    embedding_config = json.dumps(
        {
            "enabled": True,
            "mode": "device_backfill_v1",
            "model_id": model_id,
            "dim": int(settings.embeddings_dim),
            "provider": settings.embeddings_provider or "http",
            "base_url": settings.embeddings_base_url,
            "timestamp": to_iso(now_utc()),
            "source": source,
        }
    )
    chunking_config = json.dumps(
        {"enabled": True, "mode": "existing_chunks", "source": source}
    )
    inserted = 0
    with store.tx() as conn:
        for call_id in sorted(call_ids):
            conn.execute(
                "INSERT INTO ingestion_runs (call_id, pipeline_version, "
                "chunking_config, embedding_config, ner_config) "
                "VALUES (?,?,?,?,?)",
                (call_id, PIPELINE_VERSION, chunking_config,
                 embedding_config, json.dumps(NER_CONFIG_DISABLED)),
            )
            inserted += 1
    return inserted


def run_embedding_backfill(
    *,
    batch_size: int,
    call_id: Optional[str] = None,
    source: str = "embed_backfill",
) -> BackfillSummary:
    from .provider import embeddings_enabled

    if not embeddings_enabled():
        raise RuntimeError("an embedding provider must be configured for backfill")
    if int(settings.embeddings_dim) <= 0:
        raise RuntimeError("EMBEDDINGS_DIM must be > 0")
    if batch_size <= 0:
        raise RuntimeError("EMBEDDINGS_BATCH_SIZE must be > 0")

    total = 0
    calls: Set[str] = set()
    model = settings.embeddings_model_id
    per_table: Dict[str, int] = {}
    learned = {"batch_size": max(1, int(batch_size))}
    for spec in TABLE_SPECS:
        updated = 0
        while True:
            rows = _pending_rows(spec, batch_size, call_id)
            if not rows:
                break
            # SQLite trim() strips only spaces; a '\n'- or '\xa0'-only
            # text passes the SQL pending filter but would be dropped by
            # the Python-side strip in embed_texts_adaptive — fewer
            # vectors than rows then wedged the backfill forever on the
            # same page. Blank texts carry no dense signal: store a zero
            # vector so the row leaves the pending set.
            blank = [r for r in rows if not str(r["content"] or "").strip()]
            live = [r for r in rows if str(r["content"] or "").strip()]
            if blank:
                dim = int(settings.embeddings_dim)
                _write_vectors(spec, blank, [[0.0] * dim] * len(blank))
                calls.update(row["call_id"] for row in blank)
                updated += len(blank)
            if not live:
                continue
            result = embed_texts_adaptive(
                [row["content"] for row in live],
                batch_size=learned["batch_size"], learned=learned,
            )
            _write_vectors(spec, live, result.vectors)
            calls.update(row["call_id"] for row in live)
            updated += len(live)
            model = result.model
        per_table[spec.table] = updated
        total += updated
    runs = _record_runs(calls, model, source)
    logger.info(
        "embed_backfill.complete rows=%s calls=%s", total, len(calls)
    )
    return BackfillSummary(
        rows_updated=total,
        calls_touched=len(calls),
        ingestion_runs_inserted=runs,
        model_used=model,
        per_table=per_table,
    )
