"""Ingest core: call resolution/upsert, transcript + analysis ingest.

Counterpart of ``cadence_rag_tpu/ingest/ingest.py``: the insert path and
the startup rebuild, over the port's index. ``delete_call`` (tombstones and
compaction) is not ported yet (ROADMAP Queue 1 item 3).

Behavioral parity with the reference's ingest flows (reference:
app/ingest.py:366-755):

- call resolution precedence: call_id -> external_id(+source) ->
  (source_uri, source_hash) -> create; 404 on unknown call_id; 409 on
  ambiguous matches;
- transcript idempotency: sha256 over canonical (utterances, options) with
  INSERT-or-ignore into transcript_ingests; duplicates return (id, 0, 0);
- analysis artifacts: paragraph/bullet itemized artifact_chunks;
- every ingest records an ingestion_runs provenance row.

Difference from the reference: committed rows are featurized (lexical signature,
tech-token hashes) and appended to the device index immediately — SQLite is
durability, the device arrays are the search index. Store commit happens
first; a crash between commit and device insert is repaired by
rebuild_index_from_store() at startup.
"""

from __future__ import annotations

import functools
import json
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import settings
from ..core.index import CorpusIndex, DocRow, get_index
from ..logging_utils import get_logger
from ..schemas import AnalysisArtifactIn, CallRef, ChunkingOptions, UtteranceIn
from ..store.db import Store, from_json, get_store, to_json
from ..utils.errors import ApiError
from ..utils.timeutil import epoch_sec, now_utc, parse_iso, to_iso
from . import featurize
from .chunking import (
    PIPELINE_VERSION,
    Utterance,
    build_artifact_chunks,
    build_chunks,
    count_tokens,
    extract_tech_tokens,
    transcript_hash,
)

logger = get_logger(__name__)

EMBEDDING_CONFIG_DISABLED = {"enabled": False, "model_id": None, "dim": 1024}
NER_CONFIG_DISABLED = {"enabled": False}

# Store-only mode: standalone writer processes (ingest worker daemon,
# backfill CLIs) write the durable store and its trigger-maintained
# mutation log ONLY — their process-local device index would die with
# the process, and a serving process never sees it. The serving process
# tails the log (ingest/sync.py) and applies the device work itself.
# This is how the reference's 3-process topology guarantee (worker
# writes visible to the API instantly via shared Postgres,
# docker-compose.yml:22-102) is reproduced with an HBM-resident index.
_STORE_ONLY = False


def set_store_only(on: bool) -> None:
    global _STORE_ONLY
    _STORE_ONLY = bool(on)


def store_only() -> bool:
    return _STORE_ONLY


def _vocab_read_gated(fn):
    """Hold the vocab-layout read gate across featurize -> store write ->
    device insert (see featurize.vocab_gate). Gated functions must NOT
    call each other — the writer-preferring RWLock would deadlock on a
    nested read acquisition while a rebuild waits."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with featurize.vocab_gate.read():
            return fn(*args, **kwargs)

    return wrapper


def _featurize_avgdl(corpus_name: str, default: float) -> float:
    """avgdl for BM25 signature weighting at featurize time. Store-only
    writers have no live corpus; they use the last persisted stats
    (index_meta) so worker-ingested rows weight like API-ingested ones."""
    if not _STORE_ONLY:
        corpus = get_index().corpus(corpus_name)
        return corpus.avgdl or default
    with get_store().read() as conn:
        row = conn.execute(
            "SELECT avgdl FROM index_meta WHERE corpus = ?", (corpus_name,)
        ).fetchone()
    return float(row["avgdl"]) if row and row["avgdl"] else default


# ---------------------------------------------------------------- calls ----

def _row_to_call_tuple(row) -> Tuple[str, int, object]:
    return row["call_id"], int(row["call_seq"]), parse_iso(row["started_at"])


def _find_call(conn, call_ref: CallRef):
    if call_ref.call_id:
        row = conn.execute(
            "SELECT call_id, call_seq, started_at FROM calls WHERE call_id = ?",
            (str(call_ref.call_id),),
        ).fetchone()
        if not row:
            raise ApiError(404, "call_id not found")
        return row
    if call_ref.external_id:
        if call_ref.external_source is None:
            rows = conn.execute(
                "SELECT call_id, call_seq, started_at FROM calls "
                "WHERE external_id = ?",
                (call_ref.external_id,),
            ).fetchall()
        else:
            rows = conn.execute(
                "SELECT call_id, call_seq, started_at FROM calls "
                "WHERE external_id = ? AND COALESCE(external_source,'') = ?",
                (call_ref.external_id, call_ref.external_source or ""),
            ).fetchall()
        if len(rows) > 1:
            raise ApiError(409, "ambiguous external_id match")
        return rows[0] if rows else None
    if call_ref.source_uri and call_ref.source_hash:
        rows = conn.execute(
            "SELECT call_id, call_seq, started_at FROM calls "
            "WHERE source_uri = ? AND source_hash = ?",
            (call_ref.source_uri, call_ref.source_hash),
        ).fetchall()
        if len(rows) > 1:
            raise ApiError(409, "ambiguous source match")
        return rows[0] if rows else None
    return None


def _set_call_tags(conn, call_seq: int, tags) -> None:
    """Keep the inverted tag map (call_tags) in sync with calls.tags."""
    conn.execute("DELETE FROM call_tags WHERE call_seq = ?", (call_seq,))
    for tag in set(tags or []):
        conn.execute(
            "INSERT OR IGNORE INTO call_tags (tag, call_seq) VALUES (?, ?)",
            (str(tag), call_seq),
        )


def _update_call(conn, call_id: str, call_seq: int, call_ref: CallRef) -> None:
    if call_ref.tags is not None:
        _set_call_tags(conn, call_seq, call_ref.tags)
    conn.execute(
        """
        UPDATE calls SET
          external_id     = COALESCE(?, external_id),
          external_source = COALESCE(?, external_source),
          started_at      = COALESCE(?, started_at),
          ended_at        = COALESCE(?, ended_at),
          title           = COALESCE(?, title),
          source_uri      = COALESCE(?, source_uri),
          source_hash     = COALESCE(?, source_hash),
          participants    = COALESCE(?, participants),
          tags            = COALESCE(?, tags),
          metadata        = COALESCE(?, metadata)
        WHERE call_id = ?
        """,
        (
            call_ref.external_id,
            call_ref.external_source,
            to_iso(call_ref.started_at),
            to_iso(call_ref.ended_at),
            call_ref.title,
            call_ref.source_uri,
            call_ref.source_hash,
            to_json(call_ref.participants),
            to_json(call_ref.tags),
            to_json(call_ref.metadata),
            call_id,
        ),
    )


def _create_call(conn, call_ref: CallRef):
    call_id = str(uuid.uuid4())
    started_at = call_ref.started_at or now_utc()
    seq_row = conn.execute("SELECT COALESCE(MAX(call_seq), -1) FROM calls").fetchone()
    call_seq = int(seq_row[0]) + 1
    conn.execute(
        """
        INSERT INTO calls
          (call_id, call_seq, external_id, external_source, started_at,
           ended_at, title, source_uri, source_hash, participants, tags,
           metadata)
        VALUES (?,?,?,?,?,?,?,?,?,?,?,?)
        """,
        (
            call_id,
            call_seq,
            call_ref.external_id,
            call_ref.external_source,
            to_iso(started_at),
            to_iso(call_ref.ended_at),
            call_ref.title,
            call_ref.source_uri,
            call_ref.source_hash,
            to_json(call_ref.participants),
            to_json(call_ref.tags),
            json.dumps(call_ref.metadata or {}),
        ),
    )
    if call_ref.tags:
        _set_call_tags(conn, call_seq, call_ref.tags)
    return call_id, call_seq, started_at


def resolve_call(
    call_ref: Optional[CallRef], store: Optional[Store] = None
) -> Tuple[str, int, object, bool]:
    """-> (call_id, call_seq, started_at, created)."""
    call_ref = call_ref or CallRef()
    store = store or get_store()
    with store.tx() as conn:
        row = _find_call(conn, call_ref)
        if row is not None:
            call_id, call_seq, started_at = _row_to_call_tuple(row)
            _update_call(conn, call_id, call_seq, call_ref)
            # started_at may have just been filled in by the update
            if call_ref.started_at is not None and started_at is None:
                started_at = call_ref.started_at
            return call_id, call_seq, started_at, False
        call_id, call_seq, started_at = _create_call(conn, call_ref)
    if not _STORE_ONLY:
        get_index().ensure_call_capacity(call_seq + 1)
    return call_id, call_seq, started_at, True


def ingest_call(call_ref: CallRef) -> Tuple[str, bool]:
    call_id, _seq, _started, created = resolve_call(call_ref)
    return call_id, created


# ----------------------------------------------------------- provenance ----

def _record_run(conn, call_id: str, chunking_config: dict,
                embedding_config: dict, ner_config: dict) -> None:
    conn.execute(
        "INSERT INTO ingestion_runs (call_id, pipeline_version, "
        "chunking_config, embedding_config, ner_config) VALUES (?,?,?,?,?)",
        (
            call_id,
            PIPELINE_VERSION,
            json.dumps(chunking_config),
            json.dumps(embedding_config),
            json.dumps(ner_config),
        ),
    )


def persist_lexical_meta(store: Store, corpus: CorpusIndex) -> None:
    with store.tx() as conn:
        conn.execute(
            "INSERT INTO index_meta (corpus, doc_freq, avgdl, doc_count) "
            "VALUES (?,?,?,?) ON CONFLICT(corpus) DO UPDATE SET "
            "doc_freq=excluded.doc_freq, avgdl=excluded.avgdl, "
            "doc_count=excluded.doc_count",
            (
                corpus.name,
                corpus.doc_freq.astype(np.int64).tobytes(),
                float(corpus.avgdl),
                int(corpus.count),
            ),
        )


# ------------------------------------------------------------ transcript ----

@_vocab_read_gated
def ingest_transcript(
    call_ref: Optional[CallRef],
    utterances_in: Sequence[UtteranceIn],
    options: ChunkingOptions,
) -> Tuple[str, int, int]:
    store = get_store()
    index = None if _STORE_ONLY else get_index()
    call_id, call_seq, started_at, _created = resolve_call(call_ref, store)
    dedupe_key = transcript_hash(utterances_in, options)
    started_sec = epoch_sec(started_at)

    with store.tx() as conn:
        cur = conn.execute(
            "INSERT OR IGNORE INTO transcript_ingests (call_id, transcript_hash) "
            "VALUES (?,?)",
            (call_id, dedupe_key),
        )
        if cur.rowcount == 0:
            logger.info(
                "ingest_transcript.duplicate call_id=%s hash=%s",
                call_id, dedupe_key,
            )
            return call_id, 0, 0
        ingest_row_id = cur.lastrowid

        records: List[Utterance] = []
        for u in utterances_in:
            text_val = u.text.strip()
            cur = conn.execute(
                "INSERT INTO utterances (call_id, speaker, speaker_id, "
                "start_ts_ms, end_ts_ms, confidence, text) VALUES (?,?,?,?,?,?,?)",
                (call_id, u.speaker, u.speaker_id, u.start_ts_ms,
                 u.end_ts_ms, u.confidence, text_val),
            )
            records.append(
                Utterance(
                    utterance_id=cur.lastrowid,
                    speaker=u.speaker,
                    speaker_id=u.speaker_id,
                    start_ts_ms=u.start_ts_ms,
                    end_ts_ms=u.end_ts_ms,
                    confidence=u.confidence,
                    text=text_val,
                    token_count=count_tokens(text_val),
                )
            )

        chunks = build_chunks(records, options)
        doc_rows: List[DocRow] = []
        avgdl = _featurize_avgdl("chunks", 400.0)
        sigs = featurize.lexical_signatures_batch(
            [chunk.text for chunk in chunks], avgdl
        )
        vocab_version = featurize.active_vocab()[1]
        for chunk, (sig, touched, dl) in zip(chunks, sigs):
            tokens = extract_tech_tokens(chunk.text)
            cur = conn.execute(
                "INSERT INTO chunks (call_id, call_started_at, speaker, "
                "start_ts_ms, end_ts_ms, token_count, text, tech_tokens, "
                "lex_sig, lex_dl, lex_vocab_version) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (call_id, to_iso(started_at), chunk.speaker,
                 chunk.start_ts_ms, chunk.end_ts_ms, chunk.token_count,
                 chunk.text, json.dumps(tokens), sig.tobytes(), dl,
                 vocab_version),
            )
            chunk_id = cur.lastrowid
            conn.executemany(
                "INSERT INTO chunk_utterances (chunk_id, utterance_id, ordinal) "
                "VALUES (?,?,?)",
                [(chunk_id, uid, ordinal)
                 for ordinal, uid in enumerate(chunk.utterance_ids)],
            )
            doc_rows.append(
                DocRow(
                    doc_id=chunk_id,
                    call_seq=call_seq,
                    started_sec=started_sec,
                    lex_sig=sig,
                    lex_dl=dl,
                    lex_touched=touched,
                    tech=featurize.tech_slots(tokens),
                    embedding=None,
                )
            )

        _record_run(conn, call_id, options.model_dump(),
                    EMBEDDING_CONFIG_DISABLED, NER_CONFIG_DISABLED)
        conn.execute(
            "UPDATE transcript_ingests SET utterance_count=?, chunk_count=? "
            "WHERE transcript_ingest_id=?",
            (len(records), len(chunks), ingest_row_id),
        )

    if index is not None:
        index.chunks.insert(doc_rows)
        persist_lexical_meta(store, index.chunks)
    logger.info(
        "ingest_transcript.complete call_id=%s utterances=%s chunks=%s "
        "store_only=%s",
        call_id, len(records), len(chunks), _STORE_ONLY,
    )
    return call_id, len(records), len(chunks)


# -------------------------------------------------------------- analysis ----

@_vocab_read_gated
def ingest_analysis(
    call_ref: CallRef, artifacts: Sequence[AnalysisArtifactIn]
) -> Tuple[str, int]:
    store = get_store()
    index = None if _STORE_ONLY else get_index()
    call_id, call_seq, started_at, _created = resolve_call(call_ref, store)
    started_sec = epoch_sec(started_at)

    doc_rows: List[DocRow] = []
    with store.tx() as conn:
        for artifact in artifacts:
            content = artifact.content.strip()
            cur = conn.execute(
                "INSERT INTO analysis_artifacts (call_id, call_started_at, "
                "kind, content, token_count, tech_tokens, metadata) "
                "VALUES (?,?,?,?,?,?,?)",
                (call_id, to_iso(started_at), artifact.kind, content,
                 count_tokens(content),
                 json.dumps(extract_tech_tokens(content)),
                 json.dumps(artifact.metadata or {})),
            )
            artifact_id = cur.lastrowid
            avgdl = _featurize_avgdl("artifact_chunks", 60.0)
            art_chunks = build_artifact_chunks(artifact.kind, content)
            art_sigs = featurize.lexical_signatures_batch(
                [chunk.content for chunk in art_chunks], avgdl
            )
            vocab_version = featurize.active_vocab()[1]
            for chunk, (sig, touched, dl) in zip(art_chunks, art_sigs):
                cur = conn.execute(
                    "INSERT INTO artifact_chunks (artifact_id, call_id, "
                    "call_started_at, kind, ordinal, content, token_count, "
                    "start_char, end_char, tech_tokens, metadata, lex_sig, "
                    "lex_dl, lex_vocab_version) "
                    "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                    (artifact_id, call_id, to_iso(started_at), artifact.kind,
                     chunk.ordinal, chunk.content, chunk.token_count,
                     chunk.start_char, chunk.end_char,
                     json.dumps(chunk.tech_tokens),
                     json.dumps(artifact.metadata or {}),
                     sig.tobytes(), dl, vocab_version),
                )
                doc_rows.append(
                    DocRow(
                        doc_id=cur.lastrowid,
                        call_seq=call_seq,
                        started_sec=started_sec,
                        lex_sig=sig,
                        lex_dl=dl,
                        lex_touched=touched,
                        tech=featurize.tech_slots(chunk.tech_tokens),
                        embedding=None,
                    )
                )
        _record_run(
            conn, call_id,
            {"enabled": True, "mode": "analysis_artifact_chunks_v1",
             "itemized_kinds": sorted({"action_items", "decisions"})},
            EMBEDDING_CONFIG_DISABLED, NER_CONFIG_DISABLED,
        )

    if index is not None:
        index.artifacts.insert(doc_rows)
        persist_lexical_meta(store, index.artifacts)
    logger.info(
        "ingest_analysis.complete call_id=%s artifacts=%s store_only=%s",
        call_id, len(artifacts), _STORE_ONLY,
    )
    return call_id, len(artifacts)


# ---------------------------------------------------------------- rebuild ----

INDEXED_TABLES = (
    ("chunks", "chunk_id"),
    ("artifact_chunks", "artifact_chunk_id"),
)
TEXT_COLUMNS = {"chunks": "text", "artifact_chunks": "content"}

# Columns a DocRow needs back out of the store (featurized state is
# persisted at ingest, so no re-featurization on reload/sync — EXCEPT
# rows whose lex_vocab_version lags the active layout, which
# rehydrate_doc_rows repairs from doc_text). Callers format with
# text_col=TEXT_COLUMNS[table].
DOC_ROW_SELECT = (
    "SELECT t.{id_col} AS doc_id, t.call_started_at, t.lex_sig, "
    "t.lex_dl, t.lex_vocab_version, t.{text_col} AS doc_text, "
    "t.tech_tokens, t.embedding, c.call_seq "
    "FROM {table} t JOIN calls c ON c.call_id = t.call_id "
)


def doc_row_from_store_row(row) -> DocRow:
    """Rehydrate a device-index DocRow from a persisted store row (used
    by the startup rebuild AND the live store->index syncer)."""
    lex_dim = int(settings.lexical_dim)
    dim = int(settings.embeddings_dim)
    sig = (
        np.frombuffer(row["lex_sig"], dtype=np.int8).copy()
        if row["lex_sig"]
        else np.zeros(lex_dim, np.int8)
    )
    if sig.shape[0] != lex_dim:
        sig = np.zeros(lex_dim, np.int8)
    emb = None
    if row["embedding"]:
        emb = np.frombuffer(row["embedding"], dtype=np.float32).copy()
        if emb.shape[0] != dim:
            emb = None
    return DocRow(
        doc_id=int(row["doc_id"]),
        call_seq=int(row["call_seq"]),
        started_sec=epoch_sec(parse_iso(row["call_started_at"])),
        lex_sig=sig,
        lex_dl=int(row["lex_dl"]),
        lex_touched=np.flatnonzero(sig).astype(np.int32),
        tech=featurize.tech_slots(from_json(row["tech_tokens"]) or []),
        embedding=emb,
    )


def rehydrate_doc_rows(store: Store, table: str, rows) -> List[DocRow]:
    """DocRows from persisted store rows, REPAIRING any row whose
    signature was featurized under a stale vocab layout.

    A writer that raced an online vocab rebuild (core/vocab.py
    auto-rebuild; the window is one in-flight worker job) leaves an
    old-layout lex_sig stamped with the old lex_vocab_version. Such rows
    are re-featurized from text under the active layout and the
    corrected blob written back — but ONLY when this process's active
    vocab matches the store's applied vocab; a process whose own layout
    lags the store (it missed an external rebuild — forbidden by the
    offline contract, core/vocab.py) must not "repair" rows backward, so
    it logs an error directing a restart instead."""
    _, active = featurize.active_vocab()
    stale = [
        r for r in rows
        if int(r["lex_vocab_version"] or 0) != active
        and r["doc_text"] is not None
    ]
    repaired: dict = {}
    if stale:
        with store.read() as conn:
            row = conn.execute(
                "SELECT MAX(version) AS v FROM lex_vocab WHERE applied=1"
            ).fetchone()
        store_active = int(row["v"]) if row and row["v"] else 0
        if store_active != active:
            # Transient in a serving process: the StoreSyncer adopts the
            # store's layout at the top of its next poll
            # (core/vocab.adopt_store_layout), which re-scatters every
            # live row — including any inserted this tick — so the
            # mismatch self-heals. Processes without a syncer must
            # restart to re-activate.
            logger.error(
                "lex_vocab.layout_lag table=%s active=%s store=%s — this "
                "process's vocab layout is behind the store's (rows left "
                "as stored; the store syncer adopts the new layout on its "
                "next poll, otherwise restart this process)",
                table, active, store_active,
            )
        else:
            id_col = dict(INDEXED_TABLES)[table]
            avgdl = _featurize_avgdl(
                table, 400.0 if table == "chunks" else 60.0
            )
            sigs = featurize.lexical_signatures_batch(
                [r["doc_text"] for r in stale], avgdl
            )
            with store.tx() as conn:
                conn.executemany(
                    f"UPDATE {table} SET lex_sig=?, lex_dl=?, "
                    f"lex_vocab_version=? WHERE {id_col}=?",
                    [
                        (sig.tobytes(), int(dl), active, int(r["doc_id"]))
                        for (sig, _t, dl), r in zip(sigs, stale)
                    ],
                )
            repaired = {
                int(r["doc_id"]): trip for trip, r in zip(sigs, stale)
            }
            logger.warning(
                "lex_vocab.repaired_stale_sigs table=%s rows=%s "
                "active_version=%s", table, len(stale), active,
            )
    out: List[DocRow] = []
    for r in rows:
        doc = doc_row_from_store_row(r)
        trip = repaired.get(doc.doc_id)
        if trip is not None:
            sig, touched, dl = trip
            doc.lex_sig = sig
            doc.lex_dl = int(dl)
            doc.lex_touched = touched.astype(np.int32)
        out.append(doc)
    return out


def rebuild_index_from_store() -> Tuple[int, int]:
    """Reload device index state from SQLite (startup recovery; the
    reference's analogue is that Postgres IS its index — ours must be
    reconstructable, SURVEY.md §5 checkpoint/resume)."""
    store = get_store()
    index = get_index()
    totals = []
    with store.read() as conn:
        seq_row = conn.execute("SELECT COALESCE(MAX(call_seq),-1) FROM calls").fetchone()
        max_seq = int(seq_row[0])
    index.ensure_call_capacity(max_seq + 1)
    for table, id_col in INDEXED_TABLES:
        corpus = index.corpus(table)
        with store.read() as conn:
            rows = conn.execute(
                DOC_ROW_SELECT.format(
                    id_col=id_col, table=table,
                    text_col=TEXT_COLUMNS[table],
                )
                + f"ORDER BY t.{id_col} ASC"
            ).fetchall()
        rows_out = rehydrate_doc_rows(store, table, rows)
        if rows_out:
            corpus.insert(rows_out)
        totals.append(len(rows_out))
    return tuple(totals)  # type: ignore[return-value]
