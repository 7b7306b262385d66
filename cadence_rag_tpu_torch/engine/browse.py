"""Browse/expand: calls listing, chunk lookup, evidence expansion.

Behavioral parity with the reference browse layer (reference:
app/browse.py): keyset cursor pagination over (started_at, call_id) encoded
base64; call detail with utterance/chunk/artifact counts; `Q-<chunk_id>`
expansion through chunk_utterances ordinals or a ±window_ms time window;
`A-<artifact_chunk_id>` bounded excerpt.
"""

from __future__ import annotations

import base64
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

from ..store.db import from_json, get_store
from ..utils.errors import ApiError
from ..utils.timeutil import to_iso


def _encode_cursor(started_at: str, call_id: str) -> str:
    return base64.urlsafe_b64encode(
        f"{started_at}|{call_id}".encode("utf-8")
    ).decode("utf-8")


def _decode_cursor(cursor: str) -> Tuple[str, str]:
    try:
        raw = base64.urlsafe_b64decode(cursor.encode("utf-8")).decode("utf-8")
        started_at, call_id = raw.split("|", 1)
        datetime.fromisoformat(started_at)
        return started_at, call_id
    except Exception as exc:
        raise ApiError(400, "invalid cursor") from exc


def _call_payload(row) -> Dict[str, Any]:
    return {
        "call_id": row["call_id"],
        "started_at": row["started_at"],
        "ended_at": row["ended_at"],
        "title": row["title"],
        "external_id": row["external_id"],
        "external_source": row["external_source"],
        "source_uri": row["source_uri"],
        "source_hash": row["source_hash"],
        "tags": from_json(row["tags"]) or [],
        "participants": from_json(row["participants"]),
        "metadata": from_json(row["metadata"]),
        "created_at": row["created_at"],
    }


def list_calls(
    *,
    limit: int,
    cursor: Optional[str] = None,
    date_from: Optional[datetime] = None,
    date_to: Optional[datetime] = None,
    tags: Optional[List[str]] = None,
    external_id: Optional[str] = None,
    external_source: Optional[str] = None,
) -> Dict[str, Any]:
    limit = max(1, min(limit, 200))
    clauses: List[str] = []
    params: List[Any] = []
    if date_from:
        clauses.append("started_at >= ?")
        params.append(to_iso(date_from))
    if date_to:
        clauses.append("started_at <= ?")
        params.append(to_iso(date_to))
    if external_id:
        clauses.append("external_id = ?")
        params.append(external_id)
        if external_source is not None:
            clauses.append("COALESCE(external_source,'') = ?")
            params.append(external_source)
    elif external_source:
        clauses.append("external_source = ?")
        params.append(external_source)
    if tags:
        # tag overlap in SQL via the inverted tag map (the reference's
        # `tags && :arr` before LIMIT) — filtering AFTER fetching
        # limit+1 rows returned under-filled pages and terminated
        # pagination early whenever a page's newest rows lacked the tag
        wanted = sorted({str(t) for t in tags})
        placeholders = ",".join("?" * len(wanted))
        clauses.append(
            f"call_seq IN (SELECT call_seq FROM call_tags "
            f"WHERE tag IN ({placeholders}))"
        )
        params.extend(wanted)
    if cursor:
        c_started, c_call = _decode_cursor(cursor)
        clauses.append("(started_at < ? OR (started_at = ? AND call_id < ?))")
        params.extend([c_started, c_started, c_call])

    where_sql = " AND ".join(clauses) if clauses else "1=1"
    store = get_store()
    with store.read() as conn:
        rows = conn.execute(
            f"SELECT * FROM calls WHERE {where_sql} "
            f"ORDER BY started_at DESC, call_id DESC LIMIT ?",
            [*params, limit + 1],
        ).fetchall()

    next_cursor = None
    if len(rows) > limit:
        last = rows[limit - 1]
        next_cursor = _encode_cursor(last["started_at"], last["call_id"])
        rows = rows[:limit]
    return {"items": [_call_payload(r) for r in rows], "next_cursor": next_cursor}


def get_call(call_id: str) -> Dict[str, Any]:
    store = get_store()
    with store.read() as conn:
        row = conn.execute(
            "SELECT * FROM calls WHERE call_id = ?", (call_id,)
        ).fetchone()
        if not row:
            raise ApiError(404, "call not found")
        counts = {
            "utterances": conn.execute(
                "SELECT COUNT(*) FROM utterances WHERE call_id = ?", (call_id,)
            ).fetchone()[0],
            "chunks": conn.execute(
                "SELECT COUNT(*) FROM chunks WHERE call_id = ?", (call_id,)
            ).fetchone()[0],
            "artifacts": conn.execute(
                "SELECT COUNT(*) FROM analysis_artifacts WHERE call_id = ?",
                (call_id,),
            ).fetchone()[0],
        }
        artifacts = conn.execute(
            "SELECT artifact_id, kind, token_count, created_at "
            "FROM analysis_artifacts WHERE call_id = ? ORDER BY created_at ASC",
            (call_id,),
        ).fetchall()
    return {
        "call": _call_payload(row),
        "counts": counts,
        "artifacts": [
            {
                "artifact_id": a["artifact_id"],
                "kind": a["kind"],
                "token_count": a["token_count"],
                "created_at": a["created_at"],
            }
            for a in artifacts
        ],
    }


def get_chunk(chunk_id: int) -> Dict[str, Any]:
    store = get_store()
    with store.read() as conn:
        row = conn.execute(
            "SELECT chunk_id, call_id, speaker, start_ts_ms, end_ts_ms, "
            "token_count, text, tech_tokens FROM chunks WHERE chunk_id = ?",
            (chunk_id,),
        ).fetchone()
    if not row:
        raise ApiError(404, "chunk not found")
    return {
        "chunk_id": row["chunk_id"],
        "call_id": row["call_id"],
        "speaker": row["speaker"],
        "start_ts_ms": row["start_ts_ms"],
        "end_ts_ms": row["end_ts_ms"],
        "token_count": row["token_count"],
        "text": row["text"],
        "tech_tokens": from_json(row["tech_tokens"]) or [],
    }


def _clip(text: str, max_chars: int) -> str:
    if max_chars <= 0:
        return ""
    if len(text) <= max_chars:
        return text
    return text[: max_chars - 1].rstrip() + "…"


def expand_evidence(
    evidence_id: str, *, window_ms: Optional[int], max_chars: int
) -> Dict[str, Any]:
    store = get_store()
    if evidence_id.startswith("Q-"):
        try:
            chunk_id = int(evidence_id.split("-", 1)[1])
        except ValueError as exc:
            raise ApiError(400, "unsupported evidence_id") from exc
        with store.read() as conn:
            chunk = conn.execute(
                "SELECT chunk_id, call_id, start_ts_ms, end_ts_ms "
                "FROM chunks WHERE chunk_id = ?",
                (chunk_id,),
            ).fetchone()
            if not chunk:
                raise ApiError(404, "chunk not found")
            if window_ms and window_ms > 0:
                utts = conn.execute(
                    "SELECT speaker, start_ts_ms, end_ts_ms, text FROM utterances "
                    "WHERE call_id = ? AND start_ts_ms <= ? AND end_ts_ms >= ? "
                    "ORDER BY start_ts_ms ASC",
                    (
                        chunk["call_id"],
                        chunk["end_ts_ms"] + window_ms,
                        chunk["start_ts_ms"] - window_ms,
                    ),
                ).fetchall()
            else:
                utts = conn.execute(
                    "SELECT u.speaker, u.start_ts_ms, u.end_ts_ms, u.text "
                    "FROM chunk_utterances cu "
                    "JOIN utterances u ON u.utterance_id = cu.utterance_id "
                    "WHERE cu.chunk_id = ? ORDER BY cu.ordinal ASC",
                    (chunk_id,),
                ).fetchall()
        if utts:
            snippet = "\n".join(
                f"{u['speaker']}: {u['text']}" if u["speaker"] else u["text"]
                for u in utts
            )
            start_ts, end_ts = utts[0]["start_ts_ms"], utts[-1]["end_ts_ms"]
        else:
            snippet, start_ts, end_ts = "", chunk["start_ts_ms"], chunk["end_ts_ms"]
        return {
            "evidence_id": evidence_id,
            "call_id": chunk["call_id"],
            "chunk_id": chunk_id,
            "start_ts_ms": start_ts,
            "end_ts_ms": end_ts,
            "snippet": _clip(snippet, max_chars),
        }

    if evidence_id.startswith("A-"):
        try:
            artifact_chunk_id = int(evidence_id.split("-", 1)[1])
        except ValueError as exc:
            raise ApiError(400, "unsupported evidence_id") from exc
        with store.read() as conn:
            row = conn.execute(
                "SELECT artifact_chunk_id, artifact_id, call_id, kind, content "
                "FROM artifact_chunks WHERE artifact_chunk_id = ?",
                (artifact_chunk_id,),
            ).fetchone()
        if not row:
            raise ApiError(404, "artifact chunk not found")
        return {
            "evidence_id": evidence_id,
            "call_id": row["call_id"],
            "artifact_id": row["artifact_id"],
            "artifact_chunk_id": row["artifact_chunk_id"],
            "kind": row["kind"],
            "snippet": _clip(row["content"], max_chars),
        }

    raise ApiError(400, "unsupported evidence_id")
