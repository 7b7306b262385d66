"""Call identity and transcript turn models.

``CallRef`` is the polymorphic call handle every ingest surface accepts:
any one of call_id / external_id / (source_uri + source_hash) resolves or
creates the call, in that precedence order (resolution semantics live in
ingest/ingest.py; contract parity: reference app/ingest.py:416-502).
"""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, List, Literal, Optional
from uuid import UUID

from .common import ContractModel


class CallRef(ContractModel):
    """Reference to a call record — identity fields first, then the
    descriptive fields applied on create/update."""

    # identity (resolution precedence order)
    call_id: Optional[UUID] = None
    external_id: Optional[str] = None
    external_source: Optional[str] = None
    source_uri: Optional[str] = None
    source_hash: Optional[str] = None
    # descriptive
    started_at: Optional[datetime] = None
    ended_at: Optional[datetime] = None
    title: Optional[str] = None
    participants: Optional[List[Dict[str, Any]]] = None
    tags: Optional[List[str]] = None
    metadata: Optional[Dict[str, Any]] = None


class UtteranceIn(ContractModel):
    """One transcript turn. Timestamps are call-relative milliseconds."""

    start_ts_ms: int
    end_ts_ms: int
    text: str
    speaker: Optional[str] = None
    speaker_id: Optional[str] = None
    confidence: Optional[float] = None


class TranscriptPayload(ContractModel):
    """A strict-JSON transcript body. Other formats (markdown, tolerant
    auto-mapping) normalize to this shape in ingest/adapters.py before
    hitting the API contract."""

    format: Literal["json_turns"] = "json_turns"
    content: List[UtteranceIn]
