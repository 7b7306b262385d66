"""Typed response models.

The reference returns untyped dicts from its endpoints; these models
document and pin the response contract (and are validated against live
engine output in tests/unit/test_schemas.py). The serving hot path
still emits plain dicts — constructing pydantic models per response
costs host time the 1-core serving box doesn't have — so these are the
*specification*, enforced by test, not a runtime wrapper.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import Field

from .common import ContractModel
from .retrieve import Budget


class EvidenceArtifact(ContractModel):
    """An artifact-chunk evidence item (``A-<id>``)."""

    evidence_id: str
    call_id: str
    artifact_id: int
    artifact_chunk_id: int
    kind: str
    snippet: str
    why_relevant: str


class EvidenceQuote(ContractModel):
    """A transcript-chunk evidence item (``Q-<id>``)."""

    evidence_id: str
    call_id: str
    chunk_id: int
    speaker: Optional[str]
    start_ts_ms: int
    end_ts_ms: int
    snippet: str
    why_relevant: str


class EvidencePackResponse(ContractModel):
    query_id: str
    intent: str
    budget: Budget
    artifacts: List[EvidenceArtifact]
    quotes: List[EvidenceQuote]
    # notes.retrieval carries the planner/config snapshot; its keys are
    # an observability surface, not a stability contract
    notes: Dict[str, Any]
    debug: Optional[Dict[str, Any]] = None


class IdsOnlyResponse(ContractModel):
    query_id: str
    retrieved_ids: List[str]
    notes: Optional[Dict[str, Any]] = None
    debug: Optional[Dict[str, Any]] = None


class ExpandResponse(ContractModel):
    """Q-* expansions carry chunk/timestamp fields; A-* carry kind."""

    evidence_id: str
    call_id: str
    snippet: str
    chunk_id: Optional[int] = None
    start_ts_ms: Optional[int] = None
    end_ts_ms: Optional[int] = None
    artifact_chunk_id: Optional[int] = None
    artifact_id: Optional[int] = None
    kind: Optional[str] = None


class IngestTranscriptResponse(ContractModel):
    call_id: str
    utterances: int
    chunks: int


class IngestJobStatus(ContractModel):
    ingest_job_id: str
    bundle_id: str
    status: str
    attempts: int
    error: Optional[str] = None
    files: List[Dict[str, Any]] = Field(default_factory=list)
