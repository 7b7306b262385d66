"""Retrieval and evidence-expansion request models."""

from __future__ import annotations

from datetime import datetime
from typing import List, Literal, Optional
from uuid import UUID

from pydantic import Field

from .common import ContractModel, ExpandChars, NonNegativeMs

Intent = Literal[
    "auto",
    "decision",
    "action_items",
    "who_said",
    "troubleshooting",
    "status",
]

ReturnStyle = Literal["evidence_pack_json", "ids_only"]


class Budget(ContractModel):
    """Evidence-pack size caps enforced during assembly
    (engine/retrieve.py pack loop)."""

    max_evidence_items: int = 8
    max_total_chars: int = 6000


class RetrieveFilters(ContractModel):
    """Scoping filters; all combine conjunctively. Date bounds apply to
    the call's started_at; call identity filters resolve to device-side
    call bitmaps (engine/filters.py)."""

    date_from: Optional[datetime] = None
    date_to: Optional[datetime] = None
    call_ids: Optional[List[UUID]] = None
    external_id: Optional[str] = None
    external_source: Optional[str] = None
    call_tags: Optional[List[str]] = None


class RetrieveRequest(ContractModel):
    query: str
    intent: Intent = "auto"
    filters: Optional[RetrieveFilters] = None
    budget: Budget = Field(default_factory=Budget)
    return_style: ReturnStyle = "evidence_pack_json"
    debug: bool = False


class ExpandRequest(ContractModel):
    """Expand one evidence id (Q-<chunk> via utterance ordinals or a
    window_ms time window; A-<artifact_chunk> as a bounded excerpt)."""

    evidence_id: str
    window_ms: NonNegativeMs = None
    max_chars: ExpandChars = 2000
