"""Ingest request models (transcripts, analysis artifacts, bare calls)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import Field, model_validator

from .calls import CallRef, TranscriptPayload
from .common import (
    ArtifactKind,
    ContractModel,
    NonNegativeTokens,
    PositiveTokens,
)


class ChunkingOptions(ContractModel):
    """Greedy-packer knobs (ingest/chunking.py): fill a chunk until
    ``target_tokens``, never exceed ``max_tokens``, back up at most
    ``overlap_tokens`` for inter-chunk context."""

    target_tokens: PositiveTokens = 350
    max_tokens: PositiveTokens = 600
    overlap_tokens: NonNegativeTokens = 50

    @model_validator(mode="after")
    def _coherent_packing_bounds(self) -> "ChunkingOptions":
        # a max below target could never terminate a fill greedily, and
        # an overlap >= target would re-emit whole chunks forever
        if self.max_tokens < self.target_tokens:
            raise ValueError(
                f"max_tokens ({self.max_tokens}) must not be below "
                f"target_tokens ({self.target_tokens})"
            )
        if self.overlap_tokens >= self.target_tokens:
            raise ValueError(
                f"overlap_tokens ({self.overlap_tokens}) must stay below "
                f"target_tokens ({self.target_tokens})"
            )
        return self


class TranscriptIngestRequest(ContractModel):
    transcript: TranscriptPayload
    call_ref: Optional[CallRef] = None
    options: Optional[ChunkingOptions] = None


class AnalysisArtifactIn(ContractModel):
    """One post-call analysis document (summary, action_items, ...).
    ``kind`` is a lowercase slug — it routes structure-aware chunking
    (bullet itemization for action_items/decisions)."""

    kind: ArtifactKind
    content: str
    metadata: Optional[Dict[str, Any]] = None


class AnalysisIngestRequest(ContractModel):
    call_ref: CallRef
    artifacts: List[AnalysisArtifactIn] = Field(default_factory=list)


class CallIngestRequest(ContractModel):
    call_ref: CallRef
