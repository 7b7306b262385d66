"""Wire-contract models for the HTTP API.

Field names, defaults and validation bounds are an API-compatibility
surface with the reference service (behavioral contract: reference
app/schemas.py:8-99) so its clients can switch over unchanged; the
package layout, validators and the typed response models are this
project's own (the reference returns untyped dicts).
"""

from .calls import CallRef, TranscriptPayload, UtteranceIn
from .common import ContractModel
from .ingest import (
    AnalysisArtifactIn,
    AnalysisIngestRequest,
    CallIngestRequest,
    ChunkingOptions,
    TranscriptIngestRequest,
)
from .responses import (
    EvidenceArtifact,
    EvidencePackResponse,
    EvidenceQuote,
    ExpandResponse,
    IdsOnlyResponse,
    IngestJobStatus,
    IngestTranscriptResponse,
)
from .retrieve import (
    Budget,
    ExpandRequest,
    Intent,
    RetrieveFilters,
    RetrieveRequest,
    ReturnStyle,
)

__all__ = [
    "AnalysisArtifactIn",
    "AnalysisIngestRequest",
    "Budget",
    "CallIngestRequest",
    "CallRef",
    "ChunkingOptions",
    "ContractModel",
    "EvidenceArtifact",
    "EvidencePackResponse",
    "EvidenceQuote",
    "ExpandRequest",
    "ExpandResponse",
    "IdsOnlyResponse",
    "IngestJobStatus",
    "IngestTranscriptResponse",
    "Intent",
    "RetrieveFilters",
    "RetrieveRequest",
    "ReturnStyle",
    "TranscriptIngestRequest",
    "TranscriptPayload",
    "UtteranceIn",
]
