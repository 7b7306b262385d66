"""Shared building blocks for the wire-contract models.

The *contract* (field names, defaults, bounds) mirrors the reference
service so its clients can switch over unchanged (behavioral contract:
reference app/schemas.py:8-99); the *implementation* is this package's
own: annotated constraint aliases here, one module per API area, and
typed response models the reference never had (it returned bare dicts).
"""

from __future__ import annotations

from typing import Annotated, Optional

from pydantic import BaseModel, Field

# Constraint vocabulary used across the request models. Centralizing the
# bounds makes the parity surface auditable in one place (and the parity
# test in tests/unit/test_schemas.py pins each one).
PositiveTokens = Annotated[int, Field(ge=1)]
NonNegativeTokens = Annotated[int, Field(ge=0)]
NonNegativeMs = Annotated[Optional[int], Field(ge=0)]
ExpandChars = Annotated[int, Field(ge=1, le=20_000)]
ArtifactKind = Annotated[
    str, Field(min_length=1, max_length=64, pattern=r"^[a-z0-9_]+$")
]


class ContractModel(BaseModel):
    """Base for all wire models; a single place to hang model_config if
    the serialization policy ever needs to change package-wide."""
