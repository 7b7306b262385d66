"""Transport-agnostic API errors.

The reference raises fastapi.HTTPException from domain code; our domain
layer stays framework-free and the serve layer maps ApiError -> HTTP status.
"""

from __future__ import annotations


class ApiError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail
