"""HTTP embedding client (reference-compatible `/embed` contract).

POST {base}/embed {"texts": [...], "model": id} -> {"embeddings": [[...]],
"model": id}; non-200, transport errors, missing/miscounted vectors all
raise EmbeddingError (reference contract: app/embeddings.py:48-82).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import httpx

from ..config import settings
from .provider import EmbeddingError, EmbeddingResult


_pool_lock = threading.Lock()
_pool: Optional[tuple] = None  # (timeout_s, httpx.Client)


def _pooled_client(timeout_s: float) -> "httpx.Client":
    """One shared connection-pooling client (httpx.Client is
    thread-safe): the previous per-call Client paid full TCP/TLS setup
    on every dense retrieve and every backfill batch to the same host
    (~1600 connections for a 100k-row backfill at batch 64)."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != timeout_s:
            if _pool is not None:
                try:
                    _pool[1].close()
                except Exception:
                    pass
            _pool = (
                timeout_s, httpx.Client(timeout=httpx.Timeout(timeout_s))
            )
        return _pool[1]


class HttpEmbeddingProvider:
    def __init__(self) -> None:
        base = settings.embeddings_base_url.strip().rstrip("/")
        if not base:
            raise EmbeddingError("EMBEDDINGS_BASE_URL is not configured")
        self.base_url = base
        self.model_id = settings.embeddings_model_id

    def embed(self, texts: Sequence[str]) -> EmbeddingResult:
        payload = {"texts": list(texts), "model": self.model_id}
        try:
            response = _pooled_client(
                float(settings.embeddings_timeout_s)
            ).post(f"{self.base_url}/embed", json=payload)
        except httpx.HTTPError as exc:
            raise EmbeddingError(f"embedding HTTP request failed: {exc}") from exc
        if response.status_code != 200:
            detail = response.text.strip()[:400]
            raise EmbeddingError(
                f"embedding service returned {response.status_code}: {detail}"
            )
        try:
            body = response.json()
        except ValueError as exc:
            # a proxy returning 200 with an HTML error page must degrade
            # like every other provider failure (the engine's
            # dense->lexical_only ladder catches EmbeddingError only)
            raise EmbeddingError(
                f"embedding service returned non-JSON body: "
                f"{response.text.strip()[:200]}"
            ) from exc
        raw = body.get("embeddings")
        if not isinstance(raw, list):
            raise EmbeddingError("embedding response missing 'embeddings' list")
        return EmbeddingResult(
            vectors=raw, model=str(body.get("model") or self.model_id)
        )
