"""Embedding provider registry + the reference-compatible facade.

Counterpart of ``cadence_rag_tpu/embed/provider.py``. The registry builds
the HTTP client (``embed/client.py``), the deterministic stub
(``embed/stub.py``) and the in-process neural and Qwen3 embedders
(``models/embedder.py``, ``models/qwen3.py``), which live on the device the
process's entry point named (``device.models_device()``).

``embed_texts``/``embed_texts_batched``/``embeddings_enabled`` mirror the
reference client surface (reference: app/embeddings.py:21-100) so the
engine's degrade ladder (dense -> lexical_only on provider failure,
app/retrieve.py:425-431) carries over unchanged.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import List, Optional, Protocol, Sequence, Union

import numpy as np

from ..config import settings


class EmbeddingError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class EmbeddingResult:
    # (N, dim) float32 ndarray on the hot path; providers may hand back
    # List[List[float]] (e.g. parsed JSON) and the facade normalizes.
    # Iteration/len()/row-indexing behave identically either way.
    vectors: Union[np.ndarray, List[List[float]]]
    model: str


class EmbeddingProvider(Protocol):
    model_id: str

    def embed(self, texts: Sequence[str]) -> EmbeddingResult: ...


def _clean_texts(texts: Sequence[str]) -> List[str]:
    cleaned = [t.strip() for t in texts if isinstance(t, str) and t.strip()]
    if not cleaned:
        raise EmbeddingError("embedding request requires at least one non-empty text")
    return cleaned


def _check_dims(vectors: Sequence[Sequence[float]]) -> np.ndarray:
    """Validate and normalize to one (N, dim) float32 array: vectorized
    conversion keeps the reference's strict dim check (app/embeddings.py:
    36-45) without a per-element float() loop."""
    expected = int(settings.embeddings_dim)
    if not isinstance(vectors, np.ndarray):
        for i, vec in enumerate(vectors):
            if len(vec) != expected:
                raise EmbeddingError(
                    f"embedding {i} has dim {len(vec)}; expected {expected}"
                )
        try:
            vectors = np.asarray(vectors, dtype=np.float32)
        except (TypeError, ValueError) as exc:
            raise EmbeddingError(f"malformed embedding payload: {exc}") from exc
    out = np.asarray(vectors, dtype=np.float32)
    if out.ndim != 2 or out.shape[1] != expected:
        raise EmbeddingError(
            f"embedding batch has shape {out.shape}; expected (N, {expected})"
        )
    return out


def provider_kind() -> str:
    kind = (settings.embeddings_provider or "").strip().lower()
    if kind:
        return kind
    return "http" if settings.embeddings_base_url.strip() else ""


def embeddings_enabled() -> bool:
    return bool(provider_kind())


def get_provider() -> EmbeddingProvider:
    kind = provider_kind()
    if kind == "http":
        from .client import HttpEmbeddingProvider

        return HttpEmbeddingProvider()
    if kind == "stub":
        from .stub import HashEmbeddingProvider

        return HashEmbeddingProvider()
    if kind == "neural":
        from ..models.embedder import NeuralEmbeddingProvider

        return NeuralEmbeddingProvider.shared()
    if kind == "qwen3":
        from ..models.qwen3 import Qwen3EmbeddingProvider

        return Qwen3EmbeddingProvider.shared()
    raise EmbeddingError("no embedding provider configured")


# Cross-request embedding LRU (EMBED_CACHE_SIZE, opt-in): embeddings are
# a deterministic function of (provider, model, dim, text), so a hot
# query repeating ACROSS batch windows — request coalescing
# (engine/retrieve) already dedupes within one window — need not re-pay
# the provider. Keyed to invalidate on any provider/model/dim/weights
# change; vectors are stored post-validation and never mutated.
_CACHE: "OrderedDict[tuple, tuple[np.ndarray, str]]" = OrderedDict()
_CACHE_LOCK = threading.Lock()


def _cache_key(text: str) -> tuple:
    return (
        provider_kind(), settings.embeddings_model_id,
        int(settings.embeddings_dim), settings.embedder_params_path,
        settings.qwen3_preset, settings.qwen3_params_path, text,
    )


def reset_embed_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()


def _embed_validated(cleaned: List[str]) -> EmbeddingResult:
    result = get_provider().embed(cleaned)
    if len(result.vectors) != len(cleaned):
        raise EmbeddingError(
            f"embedding count mismatch: got {len(result.vectors)}, "
            f"expected {len(cleaned)}"
        )
    return EmbeddingResult(_check_dims(result.vectors), result.model)


def embed_texts(texts: Sequence[str]) -> EmbeddingResult:
    if not embeddings_enabled():
        raise EmbeddingError("no embedding provider configured")
    cleaned = _clean_texts(texts)
    cap = int(settings.embed_cache_size)
    if cap <= 0:
        return _embed_validated(cleaned)

    keys = [_cache_key(t) for t in cleaned]
    hits: dict = {}
    with _CACHE_LOCK:
        for key in keys:
            entry = _CACHE.get(key)
            if entry is not None:
                _CACHE.move_to_end(key)
                hits[key] = entry
    miss_idx = [i for i, k in enumerate(keys) if k not in hits]
    model = next(iter(hits.values()))[1] if hits else settings.embeddings_model_id
    if miss_idx:
        fresh = _embed_validated([cleaned[i] for i in miss_idx])
        model = fresh.model
        with _CACHE_LOCK:
            for j, i in enumerate(miss_idx):
                _CACHE[keys[i]] = (fresh.vectors[j], fresh.model)
                _CACHE.move_to_end(keys[i])
            while len(_CACHE) > cap:
                _CACHE.popitem(last=False)
        fresh_by_idx = dict(zip(miss_idx, fresh.vectors))
    else:
        fresh_by_idx = {}
    out = np.stack([
        fresh_by_idx[i] if i in fresh_by_idx else hits[keys[i]][0]
        for i in range(len(cleaned))
    ])
    return EmbeddingResult(out, model)


def embed_texts_batched(
    texts: Sequence[str], batch_size: Optional[int] = None
) -> EmbeddingResult:
    cleaned = _clean_texts(texts)
    size = batch_size or int(settings.embeddings_batch_size)
    if size <= 0:
        raise EmbeddingError("batch size must be > 0")
    vectors: List[np.ndarray] = []
    model = settings.embeddings_model_id
    for start in range(0, len(cleaned), size):
        result = embed_texts(cleaned[start : start + size])
        vectors.extend(result.vectors)
        model = result.model
    return EmbeddingResult(np.stack(vectors), model)
