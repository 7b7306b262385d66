"""Embedding providers and the backfill pipeline (counterpart of
``cadence_rag_tpu.embed``): the provider facade and registry (HTTP client,
deterministic stub), and ``pipeline.run_embedding_backfill``."""

from .provider import (  # noqa: F401
    EmbeddingError,
    EmbeddingResult,
    embed_texts,
    embed_texts_batched,
    embeddings_enabled,
    get_provider,
)
