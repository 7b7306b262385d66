"""Embedding providers (counterpart of ``cadence_rag_tpu.embed``): the
deterministic stub only."""
