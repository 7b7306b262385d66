"""Featurization (counterpart of ``cadence_rag_tpu.ingest``)."""
