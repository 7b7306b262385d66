"""Evaluation and scale-run helpers (counterpart of ``cadence_rag_tpu.evals``)."""
