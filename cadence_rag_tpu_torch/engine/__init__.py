"""Query planning (counterpart of ``cadence_rag_tpu.engine``; the retrieval
engine itself is not ported yet)."""
