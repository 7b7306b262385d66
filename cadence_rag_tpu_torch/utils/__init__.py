"""Host utilities (counterpart of ``cadence_rag_tpu.utils``)."""
