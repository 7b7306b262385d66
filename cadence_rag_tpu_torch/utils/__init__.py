"""Host utilities (counterpart of ``cadence_rag_tpu.utils``): the event log,
API errors, time helpers and the reader-writer lock."""
