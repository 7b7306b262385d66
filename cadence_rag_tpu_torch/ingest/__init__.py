"""Ingest (counterpart of ``cadence_rag_tpu.ingest``): featurization,
chunking and tech-token extraction, and the insert path into the store and
the device index (``ingest.ingest``)."""
