"""Retrieval engine (counterpart of ``cadence_rag_tpu.engine``): the
dense-lane planner, filter resolution, the /retrieve orchestration
(``engine.retrieve``) and the store-backed browse reads. Nothing is imported
here, so the planner loads without the HTTP stack."""
