"""Evaluation and scale-run helpers (counterpart of ``cadence_rag_tpu.evals``):
the synthetic corpus installer (``synth``), the ANN recall gate
(``ann_recall_gate``) and the filtered-recall sweep
(``filtered_recall_sweep``)."""
