"""Evaluation and scale-run helpers (counterpart of ``cadence_rag_tpu.evals``):
the synthetic corpus and store rows (``synth``), the ANN recall gate
(``ann_recall_gate``), the filtered-recall sweep (``filtered_recall_sweep``),
the fixture corpus and its end-to-end gate (``fixtures``, ``real_gate``)
and their metrics (``metrics``)."""
