"""The benchmark of ``cadence_rag_tpu_torch``: ``POST /retrieve`` over HTTP.

One run of one cell: ``python -m rag_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything a cell
needs is found by name: ``BENCHMARK.json`` at the root, the deployment in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``, the
cell's own settings in ``workloads/<cell>.json``, the deployment's query
embedder in ``reference/embedders/<name>.py`` and one reader per per-layer
metric in ``metrics/<metric>.py``. ``reference/`` is the plain
PyTorch/NumPy reference that decides ``correct``; it imports nothing of the
program.
"""
