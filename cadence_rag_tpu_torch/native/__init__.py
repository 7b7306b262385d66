"""Native (C++) host components, built with g++ at first use into
``build/cadence_rag_tpu_torch/native/`` (``native/build.py``): the lexical
featurizer, the RRF merge core and the HNSW graph. Copies of ``cadence_rag_tpu/native``'s; each has a
numpy path or a clear error where g++ is missing."""
