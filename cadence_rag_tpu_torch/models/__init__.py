"""In-process models (counterpart of ``cadence_rag_tpu.models``): the neural
text embedder (``embedder``), the cross-encoder reranker (``reranker``), the
Qwen3-Embedding-4B-shaped encoder (``qwen3``), the byte-level BPE tokenizer
(``tokenizer``) and JAX's default random numbers in torch (``prng``), which
reproduce the JAX package's seeded weights and the embedder artifact's
unstored bag head."""
