"""The /retrieve device program as torch ops (counterpart of
``cadence_rag_tpu.ops``).

- ``topk``       — dense cosine scores and the tie-safe exact top-k that
                   every top-k in the port goes through.
- ``lexical``    — the plain lexical lane (f32 query x int8 signatures).
- ``techlane``   — the plain tech-token lane (slot-aligned hash equality,
                   recency order).
- ``masks``      — call/date filter scoping as a (B, N) bool plane.
- ``fused_scan`` — kernel K1: dense + lexical scored in one pass over the
                   corpus, top-1 per group (the port's approximate top-k).
- ``dense_scan`` — kernel K2: the dense lane alone, top-1 per contiguous
                   group (the recall gate's ``pallas`` mode).
- ``ivf``        — the IVF index: k-means build, buckets, probed top-k.
- ``tech_keys``  — kernel K3: the tech lane's (recency, row) order keys.
- ``fusion``     — RRF on the device, and the host oracle merge.
- ``fused``      — one corpus's three lanes.
- ``pack``       — the packed single-buffer query transfer and flat output.
"""
