"""cadence_rag_tpu_torch — the PyTorch + CUDA port of cadence_rag_tpu.

The JAX package (``cadence_rag_tpu``) stays the reference; this package
mirrors its module names so each counterpart is easy to find:

- ``ops``     — the /retrieve device program as torch ops, the IVF index
                (``ops.ivf``), and three hand-written Hopper kernels:
                ``ops.fused_scan`` (the fused dense+lexical scan),
                ``ops.dense_scan`` (the dense cosine scan) and
                ``ops.tech_keys`` (the tech lane's match keys). Their CUDA
                sources live in ``csrc/`` and are built by ``kernels.build``
                at first use.
- ``core``    — the device-resident index (``CorpusIndex``,
                ``DeviceIndexManager``) down to ``query_both_packed_async``
                and ``collect_packed``, with the chunks' IVF dense mode.
- ``engine``  — the dense-lane planner (exact, ivf or ann).
- ``evals``   — the synthetic corpus installer for scale runs, the ANN
                recall gate and the filtered-recall sweep.

Every function takes an explicit ``torch.device`` (``device.resolve_device``);
nothing here imports jax. Host-side featurization, hashing, the stub
embedder, settings and the native RRF core are reused from the JAX package's
jax-free modules.
"""

__version__ = "0.1.0"
