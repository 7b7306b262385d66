"""The reference's production topology on one device: the Qwen3-4B encoder
and the 1M-chunk index side by side, the embedding inside the /retrieve hot
path (the reference calls its embedding service on every retrieve,
app/retrieve.py:427, so embed time is retrieval time).

Counterpart of ``cadence_rag_tpu/evals/qwen3_coresident_bench.py``. The
encoder's weights (bf16, 8.04 GB at the 4b preset) are made first, then
the index beside them (``--emb-dtype int8`` by default, as in the JAX
package's bench).

Usage:
  python -m cadence_rag_tpu_torch.evals.qwen3_coresident_bench \
      [--n 1000000] [--batch 64] [--iters 10] [--preset 4b] [--device cuda|cpu]
Prints one JSON line per phase, then one with the result.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

N_CALLS = 1024

_TEMPLATES = (
    "ECONNRESET rollback on the object store gateway build {}",
    "tiering latency cluster retry budget shard {}",
    "lenovo bake-off azure rollout phase {}",
    "v2.3.{} gateway retry",
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--preset", default="4b")
    ap.add_argument("--emb-dtype", default="int8")
    ap.add_argument("--lex-dim", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="device of the index and the encoder: cuda "
                    "(default) or cpu")
    args = ap.parse_args()

    from ..config import settings
    from ..core.index import get_index, reset_index
    from ..device import resolve_device, set_models_device
    from ..schemas import RetrieveRequest
    from .synth import install_synthetic_corpus

    device = resolve_device(args.device)
    settings.embeddings_provider = "qwen3"
    settings.embeddings_base_url = ""
    settings.qwen3_preset = args.preset
    if args.preset == "tiny":  # CPU smoke shape
        settings.embeddings_dim = 32
    settings.index_embedding_dtype = args.emb_dtype
    settings.lexical_dim = args.lex_dim
    settings.index_initial_capacity = 4096
    settings.prewarm_growth_enabled = False
    settings.rerank_enabled = False

    # the encoder first (the big resident); then the index beside it
    from ..models.qwen3 import Qwen3EmbeddingProvider

    set_models_device(device)
    t0 = time.perf_counter()
    provider = Qwen3EmbeddingProvider.shared()
    params_gb = round(
        sum(p.numel() * p.element_size()
            for p in provider.model.parameters()) / 2**30, 2
    )
    init_s = round(time.perf_counter() - t0, 1)
    print(json.dumps({"phase": "qwen3_init", "s": init_s,
                      "params_gb": params_gb,
                      "model": provider.model_id}))

    reset_index()
    index = get_index(device)
    index.ensure_call_capacity(N_CALLS)
    t0 = time.perf_counter()
    install_synthetic_corpus(index.chunks, args.n, N_CALLS, seed=0)
    install_synthetic_corpus(
        index.artifacts, max(args.n // 10, 1024), N_CALLS, seed=1
    )
    print(json.dumps({"phase": "index_populate",
                      "s": round(time.perf_counter() - t0, 1)}))
    row_bytes = (
        index.chunks.dim * index.chunks.emb.element_size()
        + index.chunks.lex_dim + index.chunks.tech_slots * 4 + 12
    )
    index_gb = round(
        (index.chunks.capacity + index.artifacts.capacity)
        * row_bytes / 2**30, 2
    )

    from ..engine.retrieve import retrieve_evidence_batch

    def reqs(salt: int):
        return [
            RetrieveRequest(
                query=_TEMPLATES[j % 4].format(salt * 997 + j),
                return_style="ids_only",
            )
            for j in range(args.batch)
        ]

    t0 = time.perf_counter()
    retrieve_evidence_batch(reqs(0))
    print(json.dumps({"phase": "first_batch",
                      "s": round(time.perf_counter() - t0, 1)}))
    retrieve_evidence_batch(reqs(1))  # warm

    lat = []
    embed_ms = []
    for i in range(args.iters):
        batch_reqs = reqs(2 + i)
        t0 = time.perf_counter()
        out = retrieve_evidence_batch(batch_reqs)
        lat.append(time.perf_counter() - t0)
        assert len(out) == args.batch and out[0]["retrieved_ids"]
    # the embedding's share, measured on its own on like queries
    from ..embed.provider import embed_texts

    for i in range(max(args.iters // 2, 3)):
        texts = [r.query for r in reqs(50 + i)]
        t0 = time.perf_counter()
        embed_texts(texts)
        embed_ms.append((time.perf_counter() - t0) * 1e3)

    p50 = float(np.percentile(lat, 50))
    peak_gb = (round(torch.cuda.max_memory_allocated(device) / 2**30, 2)
               if device.type == "cuda" else None)
    print(json.dumps({
        "metric": (
            f"co-resident /retrieve QPS @ {args.n} chunks + Qwen3-"
            f"{args.preset} embed in the hot path (batch={args.batch}, "
            f"{args.emb_dtype} index)"
        ),
        "value": round(args.batch / p50, 1),
        "unit": "qps",
        "p50_batch_ms": round(p50 * 1e3, 1),
        "p50_per_query_ms": round(p50 * 1e3 / args.batch, 2),
        "embed_ms_per_batch_p50": round(float(np.median(embed_ms)), 1),
        "encoder_gb": params_gb,
        "index_gb": index_gb,
        "resident_gb": round(params_gb + index_gb, 2),
        "peak_allocated_gb": peak_gb,
        "iters": args.iters,
        "qps_spread": [
            round(args.batch / max(lat), 1), round(args.batch / min(lat), 1)
        ],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "model": provider.model_id,
    }))


if __name__ == "__main__":
    main()
