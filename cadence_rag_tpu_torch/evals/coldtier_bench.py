"""Beyond-device-memory capture: N total rows = hot device tier + host cold
tier, measured through the REAL dispatch/merge path.

Counterpart of ``cadence_rag_tpu/evals/coldtier_bench.py``. Every query
batch streams the cold rows through the device in COLD_BLOCK_ROWS blocks via
the same lane program (kernels K1 and K3 on the card) and merges lanes
before RRF; the dominating cost is host->device bytes, so the capture
reports bytes per batch and the achieved host-to-device rate alongside
latency, and beside them the rate a bare pinned ``copy_`` of one block
reaches in the same run (the bound).

Usage:
  python -m cadence_rag_tpu_torch.evals.coldtier_bench [--device cuda|cpu]
      [--hot 524288] [--cold 524288] [--batch 128] [--iters 3]
Prints JSON lines; the last one is the measurement.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

N_CALLS = 1024


def bare_h2d_gbps(tier, rows: int, iters: int = 3) -> float:
    """GB/s of non-blocking copies of the tier's first ``rows`` rows from
    its pinned arrays into its staging tensors, with nothing else queued."""
    staging = tier._staging_for(rows)
    nbytes = 0
    torch.cuda.synchronize(tier.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        for dst, src in zip(staging, tier.row_arrays()):
            dst[:rows].copy_(src[:rows], non_blocking=True)
            nbytes += src[:rows].numel() * src.element_size()
    torch.cuda.synchronize(tier.device)
    return nbytes / (time.perf_counter() - t0) / 1e9


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the index: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--hot", type=int, default=524_288)
    ap.add_argument("--cold", type=int, default=524_288)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--lex-dim", type=int, default=4096)
    ap.add_argument("--emb-dtype", default="bfloat16")
    args = ap.parse_args()

    from ..config import settings
    from ..core.coldtier import ColdTier
    from ..core.index import get_index, reset_index
    from .synth import install_synthetic_cold, install_synthetic_corpus

    settings.index_embedding_dtype = args.emb_dtype
    settings.lexical_dim = args.lex_dim
    settings.index_initial_capacity = 4096
    settings.index_max_device_rows = args.hot
    settings.prewarm_growth_enabled = False
    reset_index()
    index = get_index(args.device)
    index.ensure_call_capacity(N_CALLS)
    cuda = index.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(index.device)

    t0 = time.perf_counter()
    install_synthetic_corpus(index.chunks, args.hot, N_CALLS, seed=0)
    install_synthetic_corpus(
        index.artifacts, max(args.hot // 10, 1024), N_CALLS, seed=1)
    sync()
    hot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    install_synthetic_cold(index.chunks, args.cold, N_CALLS, seed=2)
    cold_s = time.perf_counter() - t0
    print(json.dumps({"phase": "populate", "hot_s": round(hot_s, 1),
                      "cold_s": round(cold_s, 1)}))

    dim = index.chunks.dim
    F = int(settings.query_lex_features)
    tech_q = int(settings.tech_hash_slots) * int(settings.tech_slot_capacity)
    rng = np.random.default_rng(7)
    q_emb = rng.standard_normal((args.batch, dim)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    feats = [
        (rng.integers(0, args.lex_dim, F).astype(np.int64),
         np.ones(F, np.float32), np.ones(F, np.float32))
        for _ in range(args.batch)
    ]
    q_tech = rng.integers(1, 5000, (args.batch, tech_q)).astype(np.int32)
    allowed = np.ones((args.batch, N_CALLS), dtype=bool)
    dmin = np.full(args.batch, -2147483647, np.int32)
    dmax = np.full(args.batch, 2**31 - 1, np.int32)

    def one_batch():
        return index.query_both_packed(
            q_emb, feats, q_tech, allowed, dmin, dmax,
            chunk_ks=(50, 50, 50), artifact_ks=(10, 10, 50),
            chunk_mode="ann", artifact_mode="ann", recall_target=0.95,
        )

    t0 = time.perf_counter()
    one_batch()   # kernels built, staging tensors allocated
    print(json.dumps({"phase": "first_batch",
                      "s": round(time.perf_counter() - t0, 2)}))

    shipped0 = ColdTier.bytes_shipped
    lat = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        one_batch()
        lat.append(time.perf_counter() - t0)
    cold_bytes = (ColdTier.bytes_shipped - shipped0) / max(args.iters, 1)
    p50 = float(np.percentile(lat, 50))
    tier = index.chunks.cold
    block = min(int(settings.cold_block_rows), tier.count)
    out = {
        "metric": (
            f"beyond-device-memory batch p50 @ {args.hot + args.cold} rows "
            f"({args.hot} hot + {args.cold} cold, {args.emb_dtype}, "
            f"batch={args.batch})"
        ),
        "value": round(p50 * 1e3, 1),
        "unit": "ms_per_batch",
        "qps": round(args.batch / p50, 1),
        "cold_bytes_per_batch_gb": round(cold_bytes / 1e9, 3),
        "h2d_gbps_effective": (round(cold_bytes / p50 / 1e9, 3)
                               if cuda else None),
        "h2d_gbps_bare_copy": (round(bare_h2d_gbps(tier, block), 3)
                               if cuda else None),
        "iters": args.iters,
        "lat_s": [round(x, 3) for x in lat],
        "device": (torch.cuda.get_device_name(index.device) if cuda
                   else "cpu"),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
