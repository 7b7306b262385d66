"""The cold tier on the card: rows past the device's cap, through the real
dispatch and merge.

Counterpart of ``cadence_rag_tpu/evals/coldtier_probe.py``. The cold tier
(``core/coldtier.py``, ``INDEX_MAX_DEVICE_ROWS``) is held to the uncapped
index on the CPU (``tests/test_torch_coldtier.py``). This probe runs the
same path on the card: an index capped at ``--hot`` device rows takes
``--cold`` more rows through ``CorpusIndex.insert``, which land in pinned
host memory; each batch, in ``exact``, through the blocking
``DeviceIndexManager.query_both_packed``, copies every cold block over PCIe
and runs the lane program on it (kernels K1 and K3), then merges the lanes.

Cold row 0 carries the first query's embedding, so it must be that query's
dense top-1: the probe raises otherwise. It prints the JAX probe's lines:
the set-up, the cold insert, the sentinel, the capped query's p50 ms a
batch with the cold MB a batch and QPS. The JAX probe's last line, a note
on the tunnel's rate, is here the measured rate of the cold blocks (the
bytes the tier shipped a batch over the batch's p50) beside the rate of a
bare pinned copy of one block in the same run (the card's PCIe rate, as
``evals/coldtier_bench`` measures it) and the ms the blocks would take at
that rate.

Usage:
  python -m cadence_rag_tpu_torch.evals.coldtier_probe [--device cuda|cpu]
      [--hot 65536] [--cold 8192] [--batch 32] [--block 8192] [--iters 3]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

N_CALLS = 64


def _cold_rows(start_id, n, dim, lex_dim, slots, n_calls, rng,
               sentinel_emb=None):
    """The JAX probe's rows, from the same draws of ``rng``."""
    from ..core.index import DocRow

    rows = []
    for i in range(n):
        emb = rng.standard_normal(dim).astype(np.float32)
        if sentinel_emb is not None and i == 0:
            emb = sentinel_emb.copy()
        emb /= np.linalg.norm(emb)
        sig = np.zeros(lex_dim, dtype=np.int8)
        touched = rng.choice(lex_dim, size=48, replace=False)
        sig[touched] = rng.integers(-8, 9, size=48)
        touched = np.flatnonzero(sig).astype(np.int32)
        tech = np.zeros(slots, dtype=np.int32)
        tech[rng.integers(0, slots)] = int(rng.integers(1, 5000))
        rows.append(DocRow(
            doc_id=start_id + i,
            call_seq=int(rng.integers(0, n_calls)),
            started_sec=int(rng.integers(1, 1 << 30)),
            lex_sig=sig,
            lex_dl=int(np.abs(sig).sum()),
            lex_touched=touched,
            tech=tech,
            embedding=emb,
        ))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the index: cuda (default; raises without "
                         "a card) or cpu")
    ap.add_argument("--hot", type=int, default=65536)
    ap.add_argument("--cold", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--block", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--lex-dim", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch

    from ..config import settings
    from ..core.coldtier import ColdTier
    from ..core.index import get_index, reset_index
    from ..device import resolve_device
    from .coldtier_bench import bare_h2d_gbps
    from .rtt_probe import device_name
    from .synth import install_synthetic_corpus

    settings.index_initial_capacity = 4096
    settings.index_max_device_rows = args.hot
    settings.cold_block_rows = args.block
    settings.prewarm_growth_enabled = False
    settings.lexical_dim = args.lex_dim

    device = resolve_device(args.device)
    reset_index()
    index = get_index(device)
    index.ensure_call_capacity(N_CALLS)
    print(f"backend={device.type} device={device_name(device)} hot={args.hot} "
          f"cold={args.cold} block={args.block} batch={args.batch}")
    install_synthetic_corpus(index.chunks, args.hot, N_CALLS, seed=0)
    install_synthetic_corpus(
        index.artifacts, max(args.hot // 10, 1024), N_CALLS, seed=1)

    dim = index.chunks.dim
    slots = index.chunks.tech_slots
    rng = np.random.default_rng(7)
    # sentinel: cold row 0 carries exactly the first query's embedding, so
    # the dense lane must surface it: cold rows compete
    q_emb = rng.standard_normal((args.batch, dim)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    t0 = time.perf_counter()
    sentinel_id = args.hot + 1
    for s in range(0, args.cold, 4096):
        n = min(4096, args.cold - s)
        index.chunks.insert(_cold_rows(
            args.hot + 1 + s, n, dim, args.lex_dim, slots, N_CALLS, rng,
            sentinel_emb=q_emb[0] if s == 0 else None,
        ))
    print(f"cold insert: {time.perf_counter() - t0:.1f}s "
          f"(host-side; tier count={index.chunks.cold.count})")
    if index.chunks.count != args.hot:
        raise RuntimeError(f"{index.chunks.count} hot rows, not {args.hot}")

    # an engine-free packed query (the /retrieve path below the planner)
    feats = []
    for _ in range(args.batch):
        b = rng.choice(args.lex_dim, size=24, replace=False).astype(np.int64)
        feats.append((b, rng.choice([-1.0, 1.0], 24).astype(np.float32),
                      np.ones(24, dtype=np.float32)))
    tech_q = int(settings.tech_hash_slots) * int(settings.tech_slot_capacity)
    q_tech = rng.integers(1, 5000, (args.batch, tech_q)).astype(np.int32)
    allowed = np.ones((args.batch, N_CALLS), dtype=bool)
    dmin = np.full(args.batch, -2147483647, dtype=np.int32)
    dmax = np.full(args.batch, 2**31 - 1, dtype=np.int32)

    def run():
        return index.query_both_packed(
            q_emb, feats, q_tech, allowed, dmin, dmax,
            chunk_ks=(50, 50, 50), artifact_ks=(10, 10, 50),
            chunk_mode="exact", artifact_mode="exact",
            recall_target=0.95,
        )

    chunks_res, _ = run()  # the kernels built, the staging allocated
    ids, scores, _counts = chunks_res["dense"]
    if int(ids[0, 0]) != sentinel_id:
        raise RuntimeError(f"sentinel cold row not top-1: got {ids[0, :5]}")
    print(f"sentinel OK: cold doc {sentinel_id} is dense top-1 "
          f"(score {float(scores[0, 0]):.4f})")

    shipped0 = ColdTier.bytes_shipped
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    block_bytes = (ColdTier.bytes_shipped - shipped0) / max(args.iters, 1)
    p50 = float(np.median(times)) * 1e3
    print(f"capped query: p50 {p50:.0f} ms/batch over {args.iters} iters "
          f"(cold H2D ~{block_bytes / 1e6:.0f} MB/batch; "
          f"{args.batch / (p50 / 1e3):.1f} QPS)")
    if device.type != "cuda":
        print("cold blocks: not measured (the index is on the CPU; no PCIe "
              "copy is made)")
        return
    tier = index.chunks.cold
    bare = bare_h2d_gbps(tier, min(args.block, tier.count))
    torch.cuda.synchronize(device)
    print(f"cold blocks: {block_bytes / (p50 / 1e3) / 1e9:.2f} GB/s measured "
          f"({block_bytes / 1e6:.0f} MB in the {p50:.1f} ms batch) beside a bare "
          f"pinned copy's {bare:.2f} GB/s over PCIe; at that rate the same "
          f"blocks cost ~{block_bytes / (bare * 1e9) * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
