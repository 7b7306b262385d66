"""Throughput and footprint of the Qwen3-shaped encoder on one device.

Counterpart of ``cadence_rag_tpu/evals/qwen3_bench.py``: texts/s and device
memory of the Qwen3-Embedding-4B-shaped forward pass at serving shapes.
Weights are synthetic (``models/qwen3.init_params``, made on the device);
the compute and memory profile is a real checkpoint's.

Usage:
  python -m cadence_rag_tpu_torch.evals.qwen3_bench [--preset 4b]
      [--configs 8x128,8x512,4x1024] [--iters 8] [--device cuda|cpu]

Each config runs once untimed, then ``iters`` batches back to back; the
time is the wall clock from the first launch to the last result, over
``iters``. Prints one JSON line per config.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(preset_name: str, configs, iters: int, device="cuda") -> None:
    from ..models import prng
    from ..models import qwen3 as q3

    device = resolve_device(device)
    cfg = q3.preset(preset_name)
    n_params = cfg.param_count()
    t0 = time.perf_counter()
    model = q3.init_params(cfg, prng.PRNGKey(0), device)
    _sync(device)
    init_s = time.perf_counter() - t0
    weight_gb = n_params * 2 / 1e9  # bf16 (the f32 norms are negligible)
    print(json.dumps({
        "preset": preset_name, "params": n_params,
        "weight_gb": round(weight_gb, 2), "init_s": round(init_s, 1),
        "device": str(device),
    }), flush=True)

    rng = np.random.default_rng(0)
    for batch, seq in configs:
        tokens = torch.from_numpy(rng.integers(
            1, cfg.vocab_buckets, size=(batch, seq)
        ).astype(np.int64)).to(device)
        t0 = time.perf_counter()
        out = model(tokens)
        _sync(device)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model(tokens)
        out = out.cpu()
        ms = (time.perf_counter() - t0) / iters * 1e3
        print(json.dumps({
            "preset": preset_name, "batch": batch, "seq": seq,
            "first_s": round(first_s, 2),
            "ms_per_batch": round(ms, 2),
            "texts_per_s": round(batch / (ms / 1e3), 1),
            "tokens_per_s": round(batch * seq / (ms / 1e3), 0),
            "out_dim": int(out.shape[1]),
        }), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="4b")
    p.add_argument("--configs", default="8x128,8x512,4x1024")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args()
    configs = []
    for part in args.configs.split(","):
        b, s = part.strip().split("x")
        configs.append((int(b), int(s)))
    run(args.preset, configs, args.iters, args.device)


if __name__ == "__main__":
    main()
