"""Host-to-device latency and rate over PCIe from 64 KB to 32 MB, through
the upload ``/retrieve`` makes, plus a back-to-back pair.

Counterpart of ``cadence_rag_tpu/evals/h2d_probe.py``, which runs at import.
Each size is staged by ``core/index._stage`` (numpy -> a pinned host copy
from PyTorch's caching host allocator -> a non-blocking H2D copy) and
waited for with a device synchronize: ``h2d_<kb>kb_p50_ms`` over
``--iters`` uploads and ``h2d_<kb>kb_mbps`` from it (MB of 2^20 bytes, as
the JAX probe counts). The JAX probe's untimed first upload of each size is
timed here as ``h2d_<kb>kb_first_ms``: it is the one whose pinned buffer the
caching allocator does not hold yet (``cudaHostAlloc``); the later ones
reuse it. ``h2d_2x671kb_p50_ms``: two 671 KB uploads enqueued back to back,
then one wait (671 KB is the packed batch of 128 at the default widths).
Informs the packed buffer's size budget.

Usage:
  python -m cadence_rag_tpu_torch.evals.h2d_probe [--device cuda|cpu]
      [--iters 10]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

SIZES_KB = (64, 256, 671, 1024, 4096, 32768)


def run(device="cuda", iters: int = 10) -> Dict:
    from ..core.index import _stage
    from ..device import resolve_device
    from .rtt_probe import device_name, p50_ms

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def upload(x):
        _stage(x, dev)
        sync()

    rec: Dict = {}
    for kb in SIZES_KB:
        x = np.random.default_rng(0).integers(0, 255, size=kb * 1024, dtype=np.uint8)
        rec[f"h2d_{kb}kb_first_ms"] = p50_ms(lambda: upload(x), 1)[0]
        p50, _ = p50_ms(lambda: upload(x), iters)
        rec[f"h2d_{kb}kb_p50_ms"] = p50
        rec[f"h2d_{kb}kb_mbps"] = round(kb / 1024 / (p50 / 1e3), 1)
    x = np.random.default_rng(1).integers(0, 255, size=671 * 1024, dtype=np.uint8)

    def pair():
        _stage(x, dev)
        _stage(x, dev)
        sync()

    rec["h2d_2x671kb_p50_ms"] = p50_ms(pair, iters)[0]
    rec["device"] = device_name(dev)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, args.iters)))


if __name__ == "__main__":
    main()
