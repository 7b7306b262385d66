"""One batch's dispatch -> collect round trip, with the packed query buffer
staged three ways.

Counterpart of ``cadence_rag_tpu/evals/rtt_probe.py``, which runs at import
with its sizes fixed; here they are flags, at its sizes by default. An
index of ``--rows`` chunks and ``--artifact-rows`` artifacts
(``evals/synth.install_synthetic_corpus``) and a batch of ``--batch``
seeded queries packed by ``ops/pack.pack_queries`` go through the index's
packed program (``ops/pack.dual_corpus_retrieve_packed``, chunks and
artifacts in ``ann`` with device RRF), which launches kernels K1 and K3 on
the card. Each variant times ``--iters`` round trips, each ending in the
readback of the flat output into pinned host memory, and reports the p50:

=================  =====================================  ==================================
key                JAX probe                              here
=================  =====================================  ==================================
prestaged_p50_ms   ``jnp.asarray(packed)`` in the loop    ``core/index._stage`` in the loop:
                                                          the pinned host copy and the
                                                          non-blocking H2D ``/retrieve``
                                                          makes
numpy_direct       numpy handed to the jitted program     numpy handed to the index:
_p50_ms                                                   ``query_both_packed_async`` packs,
                                                          stages and dispatches, and
                                                          ``collect_packed`` reads back
                                                          (torch programs take no numpy;
                                                          the index is what does)
resident_p50_ms    staged once, outside the loop          staged once, outside the loop
=================  =====================================  ==================================

The host link is PCIe; the readback is the pinned D2H copy
``collect_packed`` waits for, requested when the output is fetched
(``READBACK_PREFETCH_ENABLED=0``'s readback, on a stream that waits for
this program only). The other probes of the host link
(``rtt_probe2``, ``rtt_probe3``, ``h2d_probe2``, ``cta_ab``) build on the
``PackedProbe`` here.

Usage:
  python -m cadence_rag_tpu_torch.evals.rtt_probe [--device cuda|cpu]
      [--rows 262144] [--artifact-rows 26214] [--batch 128] [--iters 20]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

N_CALLS = 1024
CHUNK_KS = (50, 50, 50)
ARTIFACT_KS = (10, 10, 50)


def add_size_flags(parser: argparse.ArgumentParser) -> None:
    """The sizes the JAX probes of the host link fix at import."""
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default; raises "
                             "without a card) or cpu")
    parser.add_argument("--rows", type=int, default=262144)
    parser.add_argument("--artifact-rows", type=int, default=26214)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--iters", type=int, default=20)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def p50_ms(fn: Callable[[], object], n: int) -> Tuple[float, float]:
    """Host ms of ``fn`` (which ends in a wait for the device) over ``n``
    calls -> (p50, the first call)."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        lat.append(time.perf_counter() - t0)
    return (round(float(np.percentile(lat, 50)) * 1e3, 3),
            round(lat[0] * 1e3, 3))


class PackedProbe:
    """The process-wide index at the probe's sizes, the JAX probes' seeded
    batch, and the packed program over it."""

    def __init__(self, device, rows: int, artifact_rows: int, batch: int):
        from ..config import settings
        from ..core.index import get_index, reset_index
        from ..device import resolve_device
        from .synth import install_synthetic_corpus

        self.device = resolve_device(device)
        settings.index_initial_capacity = 4096
        settings.prewarm_growth_enabled = False
        reset_index()
        self.index = index = get_index(self.device)
        index.ensure_call_capacity(N_CALLS)
        install_synthetic_corpus(index.chunks, rows, N_CALLS, seed=0)
        install_synthetic_corpus(index.artifacts, artifact_rows, N_CALLS, seed=1)
        self.batch = batch
        self.dim = index.chunks.dim
        self.q_feats = int(settings.query_lex_features)
        self.tech_q = int(settings.tech_hash_slots) * int(settings.tech_slot_capacity)
        rng = np.random.default_rng(1)
        self.q_emb = rng.standard_normal((batch, self.dim)).astype(np.float32)
        self.sparse = (
            rng.integers(0, index.chunks.lex_dim, (batch, self.q_feats)).astype(np.uint16),
            (rng.standard_normal((batch, self.q_feats)) * 0.05).astype(np.float16))
        self.q_tech = rng.integers(1, 5000, size=(batch, self.tech_q)).astype(np.int32)
        self.allowed = np.ones((batch, N_CALLS), dtype=bool)
        self.date_min = np.full(batch, -2147483647, dtype=np.int32)
        self.date_max = np.full(batch, 2**31 - 1, dtype=np.int32)
        # the same batch as features, for the index API (signs of the
        # packed values, unit term frequencies)
        self.feats = [(self.sparse[0][i].astype(np.int64),
                       np.sign(self.sparse[1][i]).astype(np.float32),
                       np.ones(self.q_feats, np.float32)) for i in range(batch)]

    def packed(self) -> np.ndarray:
        """A fresh packed buffer of the batch (``ops/pack.pack_queries``)."""
        from ..ops.pack import pack_queries

        return pack_queries(self.q_emb, self.sparse, self.sparse, self.q_tech,
                            self.allowed, self.date_min, self.date_max)

    def stage(self, packed: np.ndarray) -> torch.Tensor:
        """The upload ``/retrieve`` makes (``core/index._stage``)."""
        from ..core.index import _stage

        return _stage(packed, self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, d_packed: torch.Tensor):
        """Enqueue the packed program -> (flat output, event after it)."""
        from ..ops.pack import dual_corpus_retrieve_packed

        flat = dual_corpus_retrieve_packed(
            self.index.chunks.device_arrays(), self.index.artifacts.device_arrays(),
            d_packed, batch=self.batch, emb_dim=self.dim, q_feats=self.q_feats,
            tech_q=self.tech_q, n_calls=N_CALLS, chunk_ks=CHUNK_KS,
            artifact_ks=ARTIFACT_KS, chunk_mode="ann", artifact_mode="ann",
            fuse_rrf=True)
        done = None
        if flat.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(flat.device))
        return flat, done

    def fetch(self, out) -> np.ndarray:
        """The output's readback, requested now and waited for."""
        from ..core.index import _read_back

        flat, done = out
        if flat.is_cuda:
            flat = _read_back([flat], done)[0]
        return flat.numpy()

    def dispatch(self, fuse_rrf: bool = True):
        """The batch handed to the index as numpy (``query_both_packed_async``)."""
        return self.index.query_both_packed_async(
            self.q_emb, self.feats, self.q_tech, self.allowed, self.date_min,
            self.date_max, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS,
            chunk_mode="ann", artifact_mode="ann", recall_target=0.95,
            fuse_rrf=fuse_rrf)

    def index_round_trip(self) -> Tuple[Dict, Dict]:
        return self.index.collect_packed(self.dispatch())


def run(device="cuda", rows: int = 262144, artifact_rows: int = 26214,
        batch: int = 128, iters: int = 20) -> Dict:
    probe = PackedProbe(device, rows, artifact_rows, batch)
    packed = probe.packed()
    # warm both paths (the first launch builds the kernels)
    probe.fetch(probe.call(probe.stage(packed)))
    probe.index_round_trip()
    rec: Dict = {}
    for name, fn in (
            ("prestaged", lambda: probe.fetch(probe.call(probe.stage(packed)))),
            ("numpy_direct", probe.index_round_trip)):
        rec[name + "_p50_ms"] = p50_ms(fn, iters)[0]
    # staged outside the timed loop (a pipelined server)
    resident = probe.stage(packed)
    probe.sync()
    rec["resident_p50_ms"] = p50_ms(lambda: probe.fetch(probe.call(resident)), iters)[0]
    rec["device"] = device_name(probe.device)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    add_size_flags(parser)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.device, args.rows, args.artifact_rows, args.batch,
                         args.iters)))


if __name__ == "__main__":
    main()
