"""Why a fresh packed-buffer upload costs more inside a round trip than a
bare upload of the same bytes: fresh, reused and resident buffers, numpy
handed to the index, and a blocking against a non-blocking upload.

Counterpart of ``cadence_rag_tpu/evals/h2d_probe2.py``, which runs at
import; the sizes are flags here (``rtt_probe.add_size_flags``), at its
sizes by default, over ``rtt_probe.PackedProbe``'s index, batch and packed
program (kernels K1 and K3 on the card). Each key is a p50 in ms over
``--iters`` round trips, each ending in the pinned readback:

==============  ====================================  ==========================================
key             JAX probe                             here
==============  ====================================  ==========================================
resident        input already on the device           the same
fresh_asarray   a NEW numpy buffer each iteration,    a new buffer (``ops/pack.pack_queries``)
                ``jnp.asarray``, call                 each iteration, ``core/index._stage``,
                                                      the upload waited for, then the call
reused_asarray  the SAME numpy buffer each            the same buffer, one byte flipped each
                iteration (mutated), ``asarray``      iteration, ``_stage`` waited for, call
numpy_direct    a new numpy buffer straight into      the numpy batch handed to the index:
                the jitted program                    ``query_both_packed_async`` packs, stages
                                                      and dispatches, ``collect_packed``
device_put_nb   a new buffer by ``jax.device_put``    a new buffer by ``_stage`` with no wait:
                without a block, call                 the upload queued ahead of the program,
                                                      as ``/retrieve`` stages
==============  ====================================  ==========================================

``_stage`` is the port's one upload path: the pinned host copy comes from
PyTorch's caching host allocator (reused after the first upload of a size)
and the H2D over PCIe is non-blocking; torch's other way, a pageable copy,
is not what the port serves with and is not measured. ``fresh_asarray`` and
``device_put_nb`` differ only in the wait between the upload and the call.
``fresh_asarray_first_ms`` is the first of its iterations.

Usage:
  python -m cadence_rag_tpu_torch.evals.h2d_probe2 [--device cuda|cpu]
      [--rows 262144] [--artifact-rows 26214] [--batch 128] [--iters 20]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

from .rtt_probe import PackedProbe, add_size_flags, device_name, p50_ms


def run(device="cuda", rows: int = 262144, artifact_rows: int = 26214,
        batch: int = 128, iters: int = 20) -> Dict:
    probe = PackedProbe(device, rows, artifact_rows, batch)
    packed0 = probe.packed()
    d_res = probe.stage(packed0)
    probe.sync()
    probe.fetch(probe.call(d_res))   # the first launch builds the kernels
    probe.index_round_trip()         # and the index's path
    rec: Dict = {}

    def staged_and_waited(packed):
        staged = probe.stage(packed)
        probe.sync()
        return staged

    rec["resident"] = p50_ms(lambda: probe.fetch(probe.call(d_res)), iters)[0]
    rec["fresh_asarray"], rec["fresh_asarray_first_ms"] = p50_ms(
        lambda: probe.fetch(probe.call(staged_and_waited(probe.packed()))), iters)
    reuse_buf = probe.packed()

    def reused():
        reuse_buf[0] ^= 1   # new content each upload
        probe.fetch(probe.call(staged_and_waited(reuse_buf)))

    rec["reused_asarray"] = p50_ms(reused, iters)[0]
    rec["numpy_direct"] = p50_ms(probe.index_round_trip, iters)[0]
    rec["device_put_nb"] = p50_ms(
        lambda: probe.fetch(probe.call(probe.stage(probe.packed()))), iters)[0]
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
