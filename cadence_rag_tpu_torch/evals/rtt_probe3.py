"""Does requesting the readback at dispatch hide the D2H copy behind the
device's work? A serial A/B of ``READBACK_PREFETCH_ENABLED``.

Counterpart of ``cadence_rag_tpu/evals/rtt_probe3.py``, which runs at import;
the sizes are flags here (``rtt_probe.add_size_flags``), at its sizes by
default. The batch goes through the index
(``DeviceIndexManager.query_both_packed_async`` -> ``collect_packed``, the
program over ``rtt_probe.PackedProbe``'s index: kernels K1 and K3 on the
card), and the setting decides where the pinned D2H copy is requested. Each
key is a p50 in ms over ``--iters``:

==============  =========================================  =====================================
key             JAX probe                                  here
==============  =========================================  =====================================
baseline        call, ``jax.device_get`` at collect        ``READBACK_PREFETCH_ENABLED=0``: the
                                                           copy requested at collect
cta_dispatch    ``copy_to_host_async()`` right after the   ``READBACK_PREFETCH_ENABLED=1``: the
                call, ``device_get`` at collect            copy enqueued behind the program at
                                                           dispatch
cta_sleep       as cta_dispatch, a 20 ms host sleep        the same
                before collect (the host preparing the
                next batch)
baseline_sleep  as baseline, with the sleep                the same
==============  =========================================  =====================================

Each round trip here also packs the batch and stages it
(``core/index._stage``), where the JAX probe dispatches a resident buffer:
the index takes numpy. The setting is restored on exit. The probe raises
unless the answers with it off and on are equal (``answers_equal``).

Usage:
  python -m cadence_rag_tpu_torch.evals.rtt_probe3 [--device cuda|cpu]
      [--rows 262144] [--artifact-rows 26214] [--batch 128] [--iters 20]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .rtt_probe import PackedProbe, add_size_flags, device_name, p50_ms

HOST_SLEEP_S = 0.020


def same_answers(a, b) -> bool:
    """Two collected answers (nested dicts and tuples of arrays) equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_answers(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_answers(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def run(device="cuda", rows: int = 262144, artifact_rows: int = 26214,
        batch: int = 128, iters: int = 20) -> Dict:
    from ..config import settings

    probe = PackedProbe(device, rows, artifact_rows, batch)
    index = probe.index
    kept = settings.readback_prefetch_enabled
    rec: Dict = {}

    def round_trip(prefetch: bool, sleep_s: float):
        settings.readback_prefetch_enabled = prefetch
        disp = probe.dispatch()
        if sleep_s:
            time.sleep(sleep_s)
        return index.collect_packed(disp)

    try:
        on = round_trip(True, 0.0)   # the first launch builds the kernels
        off = round_trip(False, 0.0)
        rec["answers_equal"] = same_answers(on, off)
        if not rec["answers_equal"]:
            raise RuntimeError("rtt_probe3: the answers with READBACK_PREFETCH_ENABLED "
                               "off differ from those with it on")
        for name, prefetch, sleep_s in (("baseline", False, 0.0),
                                        ("cta_dispatch", True, 0.0),
                                        ("cta_sleep", True, HOST_SLEEP_S),
                                        ("baseline_sleep", False, HOST_SLEEP_S)):
            rec[name] = p50_ms(lambda: round_trip(prefetch, sleep_s), iters)[0]
    finally:
        settings.readback_prefetch_enabled = kept
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
