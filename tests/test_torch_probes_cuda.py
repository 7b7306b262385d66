"""The readback setting and the lane probe on a CUDA card.

- ``READBACK_PREFETCH_ENABLED`` off and on give the same ids through the
  engine; with it off a dispatch holds the program's output on the card and
  no host copy until ``collect_packed`` reads it back, on its own stream,
  also behind later dispatches.
- ``evals/lane_probe`` at a small size: every variant's answer held to K1's
  and K3's (the probe raises otherwise), each kernel launched.

Needs a card, so every test here carries the ``cuda`` marker and skips
without one. The machine with the card has no jax, which tests/conftest.py
imports, so run them there with:

    python -m pytest --noconftest -m cuda tests/test_torch_probes_cuda.py -q
"""

import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from cadence_rag_tpu_torch.config import settings

    torch.backends.cuda.matmul.allow_tf32 = False
    saved = {f.name: getattr(settings, f.name) for f in dataclasses.fields(settings)}
    settings.store_path = str(tmp_path / "store.db")
    yield torch.device("cuda")
    from cadence_rag_tpu_torch.core.index import reset_index
    from cadence_rag_tpu_torch.store.db import reset_store

    reset_store()
    reset_index()
    for name, value in saved.items():
        setattr(settings, name, value)


def test_readback_prefetch_off_and_on_answer_alike(cuda):
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.evals.fullstack_profile import _requests, _setup_index
    from cadence_rag_tpu_torch.evals.rtt_probe import PackedProbe

    _index, workdir = _setup_index(20_000, 1024, cuda)
    reqs = _requests(16, salt=3)
    answers = {}
    for flag in (False, True, False):
        settings.readback_prefetch_enabled = flag
        answers.setdefault(flag, []).append(
            [r["retrieved_ids"] for r in retrieve_evidence_batch(reqs)])
    assert answers[False][0] == answers[True][0] == answers[False][1]
    assert any(answers[True][0])

    probe = PackedProbe(cuda, 8192, 2048, 8)
    settings.readback_prefetch_enabled = False
    first = probe.dispatch()
    later = probe.dispatch()
    assert first.flat_host is None and first.flat_out.is_cuda
    got_first = probe.index.collect_packed(first)
    assert first.flat_out is None and not first.flat_host.is_cuda
    got_later = probe.index.collect_packed(later)
    settings.readback_prefetch_enabled = True
    on = probe.dispatch()
    assert on.flat_out is None and on.flat_host.is_pinned()
    want = probe.index.collect_packed(on)
    for got in (got_first, got_later):
        for g, w in zip(got, want):
            for a, b in zip(g["__rrf__"], w["__rrf__"]):
                np.testing.assert_array_equal(a, b)
    shutil.rmtree(workdir, ignore_errors=True)


@pytest.mark.parametrize("probe", ["all", "plane"])
def test_lane_probe_holds_every_variant_on_the_card(cuda, probe):
    from cadence_rag_tpu_torch.evals import lane_probe
    from cadence_rag_tpu_torch.ops.fused_scan import fused_scan
    from cadence_rag_tpu_torch.ops.tech_keys import range_topk

    k1, k3 = fused_scan.launches, range_topk.launches
    rec = lane_probe.run(cuda, n=50_000, batch=32, iters=2, lex_dim=512, dim=128,
                         probe=probe)
    assert rec["checks_failed"] == []
    checked = [lane for lane in rec["lanes"] if lane.get("checks")]
    assert checked and all(c["ok"] for lane in checked for c in lane["checks"].values())
    assert fused_scan.launches > k1
    if probe == "all":
        assert range_topk.launches > k3
