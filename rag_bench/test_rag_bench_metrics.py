"""Each per-layer reader on recorded spans and a recorded trace, the trace
reader on a hand-made Chrome trace, and the import check by whole
top-level name."""

from __future__ import annotations

import sys
import types

import pytest

from rag_bench import peaks, run, trace
from rag_bench.spec import ROOT, load_cell

STAGES = {"plan": 0.010, "tech": 0.001, "featurize": 0.002, "embed": 0.020,
          "planner": 0.300, "enqueue": 0.015, "collect": 0.050, "store_rows": 0.200,
          "assemble": 0.004}


def _spans(batches):
    out = []
    for b in range(batches):
        for stage, s in STAGES.items():
            out.append({"t": 100.0 + b, "tag": f"retrieve.{stage}", "s": s, "batch": 128})
    out.append({"t": 101.5, "tag": "query.slow_batch", "s": 2.5})
    return out


def _read(name, ctx):
    return run.reader(ROOT, name)(ctx)


def test_span_readers(tiny_root):
    ctx = {"spans": _spans(4), "batch_sizes": [128, 128, 64, 128], "trace": None,
           "dispatches": [], "config": load_cell("cadence-1m.packs", tiny_root).config}
    host = sum(s for k, s in STAGES.items() if k != "collect") * 1e3
    assert _read("engine.host_ms", ctx) == pytest.approx(host)
    assert _read("planner.ms", ctx) == pytest.approx(300.0)
    assert _read("store.rows_ms", ctx) == pytest.approx(200.0)
    assert _read("index.collect_ms", ctx) == pytest.approx(50.0)
    assert _read("batcher.batch_size", ctx) == pytest.approx(112.0)
    empty = dict(ctx, spans=[], batch_sizes=[])
    for name in ("engine.host_ms", "planner.ms", "store.rows_ms", "index.collect_ms",
                 "batcher.batch_size", "k1_roofline", "k3_roofline",
                 "device.idle_share"):
        assert _read(name, empty) is None


def _dispatch(mode):
    return {"t": 0.0, "chunk_mode": mode, "artifact_mode": mode, "batch": 128,
            "dense": True, "width": 16, "nonzero": 160}


@pytest.mark.parametrize("mode", ["ann", "exact"])
def test_roofline_readers(mode, tiny_root):
    config = load_cell("cadence-1m.packs", tiny_root).config
    k1 = [{"name": "void fused_scan_kernel<128, bf16>(...)", "ts": 0.0, "dur": 6000.0,
           "grid": [1024, 1, 1]},
          {"name": "void fused_scan_kernel<128, bf16>(...)", "ts": 7000.0, "dur": 900.0,
           "grid": [128, 1, 1]}]
    k3 = [{"name": "void tech_topk_kernel<16>(...)", "ts": 8000.0, "dur": 600.0,
           "grid": [1024, 1, 1]}]
    ctx = {"spans": [], "batch_sizes": [], "config": config,
           "dispatches": [_dispatch(mode)],
           "trace": {"kernels": k1 + k3, "window_s": 1.0, "busy_s": 0.25}}
    dense = mode == "ann"
    least = (peaks.k1_least_s(1048576, 128, 1024, 4096, 2, dense)
             + peaks.k1_least_s(131072, 128, 1024, 4096, 2, dense))
    assert _read("k1_roofline", ctx) == pytest.approx(100 * least / 6.9e-3)
    least3 = peaks.k3_least_s(1048576, 16, 128, 16, 160, 50)
    assert _read("k3_roofline", ctx) == pytest.approx(100 * least3 / 0.6e-3)
    assert _read("device.idle_share", ctx) == pytest.approx(75.0)


def test_trace_reader_and_gap_names():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.MARK, "ts": 1000.0, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 1100.0, "dur": 200.0,
         "args": {"grid": [8, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 1250.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 1600.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 1900.0, "dur": 500.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1200.0, "dur": 50.0},
    ]
    # the mark at monotonic 50.0 s; the window ends at 50.002 s
    got = trace.read(events, 50.0, 50.002)
    assert got["window_s"] == pytest.approx(0.002)
    # a: 1100-1300 and b: 1250-1350 merge; copy 1600-1650; a 1900-2400
    assert got["busy_s"] == pytest.approx((250 + 50 + 500) * 1e-6)
    assert got["top"][0][0] == "a"
    assert got["top"][0][1] == pytest.approx(700e-6)
    assert [k["grid"] for k in got["kernels"]][0] == [8, 1, 1]
    spans = [{"t": 50.0006, "s": 0.0005, "tag": "retrieve.plan"}]
    named = trace.name_gaps(got["gaps"], spans)
    # the longest first: 2400-3000, then 1350-1600 (under the plan span),
    # 1650-1900, 1000-1100
    assert named == [["host outside the engine", pytest.approx(600e-6)],
                     ["host in retrieve.plan", pytest.approx(250e-6)],
                     ["host outside the engine", pytest.approx(250e-6)],
                     ["host outside the engine", pytest.approx(100e-6)]]


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("cadence_rag_tpu_torch", "cadence_rag_tpu_torchx", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.banned_modules() == [m for m in run.banned_modules()
                                    if m.split(".")[0] in run.BANNED]
    assert not {"cadence_rag_tpu_torch", "jaxtyping"} & set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "cadence_rag_tpu.core",
                        types.ModuleType("cadence_rag_tpu.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert {"cadence_rag_tpu.core", "jaxlib"} <= set(run.banned_modules())
