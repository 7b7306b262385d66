"""The event ring's clock against the card's, on a CUDA card.

- A ``timed`` span around a kernel and a synchronize brackets that kernel
  in the benchmark's device trace (``rag_bench/trace.py``, whose mark ties
  the trace's clock to ``time.monotonic()``), within 0.2 ms at each end.
- An ``index.dispatch`` event's ``device_s`` (CUDA events from before the
  packed batch's upload to its readback) agrees within 10%, the median of
  three dispatches, with the time the trace gives that dispatch: from the
  host call that records its start event, on an idle stream, to the later
  of its last device operation's end and the host call that records its
  ``done`` event.

Needs a card, so every test here carries the ``cuda`` marker and skips
without one. The machine with the card has no jax, which tests/conftest.py
imports, so run them there with:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py -q -s
"""

import json
import time

import pytest
import torch

pytestmark = pytest.mark.cuda

CLOCK_US = 200.0
DEVICE_RTOL = 0.10


@pytest.fixture()
def cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from cadence_rag_tpu_torch.config import settings
    from rag_bench import trace

    saved = {f.name: getattr(settings, f.name) for f in dataclasses.fields(settings)}
    settings.store_path = str(tmp_path / "store.db")
    trace.warm(True)
    yield torch.device("cuda")
    from cadence_rag_tpu_torch.core.index import reset_index
    from cadence_rag_tpu_torch.store.db import reset_store
    from cadence_rag_tpu_torch.utils import events

    events.disable()
    reset_store()
    reset_index()
    for name, value in saved.items():
        setattr(settings, name, value)


@pytest.mark.parametrize("cycles", [2_000_000, 100_000_000])
def test_a_span_brackets_its_kernel_on_the_trace_clock(cuda, tmp_path, cycles):
    """About 1 ms and 50 ms of spinning: over the longer one a clock that
    ran 1% off the ring's would put the kernel 0.5 ms outside the span."""
    from cadence_rag_tpu_torch.utils import events
    from rag_bench import trace

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    events.enable()
    prof = trace.Profile(True)
    time.sleep(0.01)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with events.timed("test.sleep"):
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        torch.cuda.synchronize()
    time.sleep(0.01)
    prof.stop()
    (span,) = [ev for ev in events.drain() if ev["tag"] == "test.sleep"]
    events.disable()
    got = prof.read(tmp_path)
    kernel = max(got["kernels"], key=lambda k: k["dur"])
    start, end = (span["t"] - span["s"]) * 1e6, span["t"] * 1e6
    lead, trail = kernel["ts"] - start, end - (kernel["ts"] + kernel["dur"])
    print("clock check:", json.dumps({
        "kernel_us": kernel["dur"], "span_us": span["s"] * 1e6,
        "kernel_after_span_start_us": lead, "span_end_after_kernel_us": trail,
        "cuda_events_us": 1e3 * e0.elapsed_time(e1),
        "card": torch.cuda.get_device_name(0)}))
    assert lead >= -CLOCK_US and trail >= -CLOCK_US
    assert kernel["dur"] <= span["s"] * 1e6 + 2 * CLOCK_US


def _end(e):
    return float(e["ts"]) + float(e.get("dur", 0.0))


def _dispatch_in_trace(prof, path):
    """A dispatch's time in the Chrome trace of a profile that holds one,
    microseconds, as its CUDA events measure it: a CUDA event is stamped
    when its stream reaches it, so from the end of the host call that
    records the start event (the stream is idle then) to the later of the
    last device operation's end and the end of the call that records the
    ``done`` event: the last record before the first synchronize that
    follows the last operation's launch; the start event's record is the
    last one made through the same call before the first operation's
    launch. -> (that time, the first device operation's start to the last
    one's end, the runtime calls from 1 ms before the start's record to the
    first launch)"""
    from rag_bench import trace

    prof._prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
    assert ops, "no device operation in the trace"
    runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"),
                     key=lambda e: float(e["ts"]))
    launches = {(e.get("args") or {}).get("correlation"): float(e["ts"]) for e in runtime}

    def launched(op):
        return launches.get((op.get("args") or {}).get("correlation"), float(op["ts"]))

    first = min(ops, key=lambda e: float(e["ts"]))
    last = max(ops, key=_end)
    records = [e for e in runtime if "EventRecord" in e["name"]]
    syncs = [float(e["ts"]) for e in runtime
             if "Synchronize" in e["name"] and float(e["ts"]) > launched(last)]
    until = syncs[0] if syncs else float("inf")
    done = [e for e in records if launched(last) < float(e["ts"]) < until][-1]
    start = [e for e in records if e["name"] == done["name"]
             and float(e["ts"]) < launched(first)][-1]
    t0 = _end(start)
    head = [(e["name"], round(float(e["ts"]) - t0, 1), e.get("dur")) for e in runtime
            if t0 - 1000.0 <= float(e["ts"]) <= launched(first)]
    sync = [e for e in runtime if "Synchronize" in e["name"] and float(e["ts"]) >= until]
    head.append({"ops": len(ops), "kernels": sum(e["cat"] == "kernel" for e in ops),
                 "last_op": [last["name"][:50], round(_end(last) - t0, 1)],
                 "done_record_end": round(_end(done) - t0, 1),
                 "sync_end": round(_end(sync[0]) - t0, 1) if sync else None,
                 "runtime_calls": len([e for e in runtime if float(e["ts"]) >= t0])})
    return max(_end(last), _end(done)) - t0, _end(last) - float(first["ts"]), head


def test_a_dispatch_device_time_agrees_with_the_trace(cuda, tmp_path, monkeypatch):
    """Three dispatches over 4M rows, each alone in a profile: the median
    of their relative gaps within DEVICE_RTOL. On the card's machine a CUDA
    event interval can read a millisecond or more over the trace's, so the
    dispatch is made long (~30 ms of K1) for that to stay a few percent."""
    import statistics

    from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu_torch.evals.fullstack_profile import _requests, _setup_index
    from cadence_rag_tpu_torch.utils import events
    from rag_bench import trace

    monkeypatch.setenv("BENCH_SKIP_PACK", "1")   # ids_only reads no store row
    _setup_index(4_194_304, 4096, cuda)
    for salt in (1, 2):                  # kernels built, buffers allocated
        retrieve_evidence_batch(_requests(128, salt=salt))
    gaps = []
    for salt in (3, 4, 5):
        torch.cuda.synchronize()
        events.enable()
        prof = trace.Profile(True)
        retrieve_evidence_batch(_requests(128, salt=salt))
        prof.stop()
        (dispatch,) = [ev for ev in events.drain() if ev["tag"] == "index.dispatch"]
        events.disable()
        traced_us, ops_us, head = _dispatch_in_trace(prof, tmp_path / f"{salt}.json")
        gaps.append(dispatch["device_s"] / (traced_us * 1e-6) - 1.0)
        print("dispatch check:", json.dumps({
            "device_s": dispatch["device_s"], "wait_s": dispatch["wait_s"],
            "trace_s": traced_us * 1e-6, "first_to_last_op_s": ops_us * 1e-6,
            "runtime_calls_to_the_first_launch": head[-8:],
            "batch": dispatch["batch"], "card": torch.cuda.get_device_name(0)}))
        assert dispatch["batch"] == 128
    assert abs(statistics.median(gaps)) <= DEVICE_RTOL, gaps
