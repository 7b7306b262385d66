"""The port's serving path in its event ring (``utils/events.py``), on the
CPU.

- With the ring off, serving records nothing, reads no thread CPU clock,
  installs no garbage-collector hook and makes no CUDA event.
- With it on, the aiohttp app's micro-batches leave one ``http.request``
  a request, one ``batcher.batch`` a batch (sized as the batcher's
  ``retrieve.batched`` log records, which the benchmark reads), each
  ``timed`` span's ``cpu`` inside its wall time, and one ``index.dispatch``
  a dispatch with the fields the benchmark's ``DispatchLog`` takes from
  outside the index.
- A collection inside ``drain`` or ``record`` that records an event
  neither deadlocks nor loses one; the hook sums collections only while
  the ring is on.
- Each per-layer metric that reads these events gives its value on a
  hand-built window, and nothing on a program that records none of them.
- A call of the Qwen3 provider with the ring on records one
  ``embed.encode`` whose sizes are the tokenized batch's; the encoder's
  three metrics read such events.
"""

import asyncio
import json
import gc
import logging
import sys
import threading
import time

import pytest
import torch

from cadence_rag_tpu_torch.utils import events
from rag_bench import run
from rag_bench.serve import BatchSizes, DispatchLog
from rag_bench.spec import ROOT
from torch_parity import PORT, port_store  # noqa: F401  (fixture)

TEXTS = [
    ["the ECONNRESET storm started after the object store upgrade",
     "rolling back to v2.3.1 stopped the resets immediately"],
    ["kafka consumer lag on broker-7 after the rebalance",
     "we will rebalance partitions before the freeze"],
    ["the azure landing zone needs private endpoints",
     "tiering to SSD fixed the latency spike on the ingest path"],
]
ROUNDS = (4, 1, 5, 3)


def _transcript(texts, external_id):
    return {
        "call_ref": {"external_id": external_id},
        "transcript": {"format": "json_turns", "content": [
            {"speaker": "Ana", "start_ts_ms": i * 4000, "end_ts_ms": i * 4000 + 3500,
             "text": t} for i, t in enumerate(texts)]},
        "options": {"target_tokens": 25, "max_tokens": 50, "overlap_tokens": 4},
    }


@pytest.fixture()
def served(port_store, monkeypatch):  # noqa: F811
    """The port started on the CPU with three calls and an artifact, its
    micro-batcher on;
    the ring off again afterwards."""
    from cadence_rag_tpu_torch.serve.testing import TestClient

    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.0)
    client = TestClient(device="cpu")
    for i, texts in enumerate(TEXTS):
        resp = client.post("/ingest/transcript", json=_transcript(texts, f"trace-{i}"))
        assert resp.status_code == 200, resp.json()
    # artifacts too: with either corpus empty a dispatch takes the
    # cold-start path, which records no index.dispatch
    resp = client.post("/ingest/analysis", json={
        "call_ref": {"call_id": resp.json()["call_id"]},
        "artifacts": [{"kind": "action_items",
                       "content": "- pin client to v2.3.1\n- add retry budget\n"}]})
    assert resp.status_code == 200, resp.json()
    monkeypatch.setattr(PORT.settings, "retrieve_batch_window_ms", 20)
    yield PORT.index.get_index()
    events.disable()


def _serve(rounds=ROUNDS, collect_between=False):
    """Rounds of concurrent distinct /retrieve requests through the aiohttp
    app -> each request's wall seconds on the client."""
    from aiohttp.test_utils import TestClient as AioClient, TestServer

    from cadence_rag_tpu_torch.serve.http import make_app

    async def scenario():
        walls = []
        async with AioClient(TestServer(make_app())) as client:
            async def one(i):
                t0 = time.perf_counter()
                r = await client.post("/retrieve", json={
                    "query": f"ECONNRESET kafka lag azure {i}",
                    "return_style": "ids_only"})
                assert r.status == 200, await r.text()
                await r.json()
                walls.append(time.perf_counter() - t0)

            n = 0
            for size in rounds:
                await asyncio.gather(*(one(n + i) for i in range(size)))
                n += size
                if collect_between:
                    gc.collect()
        return walls

    return asyncio.run(scenario())


def test_with_the_ring_off_serving_records_nothing(served, monkeypatch):
    calls = {"thread_time": 0, "cuda_event": 0}
    thread_time = time.thread_time

    def counted_thread_time():
        calls["thread_time"] += 1
        return thread_time()

    def counted_event(*a, **kw):
        calls["cuda_event"] += 1
        raise AssertionError("a CUDA event made with the ring off")

    monkeypatch.setattr(time, "thread_time", counted_thread_time)
    monkeypatch.setattr(torch.cuda, "Event", counted_event)
    events.disable()
    assert len(_serve()) == sum(ROUNDS)
    assert events.drain() == []
    assert calls == {"thread_time": 0, "cuda_event": 0}
    assert events._on_gc not in gc.callbacks


def test_with_the_ring_on_each_layer_records_its_events(served):
    log = logging.getLogger("cadence_rag_tpu_torch.serve.batcher")
    level = log.level
    sizes = BatchSizes()
    log.addHandler(sizes)
    log.setLevel(logging.INFO)
    dispatches = DispatchLog(served)
    events.enable()
    try:
        assert events._on_gc in gc.callbacks
        walls = _serve(collect_between=True)
        got = events.drain()
    finally:
        events.disable()
        served.__dict__.pop("query_both_packed_async", None)
        log.removeHandler(sizes)
        log.setLevel(level)
    assert events._on_gc not in gc.callbacks
    by_tag = {}
    for ev in got:
        by_tag.setdefault(ev["tag"], []).append(ev)

    requests = by_tag["http.request"]
    assert len(requests) == sum(ROUNDS)
    assert all(0 < ev["parse_s"] < max(walls) and 0 < ev["respond_s"] < max(walls)
               for ev in requests)

    batches = by_tag["batcher.batch"]
    assert sum(ev["size"] for ev in batches) == sum(ROUNDS)
    # the batcher logs no record for a batch of one
    assert [ev["size"] for ev in batches if ev["size"] > 1] == [
        n for _, n in sizes.records]
    assert all(0 < ev["queue_s"] <= ev["size"] * max(walls) for ev in batches)
    # a collection on the client's thread between rounds: seen by the next
    # batch
    assert all(ev["gc_s"] >= 0 for ev in batches)
    assert sum(ev["gc_s"] > 0 for ev in batches[1:]) >= len(ROUNDS) - 1

    spans = [ev for ev in got if "s" in ev]
    assert {ev["tag"] for ev in spans} >= {"retrieve.plan", "retrieve.collect"}
    assert all(0 <= ev["cpu"] <= ev["s"] + 2e-6 for ev in spans)

    recorded = by_tag["index.dispatch"]
    assert len(recorded) == len(dispatches.calls) == len(batches)
    keys = ("batch", "chunk_mode", "artifact_mode", "dense", "width", "nonzero")
    for ev, call in zip(recorded, dispatches.calls):
        assert {k: ev[k] for k in keys} == {k: call[k] for k in keys}
        # no card here: no device time, and no kernel to count its pieces
        assert ev["wait_s"] >= 0 and "device_s" not in ev and "lex_pieces" not in ev


def test_timed_spans_carry_cpu_time_to_the_microsecond():
    events.enable()
    try:
        with events.timed("test.sleep"):
            time.sleep(0.05)
        with events.timed("test.spin"):
            end = time.thread_time() + 0.02
            while time.thread_time() < end:
                pass
        events.record("test.short", 0.0012345678)
        sleep, spin, short = events.drain()
    finally:
        events.disable()
    assert sleep["s"] >= 0.05 and sleep["cpu"] < 0.02
    assert spin["cpu"] >= 0.02 and spin["cpu"] <= spin["s"] + 2e-6
    assert short["s"] == 0.001235


def test_the_gc_hook_sums_collections_only_while_the_ring_is_on():
    events.disable()
    assert events._on_gc not in gc.callbacks
    before = events.gc_seconds()
    gc.collect()
    assert events.gc_seconds() == before
    events.enable()
    try:
        assert gc.callbacks.count(events._on_gc) == 1
        gc.collect()
        during = events.gc_seconds()
        assert during > before
        assert events.drain() == []         # the hook records no event
    finally:
        events.disable()
    assert events._on_gc not in gc.callbacks
    gc.collect()
    assert events.gc_seconds() == during


def _collecting_at_every_line(codes):
    """A trace function that runs a (young generation's) collection at every
    line of the functions whose code objects are ``codes``."""
    def local(frame, event, arg):
        if event == "line":
            gc.collect(0)
        return local

    def tracer(frame, event, arg):
        return local if frame.f_code in codes else None

    return tracer


def test_a_collection_inside_drain_or_record_neither_deadlocks_nor_loses_events():
    seen = []

    def recording_hook(phase, info):
        # a bounded number, or a drain that collects at every line would
        # never empty the ring
        if phase == "stop" and len(seen) < 50:
            seen.append(1)
            events.record("test.in_gc")

    out = {}

    def body():
        for i in range(3):
            events.record("test.before", i=i)
        sys.settrace(_collecting_at_every_line(
            {events.record.__code__, events.drain.__code__}))
        try:
            events.record("test.traced")
            out["first"] = events.drain()
        finally:
            sys.settrace(None)

    events.enable()
    gc.callbacks.append(recording_hook)
    try:
        worker = threading.Thread(target=body, daemon=True)
        worker.start()
        worker.join(20)
        assert not worker.is_alive(), "deadlocked"
    finally:
        gc.callbacks.remove(recording_hook)
    rest = events.drain()
    events.disable()
    tags = [ev["tag"] for ev in out["first"] + rest]
    assert tags.count("test.before") == 3 and tags.count("test.traced") == 1
    assert tags.count("test.in_gc") == len(seen) > 1


# -- the per-layer metrics that read them ---------------------------------------
def _window():
    """Two batches of a program that records every new event, and a 1 ms
    traced window starting at 100 s with two kernels."""
    spans = []
    for t in (100.0006, 101.0):
        spans += [{"t": t, "tag": "retrieve.plan", "s": 0.0002, "cpu": 0.0001,
                   "batch": 2},
                  {"t": t + 0.0001, "tag": "retrieve.embed", "s": 0.0002,
                   "cpu": 0.0002, "batch": 2},
                  {"t": t + 0.0005, "tag": "retrieve.collect", "s": 0.0002,
                   "cpu": 0.00001, "batch": 2}]
    spans += [{"t": 100.5 + i, "tag": "http.request", "parse_s": 0.001,
               "respond_s": 0.002} for i in range(3)]
    spans += [{"t": 100.0, "tag": "batcher.batch", "size": 2, "queue_s": 0.006,
               "gc_s": 0.003},
              {"t": 101.0, "tag": "batcher.batch", "size": 1, "queue_s": 0.004,
               "gc_s": 0.001}]
    spans += [{"t": 100.0008, "tag": "index.dispatch", "device_s": 0.030,
               "wait_s": 0.020, "batch": 2, "lex_pieces": 1.25, "lex_route": "fp16"},
              {"t": 101.0008, "tag": "index.dispatch", "device_s": 0.040,
               "wait_s": 0.010, "batch": 1, "lex_pieces": 1.0, "lex_route": "fp16"}]
    # kernels at 0.0-0.1 and 0.2-0.4 ms into the window; the engine's spans
    # at 0.4-0.6, 0.5-0.7 and 0.9-1.1 ms (clipped at 1.0): 0.7 ms covered
    kernels = [{"name": "k", "ts": 100e6, "dur": 100.0},
               {"name": "k", "ts": 100e6 + 200.0, "dur": 200.0}]
    trace = {"lo_us": 100e6, "hi_us": 100e6 + 1000.0, "window_s": 0.001,
             "busy_s": 0.0003, "kernels": kernels}
    return {"spans": spans, "trace": trace, "batch_sizes": [], "dispatches": [],
            "latency_ms": [], "config": {}}


@pytest.mark.parametrize("name, want", [
    ("http.host_ms", 1e3 * 3 * 0.003 / 2),
    ("batcher.queue_ms", 1e3 * 0.010 / 3),
    ("engine.offcpu_ms", 1e3 * 2 * 0.0001 / 2),
    ("gc.pause_ms", 1e3 * 0.004 / 2),
    ("index.device_ms", 35.0),
    ("index.wait_ms", 15.0),
    ("device.idle_waiting_share", 30.0),
    ("k1.lex_pieces", 1.125),
])
def test_the_new_metric_readers(name, want):
    read = run.reader(ROOT, name)
    ctx = _window()
    assert read(ctx) == pytest.approx(want)
    # the program before these events: its engine spans without cpu, no
    # trace
    parent = [{k: v for k, v in ev.items() if k != "cpu"} for ev in ctx["spans"]
              if ev["tag"].startswith("retrieve.")]
    assert read(dict(ctx, spans=parent, trace=None)) is None
    assert read(dict(ctx, spans=[])) is None
    if name.startswith("device."):
        # a trace with no kernel: the CPU's
        assert read(dict(ctx, trace=dict(ctx["trace"], kernels=[]))) is None


# -- the query encoder's event and its metrics ------------------------------------
def test_a_qwen3_provider_call_records_one_embed_encode(port_store, monkeypatch):  # noqa: F811
    import numpy as np

    from cadence_rag_tpu_torch.models import prng
    from cadence_rag_tpu_torch.models import qwen3 as q3

    tiny = q3.PRESETS["tiny"]
    monkeypatch.setattr(PORT.settings, "embeddings_dim", tiny.embed_dim)
    provider = q3.Qwen3EmbeddingProvider(tiny)
    provider.model = q3.init_params(tiny, prng.PRNGKey(2), "cpu")
    texts = ["alpha beta", "gamma", "delta epsilon zeta eta", "the ECONNRESET storm"]
    events.disable()
    provider.embed(texts)
    events.enable()
    try:
        assert events.drain() == []
        provider.embed(texts)
        (ev,) = [e for e in events.drain() if e["tag"] == "embed.encode"]
    finally:
        events.disable()
    ids = provider.tokenize(texts)
    lengths = np.array([len(t.split()) for t in texts])
    assert (ev["batch"], ev["seq"]) == ids.shape == (4, 16)
    assert ev["tokens"] == int((ids != 0).sum()) == lengths.sum() == 10
    assert ev["positions"] == 4 * 16
    assert ev["pairs"] == int((lengths * (lengths + 1) // 2).sum()) == 3 + 1 + 10 + 6
    assert 0 <= ev["tokenize_s"] <= ev["host_s"]
    assert "device_s" not in ev          # the CPU has no card clock


def _encoder_window():
    """Two encoder batches: 2 x 16 positions holding 12 tokens and 30
    pairs in 4 ms of card time, 1 x 16 holding 5 and 15 in 6 ms."""
    spans = [{"t": 100.0, "tag": "embed.encode", "batch": 2, "seq": 16, "tokens": 12,
              "positions": 32, "pairs": 30, "tokenize_s": 0.0001, "host_s": 0.005,
              "device_s": 0.004},
             {"t": 101.0, "tag": "embed.encode", "batch": 1, "seq": 16, "tokens": 5,
              "positions": 16, "pairs": 15, "tokenize_s": 0.0001, "host_s": 0.007,
              "device_s": 0.006}]
    config = json.loads((ROOT / "rag_bench" / "configs" / "cadence-1m-qwen3.json")
                        .read_text())
    return dict(_window(), spans=_window()["spans"] + spans, config=config)


@pytest.mark.parametrize("name, want", [
    ("encoder.device_ms", 5.0),
    ("encoder.mfu", 100.0 * (17 * 7_266_631_680 + 36 * 4 * 32 * 128 * 45)
     / (0.010 * 989e12)),
    ("encoder.pad_share", 100.0 * (1 - 17 / 48)),
])
def test_the_encoder_metric_readers(name, want):
    read = run.reader(ROOT, name)
    ctx = _encoder_window()
    assert read(ctx) == pytest.approx(want)
    # the program before the event, and a window with no encoder batch
    assert read(_window()) is None
    assert read(dict(ctx, spans=[])) is None
    if name != "encoder.pad_share":
        # the CPU's events: no card clock
        cpu = [{k: v for k, v in ev.items() if k != "device_s"} for ev in ctx["spans"]]
        assert read(dict(ctx, spans=cpu)) is None
