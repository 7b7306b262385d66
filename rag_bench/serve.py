"""The program under test, set up for a cell and served over HTTP.

``Served`` starts the port on ``device`` the way a deployment does
(``serve/api.startup``, then the aiohttp app of ``serve/http.make_app``
on a localhost port, served from a thread), with the settings of the
cell's deployment and of its query embedder (``reference/embedders/``),
then loads the cell's data (``load.py``) and embeds the embedder's warm-up
texts. Around the program, and without changing it, it records:

- the engine's ``retrieve.<stage>`` spans and events from the program's
  event ring (``utils/events.py``), drained every half second so that the
  ring's 8,192 entries never wrap;
- the batcher's ``retrieve.batched size=N`` log records;
- each device dispatch's modes and query shapes (a wrapper around the
  index's ``query_both_packed_async``);
- each query's vector as the engine's embedder served it (a wrapper
  around the engine's ``embed_texts``);
- on a card, the card's own time for each dispatch's device program
  (CUDA events on its stream around the index's
  ``dual_corpus_retrieve_packed``).
"""

from __future__ import annotations

import asyncio
import gc
import logging
import socket
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import load
from .spec import Cell

RING_DRAIN_S = 0.5


class BatchSizes(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records: List[tuple] = []

    def emit(self, record):
        if record.msg.startswith("retrieve.batched"):
            self.records.append((time.monotonic(), int(record.args[0])))


class Ring:
    """Drains the program's event ring on a thread of its own."""

    def __init__(self):
        from cadence_rag_tpu_torch.utils import events

        self.events = events
        self.seen: List[Dict[str, Any]] = []
        # the most events one drain found: at the ring's size some were lost
        self.fullest = 0
        self._stop = threading.Event()
        events.enable()
        self._thread = threading.Thread(target=self._run, name="ring", daemon=True)
        self._thread.start()

    def _drain(self):
        got = self.events.drain()
        self.fullest = max(self.fullest, len(got))
        self.seen.extend(got)

    def _run(self):
        while not self._stop.wait(RING_DRAIN_S):
            self._drain()

    def stop(self) -> List[Dict[str, Any]]:
        self._stop.set()
        self._thread.join(10)
        self._drain()
        self.events.disable()
        return self.seen


class DispatchLog:
    """(time, modes, batch, dense on, tech width, nonzero tech columns) of
    every dispatch the engine makes."""

    def __init__(self, index):
        self.calls: List[Dict[str, Any]] = []
        inner = index.query_both_packed_async

        def recording(*args, **kw):
            q_tech = args[2]
            self.calls.append({
                "t": time.monotonic(), "chunk_mode": kw["chunk_mode"],
                "artifact_mode": kw["artifact_mode"], "batch": int(q_tech.shape[0]),
                "dense": args[0] is not None, "width": int(q_tech.shape[1]),
                "nonzero": int((q_tech != 0).sum())})
            return inner(*args, **kw)

        index.query_both_packed_async = recording


class EmbedLog:
    """Each text's vector as the engine's embedder served it, by the text.
    The engine calls ``embed_texts`` once a batch and, when that call fails,
    once a query; a query of the mix is unique, so its text is its key."""

    def __init__(self):
        from cadence_rag_tpu_torch.engine import retrieve

        self.vectors: Dict[str, np.ndarray] = {}
        self._engine = retrieve
        inner = self._inner = retrieve.embed_texts

        def recording(texts):
            out = inner(texts)
            # texts and rows paired as the engine pairs them
            self.vectors.update(zip(texts, out.vectors))
            return out

        retrieve.embed_texts = recording

    def remove(self) -> None:
        self._engine.embed_texts = self._inner


class CardClock:
    """A pair of CUDA timing events around each call of the index's device
    program (``ops/pack.dual_corpus_retrieve_packed``, as ``core/index``
    calls it), recorded on the stream that the program is enqueued on, with
    the call's host time and batch. The events time the program alone: the
    packed batch's upload is enqueued before the first and the readback
    after the second."""

    def __init__(self):
        from cadence_rag_tpu_torch.core import index

        self.calls: List[tuple] = []
        self._module = index
        inner = self._inner = index.dual_corpus_retrieve_packed

        def timed(*args, **statics):
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = inner(*args, **statics)
            end.record(stream)
            self.calls.append((time.monotonic(), int(statics["batch"]), start, end))
            return out

        index.dual_corpus_retrieve_packed = timed

    def remove(self) -> None:
        self._module.dual_corpus_retrieve_packed = self._inner

    def per_query_us(self, lo: float, hi: float) -> Optional[tuple]:
        """-> (card microseconds a query, programs, queries) over the
        programs enqueued between the host times ``lo`` and ``hi``, or None
        when there were none."""
        window = [c for c in self.calls if lo <= c[0] <= hi]
        queries = sum(c[1] for c in window)
        if not queries:
            return None
        torch.cuda.synchronize()
        card_ms = sum(start.elapsed_time(end) for _, _, start, end in window)
        return 1e3 * card_ms / queries, len(window), queries


class Served:
    """The port serving one cell's data on ``device``; ``close`` stops the
    server and frees the program's state."""

    def __init__(self, cell: Cell, seed: int, device: str, workdir: Path,
                 split: Dict[str, float]):
        from cadence_rag_tpu_torch.config import settings

        self.cell, self.seed = cell, seed
        self.settings = settings
        self.embedder = cell.embedder()
        self._saved = {}
        overrides = dict(cell.config["settings"])
        overrides.update(self.embedder.prepare(cell.config, seed, workdir, device))
        overrides.update(store_path=str(workdir / "store.db"),
                         ingest_root_dir=str(workdir / "ingest"),
                         store_sync_interval_s=0.0, log_level="WARNING",
                         profiler_port=0)
        for key, value in overrides.items():
            self._saved[key] = getattr(settings, key)
            setattr(settings, key, type(self._saved[key])(value))
        self._stop_server = None
        self.ring: Optional[Ring] = None
        self.embeds: Optional[EmbedLog] = None
        self.card: Optional[CardClock] = None
        self.sizes = BatchSizes()
        self._log = logging.getLogger("cadence_rag_tpu_torch.serve.batcher")
        try:
            self._start(device, split)
        except BaseException:
            self.close()
            raise

    def _lap(self, split, step, t0):
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        split[step] = split.get(step, 0.0) + time.monotonic() - t0
        return time.monotonic()

    def _start(self, device, split):
        from cadence_rag_tpu_torch.core import index as core_index
        from cadence_rag_tpu_torch.embed import embed_texts
        from cadence_rag_tpu_torch.ingest import featurize
        from cadence_rag_tpu_torch.ingest.sync import reset_syncer
        from cadence_rag_tpu_torch.serve.api import startup
        from cadence_rag_tpu_torch.store.db import get_store, reset_store

        cfg, seed = self.cell.config, self.seed
        self.device = torch.device(device)
        t = time.monotonic()
        reset_store()
        core_index.reset_index()
        reset_syncer()
        # an empty store and index: startup's rebuild reads nothing
        startup(device)
        self.index = core_index.get_index()
        t = self._lap(split, "startup", t)
        store_path = self.settings.store_path
        reset_store()
        load.write_store(store_path, cfg, seed, rows=bool(self.cell.own["store_rows"]))
        get_store()
        t = self._lap(split, "store rows", t)
        self.index.ensure_call_capacity(int(cfg["calls"]))
        load.install_corpus(self.index.chunks, cfg, "chunks", seed)
        load.install_corpus(self.index.artifacts, cfg, "artifacts", seed)
        t = self._lap(split, "corpus", t)
        if not featurize.native_available():
            raise RuntimeError("the port's native featurizer (native/lexhash.cpp) "
                               "did not build or load")
        warm = self.embedder.warm(cfg, self.cell.traffic)
        if warm:
            embed_texts(warm)
        t = self._lap(split, "embedder cache", t)
        self.dispatches = DispatchLog(self.index)
        self.embeds = EmbedLog()
        if self.device.type == "cuda":
            self.card = CardClock()
        self._log.addHandler(self.sizes)
        self._log.setLevel(logging.INFO)
        self._log.propagate = False
        self.port, self._stop_server = _start_app()
        self.ring = Ring()
        self._lap(split, "server", t)

    def close(self) -> None:
        from cadence_rag_tpu_torch.core import index as core_index
        from cadence_rag_tpu_torch.ingest.sync import reset_syncer
        from cadence_rag_tpu_torch.store.db import reset_store

        if self._stop_server is not None:
            self._stop_server()
            self._stop_server = None
        if self.ring is not None:
            self.ring.stop()
        if getattr(self, "index", None) is not None:
            # the dispatch wrapper and the index refer to each other
            self.index.__dict__.pop("query_both_packed_async", None)
        if self.embeds is not None:
            self.embeds.remove()
        if self.card is not None:
            self.card.remove()
        self._log.removeHandler(self.sizes)
        self._log.propagate = True
        reset_syncer()
        reset_store()
        core_index.reset_index()
        self.index = None
        for key, value in self._saved.items():
            setattr(self.settings, key, value)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def _start_app():
    """The port's aiohttp app on a free localhost port, served from a
    thread. -> (port, stop)"""
    from aiohttp import web

    from cadence_rag_tpu_torch.serve.http import make_app

    loop = asyncio.new_event_loop()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    runner = web.AppRunner(make_app(), access_log=None)
    ready = threading.Event()
    failed = []

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(runner.setup())
            loop.run_until_complete(web.SockSite(runner, sock, backlog=1024).start())
        except Exception as exc:  # handed to the caller below
            failed.append(exc)
            ready.set()
            return
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    thread = threading.Thread(target=run, name="serve", daemon=True)
    thread.start()
    if not ready.wait(60) or failed:
        raise RuntimeError(f"the server did not start: {failed}")

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        sock.close()
        if thread.is_alive():
            raise RuntimeError("the server thread did not stop")

    return sock.getsockname()[1], stop
