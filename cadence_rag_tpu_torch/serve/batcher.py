"""Async micro-batcher for /retrieve.

Counterpart of ``cadence_rag_tpu/serve/batcher.py``.

Concurrent requests arriving within ``retrieve_batch_window_ms`` coalesce
into one ``retrieve_evidence_batch`` call (one device dispatch per planner
group). Batching is the throughput lever — the reference serves one query
per request (app/retrieve.py:427); this layer turns concurrent requests
into device-batched execution (SURVEY.md §2.4).
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ..config import settings
from ..logging_utils import get_logger
from ..schemas import RetrieveRequest
from ..utils import events

logger = get_logger(__name__)

# ONE engine thread for every batch's host work and device interaction.
# On a card it enqueues on the device's current stream, which is the
# default stream in every thread that sets none; ``collect_packed`` waits
# on the event recorded there behind the dispatch's D2H copy, and each
# dispatch copies into a pinned buffer of its own.
# Overlap between batches comes from the two-phase engine API (dispatch
# enqueues without blocking; finish blocks on device output), NOT from
# concurrent threads, which would contend for the interpreter lock.
_ENGINE = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine")

_Pending = Tuple[RetrieveRequest, asyncio.Future, Optional[float]]


class RetrieveBatcher:
    # max_batch 128, the JAX package's: the scan streams the same HBM
    # bytes regardless of batch, so bigger batches amortize it, and K1
    # reads each row once for up to 256 queries.
    def __init__(self, window_ms: Optional[float] = None, max_batch: int = 128):
        self.window_s = (
            window_ms if window_ms is not None
            else float(settings.retrieve_batch_window_ms)
        ) / 1e3
        self.max_batch = max_batch
        # (request, its future, its arrival on the event ring's clock, or
        # None while the ring is off)
        self._pending: List[_Pending] = []
        self._flusher: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()
        # the collector's seconds (utils/events.gc_seconds) at the last batch
        self._gc_seen = events.gc_seconds()

    async def submit(self, payload: RetrieveRequest) -> Dict[str, Any]:
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        arrival = time.monotonic() if events.enabled() else None
        batch: Optional[List[_Pending]] = None
        async with self._lock:
            self._pending.append((payload, future, arrival))
            if len(self._pending) >= self.max_batch:
                batch, self._pending = self._pending, []
            elif self._flusher is None or self._flusher.done():
                self._flusher = asyncio.create_task(self._delayed_flush())
        if batch is not None:
            # shield: this coroutine runs inside ONE client's handler
            # task — if that client disconnects, aiohttp cancels the
            # task, and an unshielded dispatch would unwind without
            # resolving the other max_batch-1 waiters' futures (they
            # would hang forever)
            await asyncio.shield(self._dispatch(batch))
        return await future

    async def _delayed_flush(self) -> None:
        await asyncio.sleep(self.window_s)
        async with self._lock:
            batch, self._pending = self._pending, []
        await self._dispatch(batch)
        # Requests that arrived while THIS task was mid-dispatch saw a
        # not-done flusher and armed nothing — re-arm for them, else they
        # hang until an unrelated request lands (confirmed by repro).
        async with self._lock:
            if self._pending and (self._flusher is None
                                  or self._flusher.done()
                                  or self._flusher is asyncio.current_task()):
                self._flusher = asyncio.create_task(self._delayed_flush())

    def _record_batch(self, batch: List[_Pending]) -> None:
        """One ``batcher.batch`` event as the engine thread starts the
        batch: its size, the seconds its requests waited for that from
        their arrival (the window, then the engine thread behind the
        other batch), summed, and the collector's seconds since the last
        batch."""
        start = time.monotonic()
        gc_s = events.gc_seconds()
        events.record(
            "batcher.batch", size=len(batch),
            queue_s=round(sum(start - arrival for _, _, arrival in batch
                              if arrival is not None), 6),
            gc_s=round(gc_s - self._gc_seen, 6))
        self._gc_seen = gc_s

    async def _dispatch(self, batch: List[_Pending]) -> None:
        # The lock is NOT held here: requests arriving while this batch is
        # on device accumulate into the NEXT window batch instead of
        # serializing behind the dispatch (index locking is handled at the
        # engine layer, so overlapping dispatches are safe).
        if not batch:
            return
        payloads = [payload for payload, _, _ in batch]
        loop = asyncio.get_running_loop()

        def stage_dispatch():
            if events.enabled():
                self._record_batch(batch)
            from ..engine.retrieve import dispatch_evidence_batch

            return dispatch_evidence_batch(payloads)

        try:
            handle = await loop.run_in_executor(_ENGINE, stage_dispatch)
            # yielding between the phases lets the NEXT window's dispatch
            # enqueue on the engine thread while this batch computes

            def stage_finish():
                from ..engine.retrieve import finish_evidence_batch

                return finish_evidence_batch(handle)

            responses = await loop.run_in_executor(_ENGINE, stage_finish)
        except BaseException as exc:  # propagate to every waiter —
            # including CancelledError (BaseException since py3.8):
            # unwinding without resolving the futures strands every
            # other request in the batch. Cancellation is wrapped so the
            # OTHER waiters' handler tasks see a normal 500, not a
            # CancelledError that would silently drop their responses.
            fan = (
                exc if isinstance(exc, Exception)
                else RuntimeError("retrieve batch dispatch cancelled")
            )
            for _, future, _ in batch:
                if not future.done():
                    future.set_exception(fan)
            if not isinstance(exc, Exception):
                raise
            return
        for (_, future, _), response in zip(batch, responses):
            if not future.done():
                future.set_result(response)
        if len(batch) > 1:
            logger.info("retrieve.batched size=%s", len(batch))
