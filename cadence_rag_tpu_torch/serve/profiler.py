"""On-demand trace capture over HTTP, in the serving process.

The port's form of the JAX package's profiler server
(``jax.profiler.start_server`` in ``cadence_rag_tpu/serve/api.py``, which a
remote TensorBoard asks for a capture): with ``PROFILER_PORT > 0``
``serve.api.startup`` starts ``start_server(port)``, a listener on that port
in a daemon thread of the server's process.

    GET /trace?ms=N

records ``torch.profiler`` for N milliseconds (default 1000, at most
60000) over every thread of the process, so whatever it is serving: CPU
operators and ``record_function`` regions (``retrieve.dispatch``), and on a
card its CUDA kernels. The answer is the Chrome trace JSON
(``chrome://tracing``, Perfetto). One capture at a time: a request while
another runs answers 409.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import torch

from ..logging_utils import get_logger

logger = get_logger(__name__)

DEFAULT_MS = 1000
MAX_MS = 60_000

_servers: Dict[int, ThreadingHTTPServer] = {}
_capturing = threading.Lock()


def capture(ms: int) -> bytes:
    """``torch.profiler`` over every thread of the process for ``ms``
    milliseconds (CUDA activities too where a card is visible) -> the
    Chrome trace JSON."""
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    stop = threading.Event()
    with torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True),
    ) as prof:
        stop.wait(ms / 1000.0)
    fd, path = tempfile.mkstemp(prefix="cadence_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, "rb") as fh:
            return fh.read()
    finally:
        os.unlink(path)


class _Handler(BaseHTTPRequestHandler):
    def _answer(self, status: int, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - the stdlib's name
        url = urlparse(self.path)
        if url.path != "/trace":
            self._answer(404, b'{"detail": "not found"}')
            return
        try:
            ms = int(parse_qs(url.query).get("ms", [DEFAULT_MS])[0])
        except ValueError:
            self._answer(422, b'{"detail": "ms must be an integer"}')
            return
        if not 0 < ms <= MAX_MS:
            self._answer(422, json.dumps(
                {"detail": f"ms must be in 1..{MAX_MS}"}).encode())
            return
        if not _capturing.acquire(blocking=False):
            self._answer(409, b'{"detail": "a capture is running"}')
            return
        try:
            trace = capture(ms)
        except Exception as exc:  # answered, and logged with its trace
            logger.exception("profiler.capture_failed ms=%s", ms)
            self._answer(500, json.dumps({"detail": str(exc)}).encode())
            return
        finally:
            _capturing.release()
        logger.info("profiler.trace ms=%s bytes=%s", ms, len(trace))
        self._answer(200, trace)

    def log_message(self, fmt, *args) -> None:  # the module's logger instead
        logger.debug("profiler.http " + fmt, *args)


def start_server(port: int, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Listen on ``port`` in a daemon thread (idempotent per port) -> the
    server; ``port`` 0 picks a free one (``server.server_port``). Call it
    from the thread that imported torch (the server's main thread): the
    profiler's tracer (kineto, and CUPTI on a card) initialises on the
    thread of its first capture and must do so on the thread where torch
    registered it, or later captures record no CUDA activity. A capture of
    1 ms here is that first one."""
    if port and port in _servers:
        return _servers[port]
    with _capturing:
        capture(1)
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    _servers[server.server_port] = server
    threading.Thread(target=server.serve_forever, daemon=True,
                     name=f"profiler-{server.server_port}").start()
    logger.info("api.profiler_server port=%s", server.server_port)
    return server


def stop_server(port: Optional[int] = None) -> None:
    """Stop the listener on ``port`` (every listener without one)."""
    for p in [port] if port is not None else list(_servers):
        server = _servers.pop(p, None)
        if server is not None:
            server.shutdown()
            server.server_close()
