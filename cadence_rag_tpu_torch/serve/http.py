"""aiohttp binding: real HTTP serving for the router.

Counterpart of ``cadence_rag_tpu/serve/http.py``. Run with:

    STORE_SYNC_INTERVAL_S=0 python -m cadence_rag_tpu_torch.serve.http \
        --host 0.0.0.0 --port 8080 [--device cuda|cpu]

``--device`` names where the index lives: ``cuda`` (the default) raises
without a card; ``cpu`` must be asked for.

Request bodies are parsed as JSON, responses serialized as JSON, and the
X-Request-ID middleware semantics of the reference are preserved by the
router itself (serve/api.py).
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import Any

from .api import build_router, startup


def _to_multidict(query) -> dict:
    out: dict = {}
    for key in query.keys():
        out[key] = query.getall(key)
    return out


def make_app():
    from aiohttp import web

    from ..config import settings
    from ..schemas import RetrieveRequest
    from .batcher import RetrieveBatcher

    router = build_router()
    batcher = (
        RetrieveBatcher() if int(settings.retrieve_batch_window_ms) > 0 else None
    )

    async def handle(request: "web.Request") -> "web.Response":
        body: Any = None
        if request.can_read_body:
            raw = await request.read()
            if raw:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    return web.json_response(
                        {"detail": "invalid JSON body"}, status=400
                    )

        # micro-batched /retrieve fast path. It bypasses Router.dispatch,
        # so it must reproduce the router's contract itself: request-ID
        # contextvar + response header, metrics observation under the
        # same family, and the JSON error mapping — otherwise the
        # hottest route records zero traffic in /metrics exactly in the
        # deployment mode built for throughput.
        if (
            batcher is not None
            and request.method == "POST"
            and request.path == "/retrieve"
        ):
            import time as _time
            import uuid as _uuid

            from ..logging_utils import (
                get_logger,
                reset_request_id,
                set_request_id,
            )
            from ..utils.errors import ApiError
            from .metrics import registry

            request_id = (
                request.headers.get("X-Request-ID") or _uuid.uuid4().hex
            )
            rid_headers = {"x-request-id": request_id}
            token = set_request_id(request_id)
            t0 = _time.perf_counter()
            status = 200
            try:
                try:
                    payload = RetrieveRequest.model_validate(body)
                except Exception as exc:
                    status = 422
                    return web.json_response(
                        {"detail": str(exc)}, status=422, headers=rid_headers
                    )
                try:
                    result = await batcher.submit(payload)
                except ApiError as exc:
                    status = exc.status
                    return web.json_response(
                        {"detail": exc.detail}, status=exc.status,
                        headers=rid_headers,
                    )
                except Exception:
                    get_logger(__name__).exception(
                        "request.failed method=POST path=/retrieve"
                    )
                    status = 500
                    return web.json_response(
                        {"detail": "internal error"}, status=500,
                        headers=rid_headers,
                    )
                return web.json_response(result, headers=rid_headers)
            finally:
                registry.observe(
                    "POST /retrieve", _time.perf_counter() - t0,
                    error=status >= 500,
                )
                reset_request_id(token)
        status, payload, headers = await asyncio.get_event_loop().run_in_executor(
            None,
            lambda: router.dispatch(
                request.method,
                request.path,
                query=_to_multidict(request.query),
                body=body,
                headers=dict(request.headers),
            ),
        )
        return web.json_response(payload, status=status, headers=headers)

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", handle)
    return app


def main() -> None:
    from aiohttp import web

    parser = argparse.ArgumentParser(
        description="cadence_rag_tpu_torch API server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default) or cpu")
    args = parser.parse_args()
    startup(args.device)
    web.run_app(make_app(), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
