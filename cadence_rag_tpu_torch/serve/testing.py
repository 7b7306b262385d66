"""In-process test client over the router (the role fastapi.testclient
plays in the reference's integration tests, tests/conftest.py:126).

Counterpart of ``cadence_rag_tpu/serve/testing.py``; ``device`` is passed
to ``startup`` (the card unless the caller asks for the CPU)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from ..device import DeviceLike
from .api import Router, build_router, startup


@dataclasses.dataclass
class Response:
    status_code: int
    _payload: Any
    headers: Dict[str, str]

    def json(self) -> Any:
        return self._payload


class TestClient:
    __test__ = False  # not a pytest collectable

    def __init__(self, router: Optional[Router] = None, run_startup: bool = True,
                 device: DeviceLike = "cuda"):
        self.router = router or build_router()
        if run_startup:
            startup(device)

    def _query(self, path: str, params: Optional[Dict[str, Any]]) -> tuple:
        split = urlsplit(path)
        query: Dict[str, List[str]] = parse_qs(split.query)
        for key, value in (params or {}).items():
            if value is None:
                continue
            if isinstance(value, (list, tuple)):
                query[key] = [str(v) for v in value]
            else:
                query[key] = [str(value)]
        return split.path, query

    def request(
        self,
        method: str,
        path: str,
        *,
        json: Any = None,
        params: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Response:
        clean_path, query = self._query(path, params)
        status, payload, out_headers = self.router.dispatch(
            method, clean_path, query=query, body=json, headers=headers
        )
        return Response(status, payload, out_headers)

    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> Response:
        return self.request("POST", path, **kw)

    def delete(self, path: str, **kw) -> Response:
        return self.request("DELETE", path, **kw)
