"""HTTP API surface (counterpart of ``cadence_rag_tpu.serve``).

The reference serves 12 FastAPI endpoints plus middleware (reference:
app/main.py:43-186). FastAPI is not a dependency, so the API is a
transport-agnostic router (api.py) with two bindings: aiohttp for real
serving (http.py) and an in-process test client (testing.py) that plays the
role fastapi.testclient plays in the reference's tests.
"""

from .api import Router, build_router  # noqa: F401
