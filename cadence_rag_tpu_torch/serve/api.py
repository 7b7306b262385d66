"""Transport-agnostic API router: the reference's endpoint surface.

Endpoint-for-endpoint parity with the reference API (reference:
app/main.py:63-186): /health, /diagnostics, /ingest/{transcript,call,
analysis}, /ingest/jobs[/{id}], /calls[/{id}], /chunks/{id}, /expand,
/retrieve — same request models, same response shapes, same status codes
(400 unsupported format / invalid status filter, 404 missing, 409
ambiguous, 422 validation). Adds GET /index/stats (device-index
observability; no reference counterpart).

Each request runs under an X-Request-ID logging context
(reference: app/main.py:46-60).

Counterpart of ``cadence_rag_tpu/serve/api.py``. Routes whose backing
module is not ported yet answer 404 and name the ROADMAP item that ports
it: ``/ingest/jobs*`` (the drop-folder queue) and ``DELETE /calls/{id}``
(deletes and compaction). ``startup`` takes the device the index lives on
and raises for each setting whose feature is not ported.
"""

from __future__ import annotations

import dataclasses
import re
import uuid
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional, Tuple

from pydantic import ValidationError

from ..config import settings
from ..core.index import get_index
from ..device import DeviceLike
from ..embed.provider import NOT_PORTED_PROVIDERS, provider_kind
from ..engine.browse import expand_evidence, get_call, get_chunk, list_calls
from ..engine.retrieve import RERANK_NOT_PORTED, retrieve_evidence
from ..ingest.featurize import VOCAB_NOT_PORTED
from ..ingest.ingest import ingest_analysis, ingest_call, ingest_transcript
from ..logging_utils import (
    configure_logging,
    get_logger,
    reset_request_id,
    set_request_id,
)
from ..schemas import (
    AnalysisIngestRequest,
    CallIngestRequest,
    ChunkingOptions,
    ExpandRequest,
    RetrieveRequest,
    TranscriptIngestRequest,
)
from ..store.db import get_store
from ..utils.errors import ApiError

logger = get_logger(__name__)


@dataclasses.dataclass
class Request:
    method: str
    path: str
    path_params: Dict[str, str]
    query: Dict[str, List[str]]
    body: Any
    headers: Dict[str, str]

    def q1(self, name: str, default: Optional[str] = None) -> Optional[str]:
        values = self.query.get(name)
        return values[0] if values else default


Handler = Callable[[Request], Tuple[int, Dict[str, Any]]]


class Router:
    def __init__(self) -> None:
        self.routes: List[Tuple[str, re.Pattern, Handler, str]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )
        self.routes.append(
            (method.upper(), regex, handler, f"{method.upper()} {pattern}")
        )

    def dispatch(
        self,
        method: str,
        path: str,
        *,
        query: Optional[Dict[str, List[str]]] = None,
        body: Any = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        import time as _time

        from .metrics import registry

        headers = {k.lower(): v for k, v in (headers or {}).items()}
        request_id = headers.get("x-request-id") or uuid.uuid4().hex
        token = set_request_id(request_id)
        try:
            for route_method, regex, handler, family in self.routes:
                if route_method != method.upper():
                    continue
                match = regex.match(path)
                if not match:
                    continue
                request = Request(
                    method=method.upper(),
                    path=path,
                    path_params=match.groupdict(),
                    query=query or {},
                    body=body,
                    headers=headers,
                )
                t0 = _time.perf_counter()
                try:
                    status, payload = handler(request)
                except ApiError as exc:
                    status, payload = exc.status, {"detail": exc.detail}
                except ValidationError as exc:
                    status, payload = 422, {"detail": exc.errors(include_url=False)}
                except Exception:
                    logger.exception(
                        "request.failed method=%s path=%s", method, path
                    )
                    status, payload = 500, {"detail": "internal error"}
                registry.observe(
                    family, _time.perf_counter() - t0, error=status >= 500
                )
                return status, payload, {"x-request-id": request_id}
            return 404, {"detail": "not found"}, {"x-request-id": request_id}
        finally:
            reset_request_id(token)


# ------------------------------------------------------------- handlers ----

def _parse_dt(raw: Optional[str]) -> Optional[datetime]:
    if not raw:
        return None
    try:
        return datetime.fromisoformat(raw)
    except ValueError as exc:
        raise ApiError(422, f"invalid datetime: {raw}") from exc


def health(_req: Request):
    try:
        info = get_store().fetch_info()
    except Exception as exc:
        raise ApiError(503, str(exc)) from exc
    return 200, {"status": "ok", "db": info}


def diagnostics(_req: Request):
    try:
        store = get_store()
        info = store.fetch_info()
        ok, message = store.validate_versions()
    except Exception as exc:
        return 200, {"status": "error", "detail": str(exc)}
    index = get_index()
    return 200, {
        "status": "ok" if ok else "mismatch",
        "detail": message,
        "db": info,
        "expected": {"schema_version": info.get("schema_version")},
        "index": {
            "device": str(index.device),
            "chunks": index.chunks.count,
            "artifact_chunks": index.artifacts.count,
            "chunk_capacity": index.chunks.capacity,
            "embedding_dtype": str(index.chunks.emb_dtype),
            "ivf": (
                {
                    "built_count": index.chunks.ivf.built_count,
                    "n_clusters": index.chunks.ivf.n_clusters,
                    "nprobe": index.chunks.ivf.nprobe,
                    "overflow_count": index.chunks.ivf.overflow_count,
                    "usable": index.chunks.ivf_usable(),
                }
                if index.chunks.ivf is not None else None
            ),
        },
    }


def ingest_transcript_endpoint(req: Request):
    payload = TranscriptIngestRequest.model_validate(req.body)
    if payload.transcript.format != "json_turns":
        raise ApiError(400, "unsupported transcript format")
    options = payload.options or ChunkingOptions()
    call_id, utterances_ingested, chunks_created = ingest_transcript(
        payload.call_ref, payload.transcript.content, options
    )
    return 200, {
        "call_id": call_id,
        "utterances_ingested": utterances_ingested,
        "chunks_created": chunks_created,
    }


def ingest_transcript_batch_endpoint(req: Request):
    """Batch ingest: a list of transcript requests in one call. The device
    index already inserts in slabs; this gives the HTTP surface the same
    batching (an addition — the reference ingests one transcript per
    request, app/main.py:92)."""
    body = req.body
    if not isinstance(body, list) or not body:
        raise ApiError(422, "expected a non-empty JSON array of "
                            "transcript ingest requests")
    payloads = [TranscriptIngestRequest.model_validate(item) for item in body]
    for payload in payloads:
        if payload.transcript.format != "json_turns":
            raise ApiError(400, "unsupported transcript format")
    # NON-atomic, per-item results: items succeed or fail independently
    # (transcript-hash idempotency makes retrying succeeded items a
    # no-op), and each failure is reported in place rather than aborting
    # the rest of the batch with no record of what landed.
    results = []
    failed = 0
    for payload in payloads:
        options = payload.options or ChunkingOptions()
        try:
            call_id, utterances_ingested, chunks_created = ingest_transcript(
                payload.call_ref, payload.transcript.content, options
            )
            results.append({
                "call_id": call_id,
                "utterances_ingested": utterances_ingested,
                "chunks_created": chunks_created,
            })
        except ApiError as exc:
            failed += 1
            results.append({"error": exc.detail, "status": exc.status})
        except Exception:
            # the endpoint's contract is per-item results: an unexpected
            # failure on item N must not abort items N+1.. with a bare
            # 500 and no record of what landed
            logger.exception("ingest.batch_item_failed")
            failed += 1
            results.append({"error": "internal error", "status": 500})
    return 200, {"items": results, "failed": failed}


def ingest_call_endpoint(req: Request):
    payload = CallIngestRequest.model_validate(req.body)
    call_id, created = ingest_call(payload.call_ref)
    return 200, {"call_id": call_id, "created": created}


def ingest_analysis_endpoint(req: Request):
    payload = AnalysisIngestRequest.model_validate(req.body)
    if not payload.artifacts:
        raise ApiError(400, "no artifacts provided")
    call_id, created = ingest_analysis(payload.call_ref, payload.artifacts)
    return 200, {"call_id": call_id, "artifacts_created": created}


def _parse_limit(req: Request, default: str = "50") -> int:
    try:
        limit = int(req.q1("limit", default))
    except ValueError as exc:
        # client input error, not a 500 (int('abc') raised out of the
        # handler and hit the generic 500 path + error metrics)
        raise ApiError(422, "limit must be an integer") from exc
    if not 1 <= limit <= 200:
        raise ApiError(422, "limit must be in [1, 200]")
    return limit


def _not_ported(what: str, item: str) -> Handler:
    """A route whose backing module the port does not have yet: 404,
    naming the ROADMAP item that ports it."""
    def handler(_req: Request):
        raise ApiError(404, f"not found: {what} is not ported yet "
                            f"(ROADMAP Queue 1 item {item})")
    return handler


def list_calls_endpoint(req: Request):
    return 200, list_calls(
        limit=_parse_limit(req),
        cursor=req.q1("cursor"),
        date_from=_parse_dt(req.q1("date_from")),
        date_to=_parse_dt(req.q1("date_to")),
        tags=req.query.get("tags"),
        external_id=req.q1("external_id"),
        external_source=req.q1("external_source"),
    )


def get_call_endpoint(req: Request):
    try:
        call_id = str(uuid.UUID(req.path_params["call_id"]))
    except ValueError as exc:
        raise ApiError(422, "invalid call id") from exc
    return 200, get_call(call_id)


def get_chunk_endpoint(req: Request):
    try:
        chunk_id = int(req.path_params["chunk_id"])
    except ValueError as exc:
        raise ApiError(422, "invalid chunk id") from exc
    return 200, get_chunk(chunk_id)


def expand_endpoint(req: Request):
    payload = ExpandRequest.model_validate(req.body)
    return 200, expand_evidence(
        payload.evidence_id,
        window_ms=payload.window_ms,
        max_chars=payload.max_chars,
    )


def retrieve_endpoint(req: Request):
    payload = RetrieveRequest.model_validate(req.body)
    return 200, retrieve_evidence(payload)


def retrieve_batch_endpoint(req: Request):
    """Beyond-reference: explicit client-side batching — a list of
    RetrieveRequests served in one device dispatch per planner group
    (the engine API bulk evals use; no reference counterpart)."""
    from ..engine.retrieve import retrieve_evidence_batch

    body = req.body
    if not isinstance(body, list) or not body:
        raise ApiError(400, "expected a non-empty JSON array of requests")
    if len(body) > 256:
        raise ApiError(422, "batch too large (max 256)")
    payloads = [RetrieveRequest.model_validate(item) for item in body]
    return 200, {"results": retrieve_evidence_batch(payloads)}


def index_stats_endpoint(_req: Request):
    index = get_index()

    def corpus_stats(corpus):
        return {
            "count": corpus.count,
            "capacity": corpus.capacity,
            "embedded": int(corpus.h_has_emb[: corpus.count].sum()),
            "avgdl": corpus.avgdl,
            "lexical_dim": corpus.lex_dim,
            "dim": corpus.dim,
            "emb_dtype": str(corpus.emb_dtype),
            "tombstones": corpus.tombstones,
            "ivf_built": corpus.ivf is not None,
        }

    return 200, {
        "device": str(index.device),
        "chunks": corpus_stats(index.chunks),
        "artifact_chunks": corpus_stats(index.artifacts),
        "call_capacity": index.call_capacity,
    }


def metrics_endpoint(_req: Request):
    from .metrics import registry

    return 200, registry.snapshot()


def _unported_settings() -> List[str]:
    """Why the current settings cannot be served by the port: one line
    per setting whose feature is not ported, naming its ROADMAP item."""
    problems = []
    if float(settings.store_sync_interval_s) > 0:
        problems.append(
            f"STORE_SYNC_INTERVAL_S={settings.store_sync_interval_s}: the "
            "store->index syncer (ingest/sync.py) is not ported yet (ROADMAP "
            "Queue 1 item 3); set STORE_SYNC_INTERVAL_S=0")
    if settings.rerank_enabled:
        problems.append(RERANK_NOT_PORTED)
    if provider_kind() in NOT_PORTED_PROVIDERS:
        problems.append(
            f"EMBEDDINGS_PROVIDER={provider_kind()!r}: the in-process "
            "embedders (models/*) are not ported yet (ROADMAP Queue 1 item 6)")
    if settings.dist_coordinator.strip() or settings.mesh_shape.strip():
        problems.append(
            "DIST_COORDINATOR / MESH_SHAPE: multi-device serving "
            "(parallel/*) is not ported yet (ROADMAP Queue 1 item 7)")
    if int(settings.profiler_port) > 0:
        problems.append(
            f"PROFILER_PORT={settings.profiler_port}: the profiler server "
            "is not ported yet (ROADMAP Queue 1 item 2); trace with "
            "torch.profiler in-process")
    return problems


def startup(device: DeviceLike = "cuda") -> None:
    """Fail-fast startup gate + index recovery (reference lifespan:
    app/main.py:33-39), on ``device`` (the card unless the caller asks
    for the CPU; asking for CUDA without a card raises). Settings whose
    feature is not ported raise before anything starts. An empty index is
    rebuilt from the store; an index already populated in this process is
    served as it is (the JAX package reconciles it with the store through
    the syncer, which is not ported yet)."""
    configure_logging(settings.log_level)
    problems = _unported_settings()
    if problems:
        raise RuntimeError("; ".join(problems))
    store = get_store()
    if not settings.skip_version_check:
        ok, message = store.validate_versions()
        if not ok:
            raise RuntimeError(message)
    with store.read() as conn:
        vocab_row = conn.execute(
            "SELECT MAX(version) AS v FROM lex_vocab WHERE applied=1"
        ).fetchone()
    if vocab_row["v"] is not None:
        raise RuntimeError(
            f"the store's lexical vocab v{vocab_row['v']}: {VOCAB_NOT_PORTED}")
    from ..ingest.ingest import rebuild_index_from_store

    index = get_index(device)
    if index.chunks.count == 0 and index.artifacts.count == 0:
        counts = rebuild_index_from_store()
        logger.info("api.startup index_rebuilt chunks=%s artifacts=%s", *counts)
    else:
        logger.info(
            "api.startup index_prepopulated chunks=%s artifacts=%s",
            index.chunks.count, index.artifacts.count,
        )
    if (
        settings.dense_ivf_enabled
        and index.chunks.count >= int(settings.ivf_min_rows)
        and not index.chunks.ivf_usable()
    ):
        state = index.chunks.build_ivf()
        logger.info(
            "api.startup ivf_built rows=%s clusters=%s nprobe=%s",
            state.built_count, state.n_clusters, state.nprobe,
        )
    logger.info("api.startup complete device=%s", index.device)


def build_router() -> Router:
    router = Router()
    router.add("GET", "/health", health)
    router.add("GET", "/diagnostics", diagnostics)
    router.add("POST", "/ingest/transcript", ingest_transcript_endpoint)
    router.add("POST", "/ingest/transcript/batch",
               ingest_transcript_batch_endpoint)
    router.add("POST", "/ingest/call", ingest_call_endpoint)
    router.add("POST", "/ingest/analysis", ingest_analysis_endpoint)
    jobs = _not_ported("the ingest job queue (ingest/fs_queue.py)", "3")
    router.add("GET", "/ingest/jobs", jobs)
    router.add("GET", "/ingest/jobs/{ingest_job_id}", jobs)
    router.add("GET", "/calls", list_calls_endpoint)
    router.add("GET", "/calls/{call_id}", get_call_endpoint)
    router.add("DELETE", "/calls/{call_id}",
               _not_ported("deleting a call (delete_call, compaction)", "3"))
    router.add("GET", "/chunks/{chunk_id}", get_chunk_endpoint)
    router.add("POST", "/expand", expand_endpoint)
    router.add("POST", "/retrieve", retrieve_endpoint)
    router.add("POST", "/retrieve/batch", retrieve_batch_endpoint)
    router.add("GET", "/index/stats", index_stats_endpoint)
    router.add("GET", "/metrics", metrics_endpoint)
    return router
