"""The port imports and serves without jax and without the JAX package
(the machine with the card has no jax): the port keeps its own copies of
the package's host modules.

These run in subprocesses: tests/conftest.py imports jax in this process.
The first also blocks pydantic, aiohttp and httpx: every module that does
not need them imports, and chip_smoke.py's device paths run on the CPU at a
tiny size: the main path (synthetic corpora, known rows, planned queries,
both packed dispatches), the IVF batch (build, planned "ivf", served by
IVF), and the recall gate (ann, pallas, ivf, hnsw) with the filtered-recall
sweep. The second allows the HTTP stack (the machine with the card has it):
every module imports, the in-process client serves the fixture corpus, and
chip_smoke.py's serve phase runs over a localhost socket at a tiny size.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, json, pkgutil, sys
HTTP_STACK = ("pydantic", "aiohttp", "httpx")
BLOCKED = ("jax", "jaxlib", "cadence_rag_tpu") + HTTP_STACK
for name in BLOCKED:
    sys.modules[name] = None

import cadence_rag_tpu_torch
modules, need_http = [], []
for info in pkgutil.walk_packages(cadence_rag_tpu_torch.__path__,
                                  "cadence_rag_tpu_torch.", onerror=lambda name: None):
    try:
        importlib.import_module(info.name)
        modules.append(info.name)
    except ImportError as exc:
        if exc.name not in HTTP_STACK:
            raise
        need_http.append(info.name)

from cadence_rag_tpu_torch.config import settings
settings.embeddings_dim = 64
settings.lexical_dim = 512
settings.index_initial_capacity = 256
settings.ivf_min_rows = 64

import torch
import chip_smoke
index, batches, summary = chip_smoke.run_main_path(
    "cpu", n_chunks=5000, n_artifacts=600, batch=8, n_known=4)
ivf_modes, _args, ivf = chip_smoke.run_ivf_batch(
    index, *chip_smoke.known_rows(4), 8)
recall = chip_smoke.run_recall(
    torch.device("cpu"), 8192, 16, 10, hnsw_n=1024, sweep_n=2048,
    sweep_rounds=1, cases=((1.0, "contiguous"), (0.05, "random")))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps({"modules": modules, "need_http": need_http, "loaded": loaded,
                  "modes": [summary[n]["modes"] for n in ("unscoped", "scoped")],
                  "capacity": index.chunks.capacity,
                  "ivf_modes": ivf_modes, "ivf_built": ivf["built_count"],
                  "gate": [(r["mode"], r["density"]) for r in recall["gate"]],
                  "sweep_rows": len(recall["sweep"])}))
"""


def test_port_runs_without_jax_pydantic_http():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    expected = {
        "cadence_rag_tpu_torch.device",
        "cadence_rag_tpu_torch.kernels.build",
        "cadence_rag_tpu_torch.ops.fused_scan",
        "cadence_rag_tpu_torch.ops.tech_keys",
        "cadence_rag_tpu_torch.ops.pack",
        "cadence_rag_tpu_torch.core.index",
        "cadence_rag_tpu_torch.engine.planner",
        "cadence_rag_tpu_torch.evals.synth",
        "cadence_rag_tpu_torch.ops.dense_scan",
        "cadence_rag_tpu_torch.ops.ivf",
        "cadence_rag_tpu_torch.evals.ann_recall_gate",
        "cadence_rag_tpu_torch.evals.filtered_recall_sweep",
        "cadence_rag_tpu_torch.config",
        "cadence_rag_tpu_torch.ingest.featurize",
        "cadence_rag_tpu_torch.embed.stub",
        "cadence_rag_tpu_torch.native.rrf",
        "cadence_rag_tpu_torch.native.hnsw",
    }
    assert expected <= set(out["modules"])
    # only the request path's modules need the HTTP stack
    http_side = ("schemas", "serve", "engine.retrieve", "engine.filters",
                 "ingest.chunking", "ingest.ingest", "embed.client", "embed.pipeline")
    assert out["need_http"] and all(
        name.split(".", 1)[1].startswith(http_side) for name in out["need_http"])
    # unscoped chunks plan ann, the scoped batch plans exact
    assert out["modes"] == [["ann", "ann"], ["exact", "exact"]]
    assert out["capacity"] == 8192
    # with an IVF index the unscoped chunks plan ivf (artifacts stay ann)
    assert out["ivf_modes"] == ["ivf", "ann"] and out["ivf_built"] == 5004
    assert out["gate"] == [[m, d] for m in ("ann", "pallas", "ivf")
                           for d in (1.0, 0.05)] + [["hnsw", 1.0]]
    assert out["sweep_rows"] == 10


def test_cuda_request_without_card_raises():
    """Asking for CUDA where there is none is an error, never the CPU."""
    import pytest
    import torch

    from cadence_rag_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


SERVE_SCRIPT = r"""
import importlib, json, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "cadence_rag_tpu")
for name in BLOCKED:
    sys.modules[name] = None

import cadence_rag_tpu_torch
modules = []
for info in pkgutil.walk_packages(cadence_rag_tpu_torch.__path__,
                                  "cadence_rag_tpu_torch."):
    importlib.import_module(info.name)
    modules.append(info.name)

import tempfile
from cadence_rag_tpu_torch.config import settings
settings.embeddings_dim = 64
settings.lexical_dim = 1024
settings.index_initial_capacity = 256
settings.store_sync_interval_s = 0.0
settings.embeddings_provider = "stub"
settings.store_path = tempfile.mkdtemp() + "/store.db"

from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu_torch.evals.fixtures import ingest_fixtures
from cadence_rag_tpu_torch.serve.testing import TestClient
client = TestClient(device="cpu")
ingest_fixtures()
run_embedding_backfill(batch_size=16)
resp = client.post("/retrieve", json={"query": "what caused the ECONNRESET errors",
                                      "return_style": "ids_only"})

import chip_smoke
serve = chip_smoke.run_serve("cpu", 5000, 600, concurrency=16, cold_rounds=1,
                             warm_rounds=1, bench_iters=1, profile=False,
                             window_ms=50)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps({"modules": len(modules), "loaded": loaded,
                  "status": resp.status_code, "ids": resp.json()["retrieved_ids"][:3],
                  "known_first": serve["known_first"],
                  "batched_max": serve["batched_max"], "gate": serve["gate"]}))
"""


def test_port_serves_without_jax():
    """Every module imports without jax; the router serves the fixture
    corpus, and chip_smoke's serve phase passes its checks on the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["modules"] >= 60
    assert out["status"] == 200 and out["ids"][0].startswith(("chunk:", "artifact_chunk:"))
    assert out["known_first"] == 16
    assert out["batched_max"] > 1
    assert out["gate"]["mrr"] >= 0.60 and out["gate"]["recall@20"] >= 0.80
