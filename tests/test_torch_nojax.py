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
chip_smoke.py's serve phase runs over a localhost socket at a tiny size,
its ``writes`` phase included (the scanner and the worker as child processes
that block jax too, the syncer, deletes over HTTP, a compaction under
traffic), and its ``lifecycle`` phase (the rerank lane, a checkpoint saved
under traffic and restored, the growth through the background migration),
then the int8 batch and the lifecycle steps that bring their own stores: the
vocab head over documents of the checkout's frozen text, the capped index
against the uncapped one, the synchronous growth. ``ml_dtypes`` is blocked
as well: the checkpoint's bf16 rows must not need it. The third drives the
training entry points on the CPU at a few steps: both training scripts'
``main`` over a store of the paraphrase corpus, the paraphrase gate, the
rerank gate's training branch and the geometry gate's ``main`` over the
committed embedder at a small n. The fourth runs chip_smoke.py's
``parallel`` phase on the CPU at a tiny size: the one-process mesh of two
shards held to the unsharded index (batches, IVF, growth, a v2 round trip),
the two-process gang (the follower, the dist_check workers and the HTTP
client are child processes that block jax too) and ``dist_check``.
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
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu") + HTTP_STACK
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
        "cadence_rag_tpu_torch.native.lexhash",
        "cadence_rag_tpu_torch.ingest.docformats",
        "cadence_rag_tpu_torch.core.checkpoint",
        "cadence_rag_tpu_torch.core.coldtier",
        "cadence_rag_tpu_torch.core.prewarm",
        "cadence_rag_tpu_torch.evals.coldtier_bench",
        "cadence_rag_tpu_torch.evals.lexical_fidelity",
        "cadence_rag_tpu_torch.evals.gate",
        "cadence_rag_tpu_torch.evals.run_eval",
        "cadence_rag_tpu_torch.parallel",
        "cadence_rag_tpu_torch.parallel.mesh",
        "cadence_rag_tpu_torch.parallel.sharded",
        "cadence_rag_tpu_torch.parallel.oplog",
        "cadence_rag_tpu_torch.evals.dist_check",
        "cadence_rag_tpu_torch.scripts.build_ivf",
    }
    assert expected <= set(out["modules"])
    # only the request path's modules need the HTTP stack
    http_side = ("schemas", "serve", "engine.retrieve", "engine.filters",
                 "engine.rerank", "core.vocab",
                 "ingest.chunking", "ingest.ingest", "embed.client", "embed.pipeline",
                 "ingest.adapters", "ingest.fs_queue", "ingest.sync", "scripts")
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
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu")
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
settings.embeddings_dim = 32             # the tiny Qwen3 preset's width
settings.lexical_dim = 1024
settings.index_initial_capacity = 256
settings.store_sync_interval_s = 0.0
settings.embeddings_provider = "stub"
settings.prewarm_min_capacity = 256      # the growth trigger, at this size
settings.cold_block_rows = 1024
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
                             window_ms=50, write_rounds=30, lifecycle_rounds=2,
                             models_preset="tiny")
writes = serve["writes"]
models = serve["models"]
offline = chip_smoke.run_models_offline(
    __import__("torch").device("cpu"), __import__("pathlib").Path(tempfile.mkdtemp()),
    cpu_gate=False)
life = serve["lifecycle"]
int8 = chip_smoke.run_int8_served("cpu", 3000, 300, 8, 4)
vocab = chip_smoke.run_vocab("cpu", 3000, 300, 256, 8, 16)
full, batches, _summary = chip_smoke.run_main_path(
    "cpu", n_chunks=5000, n_artifacts=600, batch=16, n_known=4)
cold = chip_smoke.run_cold_tier("cpu", full, batches, 2048, 4, 16)
grown = chip_smoke.run_sync_growth("cpu", full, batches, 16)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps({"modules": len(modules), "loaded": loaded,
                  "status": resp.status_code, "ids": resp.json()["retrieved_ids"][:3],
                  "known_first": serve["known_first"],
                  "batched_max": serve["batched_max"], "gate": serve["gate"],
                  "native": sorted(serve["split_ids_only"]) == sorted(
                      serve["split_ids_only_python"]),
                  "sync": writes["sync"]["bundles"],
                  "deleted": writes["delete"]["calls"],
                  "compacted": [(r["corpus"], r["rows_before"], r["rows_after"])
                                for r in writes["compaction"]["records"]],
                  "count_after": writes["compaction"]["count_after"],
                  "known_after": writes["compaction"]["known_first"],
                  "on_index": [r["rows"] for r in writes["kernels_tombstoned"]
                               + writes["kernels_compacted"]],
                  "int8": int8["known_first"],
                  "gate_reranked": serve["gate_reranked"],
                  "reranked_from": life["rerank"]["reranked_from"],
                  "saves": sorted((k, v["generation"])
                                  for k, v in life["checkpoint"]["saves"].items()),
                  "restored": life["checkpoint"]["rows"],
                  "restored_known": life["checkpoint"]["known_first"],
                  "migrated": [life["growth_migration"][k] for k in
                               ("old_capacity", "planned", "capacity", "known_first")],
                  "vocab": [vocab[k] for k in ("documents", "head", "version",
                                               "rows_rescattered", "known_first")],
                  "cold": [cold[k] for k in ("hot_rows", "cold_rows", "blocks",
                                             "deleted", "backfilled", "known_first")],
                  "cold_moved": [cold["batches"][n]["ids_moved"]
                                 for n in ("unscoped", "scoped")],
                  "cold_blocks": [r["rows"] for r in cold["kernels"]],
                  "grown": [grown["old_capacity"], grown["capacity"]],
                  "qwen3": [models["init"]["model"], models["known_first"],
                            sorted(models["served"]), sorted(models["rerank"]),
                            models["check"]["queries"]["max_abs_err"]],
                  "qwen3_launches": models["launches"],
                  "neural_gate": offline["gate_neural"]["metrics"],
                  "paraphrase": offline["paraphrase_mrr"],
                  "rerank_gate": [offline["rerank_gate"][k] for k in
                                  ("neural_mrr", "lexical_mrr", "failures")],
                  "embed_service": [offline["embed_service"][k]
                                    for k in ("rows", "model", "max_abs_err")]
                                   + [chip_smoke.EMBED_SERVICE_ATOL]}))
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
    assert out["modules"] >= 70
    assert out["status"] == 200 and out["ids"][0].startswith(("chunk:", "artifact_chunk:"))
    assert out["known_first"] == 16
    assert out["batched_max"] > 1
    assert out["gate"]["mrr"] >= 0.60 and out["gate"]["recall@20"] >= 0.80
    # the writes phase: 16 synced bundles, 12 calls deleted over HTTP, both
    # corpora compacted inside the crossing DELETE to their live rows, the
    # 16 ingested and 12 surviving synced known rows first afterwards
    assert out["native"] and out["sync"] == 16 and out["deleted"] == 12
    chunks, artifacts = out["compacted"]
    assert chunks[0] == "chunks" and artifacts[0] == "artifact_chunks"
    assert chunks[1] == 5032 and chunks[2] == out["count_after"]["chunks"] < 0.76 * 5032
    assert artifacts[2] == out["count_after"]["artifact_chunks"] < 0.76 * 601
    assert out["known_after"] == 28
    assert out["on_index"] == [8192, 1024, 4096, 512]
    assert out["int8"] == 8
    # the lifecycle phase: the reranked gate over its floors, every answer
    # reranked; two saves, the second generation restored with every known
    # row first; the growth through the migration, on the planned capacity
    assert out["gate_reranked"]["mrr"] >= 0.60
    assert out["gate_reranked"]["recall@20"] >= 0.80
    assert out["reranked_from"] >= 1
    assert out["saves"] == [["background", 1], ["blocking", 0]]
    assert out["restored"] == {"chunks": out["count_after"]["chunks"],
                               "artifact_chunks": out["count_after"]["artifact_chunks"]}
    assert out["restored_known"] == 28
    assert out["migrated"] == [4096, 8192, 8192, 44]
    # its steps on their own stores: the vocab head over 3,300 documents of
    # the checkout's frozen text; the capped index against the uncapped one
    # (three cold blocks, the tail ragged); the synchronous growth
    assert out["vocab"] == [3300, 256, 1, 3300, 8]
    assert out["cold"] == [2048, 2956, 3, 65, 8, 3]
    assert out["cold_moved"] == [0, 0] and out["cold_blocks"] == [1024, 908]
    assert out["grown"] == [8192, 16384]
    # the models phase: the tiny Qwen3 encoder beside the served index, its
    # known rows first, stub and qwen3 rounds, lexical and neural reranking;
    # the neural embedder's gate, paraphrase MRR, the rerank gate and the
    # /embed service (a child process) on their own stores
    model, known, served, reranked, err = out["qwen3"]
    assert model == "qwen3-shaped-64d2L-synthetic" and known == 16
    assert served == ["qwen3", "stub"] and reranked == ["lexical", "neural"]
    assert err == 0.0                   # the CPU's default path is the plain one
    assert out["qwen3_launches"] == {"fused_scan": 0, "tech_topk": 0}
    assert out["neural_gate"]["mrr"] >= 0.60 and out["neural_gate"]["recall@20"] >= 0.80
    assert out["paraphrase"]["neural"] > out["paraphrase"]["stub"] + 0.05
    neural_mrr, lexical_mrr, failures = out["rerank_gate"]
    assert failures == [] and neural_mrr > lexical_mrr + 0.10
    # the service embeds the backfill's batches of 4 and 2, the in-process
    # provider all 6 at once: the CPU's f32 GEMMs may sum in another order
    rows, model, err, atol = out["embed_service"]
    assert rows == 6 and model == "cadence-neural-embedder-128d2L-tuned"
    assert err <= atol == 1e-5


TRAIN_SCRIPT = r"""
import io, json, sys, tempfile
from contextlib import redirect_stdout
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu")
for name in BLOCKED:
    sys.modules[name] = None
from pathlib import Path

import torch
torch.set_num_threads(1)    # thousands of small ops beside other test workers

from cadence_rag_tpu_torch.config import settings
from cadence_rag_tpu_torch.core.index import get_index, reset_index
from cadence_rag_tpu_torch.device import set_models_device
from cadence_rag_tpu_torch.evals import geometry_gate, paraphrase_gate, rerank_gate
from cadence_rag_tpu_torch.evals.train_corpus import (
    generate_calls, ingest_synth_calls, train_eval_split)
from cadence_rag_tpu_torch.models import embedder, reranker
from cadence_rag_tpu_torch.scripts import train_embedder, train_reranker
from cadence_rag_tpu_torch.store.db import reset_store

work = Path(tempfile.mkdtemp())
settings.store_path = str(work / "train.db")
settings.embeddings_dim = 64
settings.index_initial_capacity = 1024
reset_store(); reset_index()
get_index("cpu")
set_models_device("cpu")
ingest_synth_calls(generate_calls(train_eval_split(seed=0)[0][:40], seed=0))
out = {}
sys.argv = ["train_embedder", "--out", str(work / "e.npz"), "--steps", "2",
            "--batch", "8", "--d-model", "32", "--n-layers", "1",
            "--vocab-buckets", "1024", "--device", "cpu"]
train_embedder.main()
out["embedder"] = embedder.load_params(str(work / "e.npz"), "cpu")[1].d_model
sys.argv = ["train_reranker", "--out", str(work / "r.npz"), "--steps", "2",
            "--batch", "8", "--queries", "40", "--d-model", "32", "--n-layers", "1",
            "--vocab-buckets", "1024", "--max-len", "32", "--device", "cpu"]
with redirect_stdout(io.StringIO()) as printed:
    train_reranker.main()
out["reranker"] = [reranker.load_params(str(work / "r.npz"), "cpu")[1].d_model,
                   printed.getvalue().strip().split()[-1]]
reset_store(); reset_index()
settings.embeddings_dim = 1024
para = paraphrase_gate.run_gate(device="cpu", steps=3)
out["paraphrase"] = [para["train_pairs"], para["queries"], para["stub_mrr"]]
rr = rerank_gate.run_gate(device="cpu", steps=3, fixture_phase=False, min_margin=-1.0,
                          min_mrr=0.0)
out["rerank"] = [rr["triples"], rr["queries"], rr["final_loss"] is not None]
sys.argv = ["geometry_gate", "--n", "2000", "--queries", "32", "--device", "cpu"]
with redirect_stdout(io.StringIO()) as printed:
    try:
        geometry_gate.main()
    except SystemExit as exc:
        out["geometry_exit"] = exc.code
out["geometry"] = json.loads(printed.getvalue().strip().splitlines()[-1])
out["loaded"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps(out))
"""


def test_training_runs_without_jax():
    """Both training scripts, the paraphrase gate, the rerank gate's
    training branch and the geometry gate run with jax, jaxlib, ml_dtypes
    and the JAX package blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", TRAIN_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["embedder"] == 32
    assert out["reranker"][0] == 32 and 0.0 <= float(out["reranker"][1]) <= 1.0
    pairs, queries, stub_mrr = out["paraphrase"]
    assert pairs == 1325 and queries == 24 and stub_mrr == 0.5474   # 1024-d stub
    triples, queries, trained = out["rerank"]
    assert triples > 100 and queries == 24 and trained
    geo = out["geometry"]
    assert out["geometry_exit"] == 0 and geo["pass"] and geo["n"] == 2000
    assert geo["source"] == "tuned-embedder-synthetic-domain"
    assert geo["ann_recall"] >= 0.95


PARALLEL_SCRIPT = r"""
import json, sys
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu")
for name in BLOCKED:
    sys.modules[name] = None
import torch
from cadence_rag_tpu_torch.config import settings
settings.embeddings_dim = 64
settings.lexical_dim = 512
settings.index_initial_capacity = 256
settings.ivf_min_rows = 64

import chip_smoke
full, batches, _summary = chip_smoke.run_main_path(
    "cpu", n_chunks=5000, n_artifacts=1500, batch=8, n_known=4)
ivf_modes, ivf_args, _ivf = chip_smoke.run_ivf_batch(full, *chip_smoke.known_rows(4), 8)
par = chip_smoke.run_parallel("cpu", full, batches, ivf_args, ivf_modes, 8, 4, 5000, 1500,
                              gang_concurrency=16, gang_rounds=2, turns=1)
local, gang, dist = par["local"], par["gang"], par["dist_check"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps({
    "loaded": loaded, "shard_rows": local["shard_rows"],
    "modes": [local[n]["modes"] for n in ("unscoped", "scoped")],
    "fused_identical": [local[n]["fused_identical"] for n in ("unscoped", "scoped")],
    "near_ties": sum(v[1] for n in ("unscoped", "scoped")
                     for v in local[n]["lanes"].values()),
    "ivf": [local["ivf"][k] for k in ("ids_identical", "recall_sharded_build",
                                      "recall_unsharded_build")],
    "growth": [local["growth"][k] for k in ("old_capacity", "capacity")],
    "checkpoint": local["checkpoint"]["format"],
    "dispatched": len(local["dispatched"]) > 0 and len(local["dispatched_grown"]) > 0,
    "backend": gang["backend"], "loaded_rows": gang["oplog_load"]["rows"],
    "delete": gang["delete"]["status"],
    "compacted": sorted(v["capacity"] for v in gang["compaction"].values()),
    "v3": [gang["v3_save"]["format"], gang["v3_save"]["files"]],
    "answers": gang["answers_compared"], "follower_ops": gang["follower_ops"] > 0,
    "shards": sorted(list(gang["launches_leader"]) + list(gang["launches_follower"])),
    "dist": [dist["processes"], sum("MATCH" in ln for ln in dist["lines"])]}))
"""


def test_parallel_phase_runs_without_jax():
    """chip_smoke's parallel phase on the CPU with jax, ml_dtypes and the JAX
    package blocked (one intra-op thread a process: the gang's processes
    share the machine's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", PARALLEL_SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=400,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    # shards of 4096 chunk and 1024 artifact rows: multiples of K1's block,
    # so even ann answers exactly as the unsharded index
    assert out["shard_rows"] == {"chunks": 4096, "artifacts": 1024}
    assert out["modes"] == [["ann", "ann"], ["exact", "exact"]]
    assert out["fused_identical"] == [True, True] and out["near_ties"] == 0
    # the sharded k-means reads both shards: the unsharded build
    ids_identical, sharded_recall, flat_recall = out["ivf"]
    assert ids_identical and sharded_recall == flat_recall
    assert out["growth"] == [2048, 4096] and out["checkpoint"] == 2
    assert out["dispatched"]
    assert out["backend"] == "gloo" and out["loaded_rows"] == 6500
    assert out["delete"] == 200 and out["compacted"] == [2048, 8192]
    assert out["v3"] == [3, {"chunks": 2, "artifact_chunks": 2}]
    assert out["answers"] == 32 and out["follower_ops"]
    assert out["shards"] == ["artifact_chunks/0", "artifact_chunks/1",
                             "chunks/0", "chunks/1"]
    assert out["dist"] == [2, 2]
