"""Fixtures of the benchmark's self-tests: a checkout-like root holding the
benchmark's files and, added beside them by files and entries alone, a
tiny deployment (``tiny``), three tiny cells and one more per-layer metric,
with the full-size ``cadence-1m.packs`` cell kept for later, by entries alone,
small enough for the CPU: ids only, evidence packs, and packs scoped to
one call; and a second tiny deployment (``tiny_alias``) whose query
embedder is a new file, the stub under another name that makes a file
from the seed in ``prepare`` and reads it back in ``embed``.

Run with ``python -m pytest rag_bench -q`` from the repository's root;
the tests marked ``cuda`` skip without a card.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from rag_bench.spec import ROOT

# the deployment's embedding width (the control's int8 rounding is judged
# at the width it is served at), fewer rows and a narrower signature
TINY_CONFIG = {
    "name": "tiny", "chunks_rows": 65536, "chunks_capacity": 65536,
    "artifacts_rows": 16000, "artifacts_capacity": 16384, "calls": 64,
    "embedding_dim": 1024, "lexical_dim": 1024, "tech_identifiers": 256,
}
TINY_CELL = {"callers": 16, "warm_seconds": 1, "sample": 32, "marked_share": 0.5,
             "limits": {"rrf_gap": 0.0025, "embed_gap": 1e-5}}
DUMMY_METRIC = '''"""``dummy.batches``: batches the engine served in the window."""


def read(ctx):
    return float(sum(ev["tag"] == "retrieve.plan" for ev in ctx["spans"])) or None
'''

# a query embedder added by a file alone: its weights file made from the
# seed, loaded through a deployment's setting, read back by the reference
ALIAS_EMBEDDER = '''"""The stub under another name, with a file made from the seed."""

import json

import torch

from rag_bench.reference.features import embed as _embed
from rag_bench.traffic.queries import warm_texts

FILE = "alias_weights.json"


def prepare(config, seed, workdir, device):
    (workdir / FILE).write_text(json.dumps({"seed": seed}))
    return {"qwen3_params_path": str(workdir / FILE)}


def warm(config, traffic):
    return warm_texts(traffic, config)


def embed(config, seed, workdir, texts, device):
    if json.loads((workdir / FILE).read_text())["seed"] != seed:
        raise ValueError("another seed's file")
    return _embed(texts, int(config["embedding_dim"]))


def control(config, seed, workdir, texts, device):
    vectors = embed(config, seed, workdir, texts, device)
    return torch.from_numpy(vectors).to(torch.bfloat16).double().numpy()
'''


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    data = root / "rag_bench"
    for sub in ("configs", "traffic", "workloads", "metrics", "reference/embedders"):
        shutil.copytree(ROOT / "rag_bench" / sub, data / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((data / "configs" / "cadence-1m.json").read_text())
    config.update(TINY_CONFIG)
    config["settings"].update(embeddings_dim=1024, lexical_dim=1024)
    (data / "configs" / "tiny.json").write_text(json.dumps(config))
    (data / "configs" / "tiny_alias.json").write_text(json.dumps(dict(
        config, name="tiny_alias", query_embedder="alias")))
    (data / "reference" / "embedders" / "alias.py").write_text(ALIAS_EMBEDDER)
    for name in ("calls_ids", "calls_scoped"):
        traffic = json.loads((data / "traffic" / f"{name}.json").read_text())
        traffic["vocabulary"]["words"] = 500
        traffic["max_rate"] = 600
        (data / "traffic" / f"tiny_{name}.json").write_text(json.dumps(traffic))
    packs = dict(traffic, scope="none")
    (data / "traffic" / "tiny_calls_packs.json").write_text(json.dumps(packs))
    (data / "workloads" / "tiny.ids.json").write_text(json.dumps(dict(
        TINY_CELL, store_rows=False, modes=["ann", "ann"], depth=20)))
    (data / "workloads" / "tiny.scoped.json").write_text(json.dumps(dict(
        TINY_CELL, store_rows=True, modes=["exact", "exact"])))
    (data / "workloads" / "tiny.packs.json").write_text(json.dumps(dict(
        TINY_CELL, store_rows=True, modes=["ann", "ann"])))
    (data / "workloads" / "tiny_alias.ids.json").write_text(json.dumps(dict(
        TINY_CELL, store_rows=False, modes=["ann", "ann"], depth=20)))
    (data / "metrics" / "dummy.batches.py").write_text(DUMMY_METRIC)
    bench["configs"] += [
        {"name": "tiny", "source": "a test", "why": "a test",
         "file": "rag_bench/configs/tiny.json", "reduced": []},
        {"name": "tiny_alias", "source": "a test", "why": "a test",
         "file": "rag_bench/configs/tiny_alias.json", "reduced": []}]
    # the cell kept for later (PERF.md, Open questions), added by entries
    # alone: its files are in the benchmark's folder
    if "cadence-1m" not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": "cadence-1m", "source": "a test",
                                 "why": "a test", "reduced": [],
                                 "file": "rag_bench/configs/cadence-1m.json"})
    if "cadence-1m.packs" not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append({"name": "cadence-1m.packs", "config": "cadence-1m",
                                   "traffic": "calls_packs", "chips": 1,
                                   "why": "a test"})
    bench["workloads"] += [
        {"name": "tiny.ids", "config": "tiny", "traffic": "tiny_calls_ids",
         "chips": 1, "why": "a test"},
        {"name": "tiny.scoped", "config": "tiny", "traffic": "tiny_calls_scoped",
         "chips": 1, "why": "a test"},
        {"name": "tiny.packs", "config": "tiny", "traffic": "tiny_calls_packs",
         "chips": 1, "why": "a test"},
        {"name": "tiny_alias.ids", "config": "tiny_alias", "traffic": "tiny_calls_ids",
         "chips": 1, "why": "a test"}]
    bench["per_layer"].append({"name": "dummy.batches", "unit": "batches",
                               "better": "higher", "source": "program_span",
                               "layer": "engine (engine/retrieve.py)",
                               "moves": "card_us_per_query",
                               "workloads": ["tiny.ids"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
