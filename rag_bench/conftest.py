"""Fixtures of the benchmark's self-tests: a checkout-like root holding the
benchmark's files and, added beside them by files and entries alone, a
tiny deployment (``tiny``), three tiny cells and one more per-layer metric,
with the full-size ``cadence-1m.packs`` cell kept for later, by entries alone,
small enough for the CPU: ids only, evidence packs, and packs scoped to
one call.

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
             "limits": {"rrf_gap": 0.0025}}
DUMMY_METRIC = '''"""``dummy.batches``: batches the engine served in the window."""


def read(ctx):
    return float(sum(ev["tag"] == "retrieve.plan" for ev in ctx["spans"])) or None
'''


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    data = root / "rag_bench"
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(ROOT / "rag_bench" / sub, data / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((data / "configs" / "cadence-1m.json").read_text())
    config.update(TINY_CONFIG)
    config["settings"].update(embeddings_dim=1024, lexical_dim=1024)
    (data / "configs" / "tiny.json").write_text(json.dumps(config))
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
    (data / "metrics" / "dummy.batches.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "tiny", "source": "a test", "why": "a test",
                             "file": "rag_bench/configs/tiny.json", "reduced": []})
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
         "chips": 1, "why": "a test"}]
    bench["per_layer"].append({"name": "dummy.batches", "unit": "batches",
                               "better": "higher", "source": "program_span",
                               "layer": "engine (engine/retrieve.py)", "moves": "qps",
                               "workloads": ["tiny.ids"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
