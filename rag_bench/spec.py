"""The benchmark's files, found by name.

``Cell`` joins one entry of ``BENCHMARK.json``'s ``workloads`` with its
deployment (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its own settings
(``workloads/<cell>.json``) and its deployment's query embedder
(``reference/embedders/<name>.py``, named by the configuration's
``query_embedder``, ``stub`` when it names none). ``root`` is the
directory that holds ``BENCHMARK.json``; the data files live under
``root/rag_bench``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    entry: Dict[str, Any]       # the BENCHMARK.json workload entry
    config: Dict[str, Any]      # configs/<config>.json
    traffic: Dict[str, Any]     # traffic/<traffic>.json
    own: Dict[str, Any]         # workloads/<cell>.json
    benchmark: Dict[str, Any]   # the whole BENCHMARK.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def end_to_end(self) -> List[Dict[str, Any]]:
        return [m for m in self.benchmark["end_to_end"] if self._listed(m)]

    def per_layer(self) -> List[Dict[str, Any]]:
        return [m for m in self.benchmark["per_layer"] if self._listed(m)]

    def _listed(self, metric: Dict[str, Any]) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def embedder(self) -> ModuleType:
        """The deployment's query embedder: ``prepare``, ``warm`` and the
        plain reference ``embed`` (``reference/embedders/stub.py``)."""
        name = self.config.get("query_embedder", "stub")
        return load_file(self.root / "rag_bench" / "reference" / "embedders"
                         / f"{name}.py", "rag_bench_embedder_" + name)


def load_file(path: Path, name: str) -> ModuleType:
    """The module in the file ``path``, under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _read(Path(root) / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files;
    ``KeyError`` when the benchmark has no such cell."""
    root = Path(root)
    benchmark = load_benchmark(root)
    entries = {w["name"]: w for w in benchmark["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}: "
                       f"{sorted(entries)}")
    entry = entries[name]
    data = root / "rag_bench"
    configs = {c["name"]: c for c in benchmark["configs"]}
    config = _read(root / configs[entry["config"]]["file"])
    traffic = _read(data / "traffic" / f"{entry['traffic']}.json")
    own = _read(data / "workloads" / f"{name}.json")
    return Cell(name=name, root=root, entry=entry, config=config,
                traffic=traffic, own=own, benchmark=benchmark)
