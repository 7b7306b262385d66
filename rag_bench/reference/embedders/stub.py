"""The deployment's deterministic hash embedder (``EMBEDDINGS_PROVIDER=stub``).

A deployment names its query embedder by the configuration's
``query_embedder`` (``stub`` when it names none); the harness finds the
file of that name in this folder by path, so a later embedder is a new
file. Each has three functions:

- ``prepare(config, seed, workdir, device) -> {setting: value}``: applied
  with the configuration's ``settings`` before the program starts, such as
  a weights file made from the seed under ``workdir`` and the setting a
  deployment loads it by;
- ``warm(config, traffic) -> [text]``: what the program embeds before the
  window;
- ``embed(config, seed, workdir, texts, device) -> (n, dim) float64``: the
  plain reference, unit vectors, run once the program's state is freed;
  it imports nothing of the program and reads nothing the program made;
- ``control(config, seed, workdir, texts, device)``: the same reference in
  the nearest precision below the one the embedder states, the vectors the
  control serves (``readings.py``; the benchmark's own runs never call it).

The stub needs no file and no setting; its reference is ``features.embed``,
its control that rounded to bfloat16 (the stub states float32), and its
warm-up fills the per-feature cache with the mix's vocabulary.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from rag_bench.reference import features
from rag_bench.traffic.queries import warm_texts


def prepare(config: Dict[str, Any], seed: int, workdir: Path,
            device) -> Dict[str, Any]:
    return {}


def warm(config: Dict[str, Any], traffic: Dict[str, Any]) -> List[str]:
    return warm_texts(traffic, config)


def embed(config: Dict[str, Any], seed: int, workdir: Path, texts: Sequence[str],
          device) -> np.ndarray:
    return features.embed(texts, int(config["embedding_dim"]))


def control(config: Dict[str, Any], seed: int, workdir: Path, texts: Sequence[str],
            device) -> np.ndarray:
    vectors = embed(config, seed, workdir, texts, device)
    return torch.from_numpy(vectors).to(torch.bfloat16).double().numpy()
