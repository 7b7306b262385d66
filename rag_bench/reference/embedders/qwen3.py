"""The deployment's own query encoder, Qwen3-Embedding
(``EMBEDDINGS_PROVIDER=qwen3``), at the widths of the configuration's
``query_encoder`` group.

- ``prepare`` draws the weights from the seed on ``device`` (each tensor,
  and each layer of a stacked one, from a generator of its own: bfloat16
  matrices of standard normals times ``1/sqrt(fan_in)``, ``fan_in`` the
  next-to-last dimension as the program's own seeded weights take it, row
  0 of ``tok_emb`` zero for the pad, norm scales 1) and writes them under
  ``workdir`` in the npz layout the program's checkpoint loader reads; the
  deployment loads them by ``QWEN3_PARAMS_PATH``, as a checkpoint;
- ``warm`` gives one batch of the largest shape the window serves: 128
  queries of nine of the mix's words, the smallest sequence bucket (16);
- ``embed`` is the plain forward (``reference/qwen3_plain.py``) in float32
  on the same file, ``control`` the same with every product's operands
  rounded to float8_e4m3fn, one precision below the bfloat16 the
  deployment states.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from rag_bench.reference import qwen3_plain as plain
from rag_bench.traffic.queries import rng_for, vocabulary

FILE = "qwen3_weights.npz"
NORMS = ("ln1", "ln2", "q_norm", "k_norm", "final_norm")
WARM_BATCH, WARM_WORDS = 128, 9

# the last checkpoint read, by path: the reference and the control read it
# once between them
_read: Dict[str, Dict[str, torch.Tensor]] = {}


def _generator(seed: int, tensor: int, layer: int, device) -> torch.Generator:
    state = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), 30, tensor, layer]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def draw(s: plain.Shape, seed: int, device) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays on the host: bfloat16 ones as their uint16
    bits."""
    out = {}
    for t, (name, shape) in enumerate(plain.param_shapes(s).items()):
        if name in NORMS:
            out[name] = np.ones(shape, dtype=np.float32)
            continue
        scale = 1.0 / np.sqrt(shape[-2])
        stacked = len(shape) == 3
        arr = np.empty(shape, dtype=np.uint16)
        for i in range(shape[0] if stacked else 1):
            block = shape[1:] if stacked else shape
            w = (torch.randn(block, generator=_generator(seed, t, i, device),
                             device=device) * scale).to(torch.bfloat16)
            if name == "tok_emb":
                w[0] = 0
            bits = w.view(torch.int16).cpu().numpy().view(np.uint16)
            if stacked:
                arr[i] = bits
            else:
                arr[...] = bits
        out[name] = arr
    return out


def write(path: Path, arrays: Dict[str, np.ndarray], s: plain.Shape) -> None:
    np.savez(path, **arrays,
             __bf16__=np.array([n for n in arrays if n not in NORMS]),
             __cfg__=np.array([s.vocab, s.d_model, s.layers, s.heads, s.kv_heads,
                               s.head_dim, s.d_ff, s.max_len, s.out_dim], np.int64),
             __cfg_f__=np.array([s.rope_theta, s.eps], np.float64))


def prepare(config: Dict[str, Any], seed: int, workdir: Path,
            device) -> Dict[str, Any]:
    s = plain.shape(config)
    path = Path(workdir) / FILE
    write(path, draw(s, seed, device), s)
    return {"qwen3_params_path": str(path)}


def warm(config: Dict[str, Any], traffic: Dict[str, Any]) -> List[str]:
    words = vocabulary(traffic)
    picks = rng_for(0, 4).integers(0, len(words), (WARM_BATCH, WARM_WORDS))
    return [" ".join(words[j] for j in row) for row in picks]


def _params(workdir: Path) -> Dict[str, torch.Tensor]:
    key = str(Path(workdir) / FILE)
    if key not in _read:
        _read.clear()
        _read[key] = plain.read_params(key)
    return _read[key]


def embed(config: Dict[str, Any], seed: int, workdir: Path, texts: Sequence[str],
          device) -> np.ndarray:
    return plain.embed(_params(workdir), plain.shape(config), texts, device)


def control(config: Dict[str, Any], seed: int, workdir: Path, texts: Sequence[str],
            device) -> np.ndarray:
    return plain.embed(_params(workdir), plain.shape(config), texts, device,
                       gemm=plain.fp8_matmul)
