"""The plain Qwen3-Embedding forward: the query encoder's reference.

Plain ``torch`` only, in float32 on the bfloat16 weights of a checkpoint,
one layer's weights at a time on the device. It reads the checkpoint's npz
itself (the layout ``cadence_rag_tpu_torch.models.qwen3.load_params``
reads: stacked ``(layers, ...)`` tensors, bfloat16 ones as uint16 bits
named in ``__bf16__``) and imports nothing of the program.

The forward of Qwen3-Embedding (the Qwen3 Embedding report,
arXiv:2506.05176; the block of arXiv:2505.09388), given the configuration's
``query_encoder`` group: the token embedding; per layer RMSNorm, the q, k
and v projections, a per-head RMSNorm of q and k, neox half-split RoPE
(``rope_theta``), causal attention over the non-pad keys with each key and
value head repeated over its group of query heads, the output projection
and the residual, then RMSNorm, SwiGLU and the residual; the final RMSNorm,
the last non-pad position pooled, its first ``output_dim`` features kept
(2560 -> 1024) and L2-normalised.

Where it departs from the published model, as the deployment under test
does:

- tokens come from the word-hash tokenizer (``tokenize``: FNV-1a 64 of
  ``"qtok:" + word`` over the lower-cased, whitespace-split text, mod
  ``vocab_size - 1``, plus 1; 0 is the pad), not Qwen's byte-level BPE,
  and no end-of-text token is appended;
- no instruction prefix is put before a query;
- the weights are the checkpoint's (random, drawn from the run seed), not
  the published ones.

``gemm`` is the product every matrix multiplication takes (both attention
products included): ``matmul`` in float32, or ``fp8_matmul``, each operand
rounded to ``float8_e4m3fn`` under a per-tensor amax scale, one precision
below the bfloat16 operands the deployment states (the control).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK64 = 2**64 - 1
FP8_MAX = 448.0     # float8_e4m3fn's largest finite value
BATCH = 256         # texts a forward: a run's whole sample
PER_LAYER = ("ln1", "wq", "wk", "wv", "q_norm", "k_norm", "wo", "ln2",
             "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class Shape:
    vocab: int
    d_model: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    max_len: int
    out_dim: int
    rope_theta: float
    eps: float


def shape(config: Dict[str, Any]) -> Shape:
    """The encoder's shape from a configuration's ``query_encoder`` group
    (the names of the published ``config.json``)."""
    g = config["query_encoder"]
    return Shape(vocab=int(g["vocab_size"]), d_model=int(g["hidden_size"]),
                 layers=int(g["num_hidden_layers"]),
                 heads=int(g["num_attention_heads"]),
                 kv_heads=int(g["num_key_value_heads"]), head_dim=int(g["head_dim"]),
                 d_ff=int(g["intermediate_size"]), max_len=int(g["max_input_tokens"]),
                 out_dim=int(g["output_dim"]), rope_theta=float(g["rope_theta"]),
                 eps=float(g["rms_norm_eps"]))


def param_shapes(s: Shape) -> Dict[str, tuple]:
    """Each tensor of the checkpoint and its shape; matrices are (in, out)."""
    L, D, q, kv = s.layers, s.d_model, s.heads * s.head_dim, s.kv_heads * s.head_dim
    return {"tok_emb": (s.vocab, D), "ln1": (L, D), "wq": (L, D, q),
            "wk": (L, D, kv), "wv": (L, D, kv), "q_norm": (L, s.head_dim),
            "k_norm": (L, s.head_dim), "wo": (L, q, D), "ln2": (L, D),
            "w_gate": (L, D, s.d_ff), "w_up": (L, D, s.d_ff), "w_down": (L, s.d_ff, D),
            "final_norm": (D,)}


def fnv1a64(data: bytes) -> int:
    h = FNV_OFFSET
    for byte in data:
        h = ((h ^ byte) * FNV_PRIME) & MASK64
    return h


def tokenize(texts: Sequence[str], s: Shape) -> np.ndarray:
    """-> (n, longest) int64 ids, 0 = pad, at most ``max_len`` a text."""
    rows = [[fnv1a64(b"qtok:" + w.encode("utf-8")) % (s.vocab - 1) + 1
             for w in t.lower().split()[:s.max_len]] for t in texts]
    out = np.zeros((len(rows), max((len(r) for r in rows), default=1)), np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def read_params(path) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors on the host: bfloat16 where ``__bf16__``
    names them, float32 otherwise."""
    out = {}
    with np.load(path, allow_pickle=False) as data:
        bf16 = {str(n) for n in data["__bf16__"]}
        for name in data.files:
            if name.startswith("__"):
                continue
            arr = data[name]
            out[name] = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                         if name in bf16 else torch.from_numpy(arr))
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(a), _fp8(b))


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(params: Mapping[str, torch.Tensor], s: Shape, ids: np.ndarray, device,
            gemm: Callable = matmul) -> torch.Tensor:
    """(n, S) ids, 0 = pad, each text's ids first -> (n, out_dim) float64
    unit vectors. ``params`` may live anywhere; each layer's weights are
    copied to ``device`` and cast to float32 there."""
    device = torch.device(device)
    ids_t = torch.as_tensor(ids, dtype=torch.int64)
    n, S = ids_t.shape
    hd, G = s.head_dim, s.heads // s.kv_heads
    real = (ids_t != 0).to(device)
    x = params["tok_emb"][ids_t].to(device, torch.float32)          # (n, S, D)
    inv = 1.0 / s.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv[None, :]
    sin, cos = (t.to(device, torch.float32) for t in (ang.sin(), ang.cos()))
    allowed = (torch.ones(S, S, dtype=torch.bool, device=device).tril()[None]
               & real[:, None, :])[:, None]                          # (n, 1, S, S)
    for i in range(s.layers):
        w = {k: params[k][i].to(device, torch.float32) for k in PER_LAYER}
        h = _rms(x, w["ln1"], s.eps)
        q = gemm(h, w["wq"]).view(n, S, s.heads, hd)
        k = gemm(h, w["wk"]).view(n, S, s.kv_heads, hd)
        v = gemm(h, w["wv"]).view(n, S, s.kv_heads, hd)
        q = _rope(_rms(q, w["q_norm"], s.eps).transpose(1, 2), sin, cos)
        k = _rope(_rms(k, w["k_norm"], s.eps).transpose(1, 2), sin, cos)
        k = k.repeat_interleave(G, dim=1)                           # (n, H, S, hd)
        v = v.transpose(1, 2).repeat_interleave(G, dim=1)
        logits = gemm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(logits.masked_fill(~allowed, -1e9), dim=-1)
        ctx = gemm(probs, v).transpose(1, 2).reshape(n, S, s.heads * hd)
        x = x + gemm(ctx, w["wo"])
        h = _rms(x, w["ln2"], s.eps)
        x = x + gemm(torch.nn.functional.silu(gemm(h, w["w_gate"])) * gemm(h, w["w_up"]),
                     w["w_down"])
        del w, h, q, k, v, logits, probs, ctx
    x = _rms(x, params["final_norm"].to(device, torch.float32), s.eps)
    last = real.sum(dim=1).clamp(min=1) - 1
    pooled = x[torch.arange(n, device=device), last, :s.out_dim].double()
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def embed(params: Mapping[str, torch.Tensor], s: Shape, texts: Sequence[str], device,
          gemm: Callable = matmul) -> np.ndarray:
    """Texts -> (n, out_dim) float64 unit vectors, ``BATCH`` texts a pass."""
    out = [forward(params, s, tokenize(texts[i:i + BATCH], s), device, gemm).cpu()
           for i in range(0, len(texts), BATCH)]
    return (torch.cat(out).numpy() if out
            else np.zeros((0, s.out_dim), dtype=np.float64))
