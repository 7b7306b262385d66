"""The Qwen3-Embedding-4B-shaped encoder, in torch.

Counterpart of ``cadence_rag_tpu/models/qwen3.py``, unsharded: the config
and presets, the synthetic weights (made on the device through
``models/prng.py``, the JAX package's numbers), the npz checkpoints, the
tokenizers (hash and byte-level BPE), ``encode`` and the
``EMBEDDINGS_PROVIDER=qwen3`` provider.

The forward pass is the JAX package's, op for op: GQA with 32 query and 8
key/value heads of 128, per-head RMSNorm of q and k before neox half-split
RoPE (f32, then bf16), the softmax weights cast to bf16 before the PV
product, bf16 residual adds, SwiGLU, last non-pad position pooled, the
hidden truncated 2560 -> 1024 and L2-normalised in f32. GQA scores each
key/value head against its group of query heads, q reshaped to
(B, Hk, G, S, hd), without repeating k or v. The layers' weights are stacked
(L, ...) tensors as in the JAX package's parameter tree.

Precision as in ``models/embedder.py``: ``plain=True`` (the CPU's default)
takes f32 products of bf16-rounded operands; on CUDA every projection and
both attention products are bf16 tensor-core GEMMs with f32 outputs.
Attention is explicit (product, mask, softmax, product): the logits are
(B, 8, 4, S, S) f32, 4.3 GB at 32 texts of 1024 tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, models_device, resolve_device
from ..logging_utils import get_logger
from ..ops.hashing import fnv1a64
from . import prng
from .embedder import bmm_f32, load_flat, mm_f32, use_plain

logger = get_logger(__name__)

# --------------------------------------------------------------- config ----


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_buckets: int = 151_936
    d_model: int = 2560
    n_layers: int = 36
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 9728
    max_len: int = 1024
    embed_dim: int = 1024          # truncation target (2560 -> 1024)
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        per_layer = (
            self.d_model * self.q_dim          # wq
            + 2 * self.d_model * self.kv_dim   # wk, wv
            + self.q_dim * self.d_model        # wo
            + 3 * self.d_model * self.d_ff     # gate, up, down
            + 2 * self.d_model                 # ln1, ln2
            + 2 * self.head_dim                # q_norm, k_norm
        )
        return (
            self.vocab_buckets * self.d_model
            + self.n_layers * per_layer
            + self.d_model                     # final_norm
        )


# Qwen3-4B geometry: config.json of Qwen/Qwen3-Embedding-4B (hidden 2560,
# 36 layers, 32 attention heads, 8 KV heads, head_dim 128, intermediate
# 9728, rope_theta 1e6). "tiny" is the CPU-test shape.
PRESETS: Dict[str, Qwen3Config] = {
    "4b": Qwen3Config(),
    "1b": Qwen3Config(
        vocab_buckets=151_936, d_model=1536, n_layers=24, n_heads=16,
        n_kv_heads=8, head_dim=96, d_ff=4608,
    ),
    "tiny": Qwen3Config(
        vocab_buckets=512, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, max_len=32, embed_dim=32,
    ),
}


def preset(name: str) -> Qwen3Config:
    try:
        return PRESETS[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown qwen3 preset {name!r}; have {sorted(PRESETS)}"
        ) from None


# --------------------------------------------------------------- params ----

def _param_specs(cfg: Qwen3Config) -> List[tuple]:
    """(name, shape, kind) — kind 'w' = scaled normal bf16, 'ones' = f32."""
    L = cfg.n_layers
    return [
        ("tok_emb", (cfg.vocab_buckets, cfg.d_model), "w"),
        ("ln1", (L, cfg.d_model), "ones"),
        ("wq", (L, cfg.d_model, cfg.q_dim), "w"),
        ("wk", (L, cfg.d_model, cfg.kv_dim), "w"),
        ("wv", (L, cfg.d_model, cfg.kv_dim), "w"),
        ("q_norm", (L, cfg.head_dim), "ones"),
        ("k_norm", (L, cfg.head_dim), "ones"),
        ("wo", (L, cfg.q_dim, cfg.d_model), "w"),
        ("ln2", (L, cfg.d_model), "ones"),
        ("w_gate", (L, cfg.d_model, cfg.d_ff), "w"),
        ("w_up", (L, cfg.d_model, cfg.d_ff), "w"),
        ("w_down", (L, cfg.d_ff, cfg.d_model), "w"),
        ("final_norm", (cfg.d_model,), "ones"),
    ]


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics; the result takes ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rope_tables(seq: int, head_dim: int, theta: float, device: torch.device):
    """Neox-style half-split rotary tables, f32, (S, head_dim/2)."""
    inv = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    )
    pos = np.arange(seq, dtype=np.float32)
    ang = np.outer(pos, inv)
    return (torch.from_numpy(np.sin(ang)).to(device),
            torch.from_numpy(np.cos(ang)).to(device))


def _apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
                ) -> torch.Tensor:
    # x: (B, H, S, hd) f32; sin/cos: (S, hd/2)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Qwen3Encoder(nn.Module):
    """The stacked weights of ``_param_specs`` (bf16 ``w``, f32 norms) and
    the forward pass: (B, S) int ids, 0 = pad -> (B, embed_dim) unit
    vectors."""

    def __init__(self, cfg: Qwen3Config, device: DeviceLike):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        for name, shape, kind in _param_specs(cfg):
            dtype = torch.bfloat16 if kind == "w" else torch.float32
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.named_parameters()}

    def _layer(self, x, i, sin, cos, attn_mask, plain):
        cfg = self.cfg
        B, S, _ = x.shape
        groups = cfg.n_heads // cfg.n_kv_heads
        hd = cfg.head_dim
        h = _rms_norm(x, self.ln1[i], cfg.rms_eps)
        q = mm_f32(h, self.wq[i], plain).reshape(B, S, cfg.n_heads, hd)
        k = mm_f32(h, self.wk[i], plain).reshape(B, S, cfg.n_kv_heads, hd)
        v = mm_f32(h, self.wv[i], plain).reshape(B, S, cfg.n_kv_heads, hd)
        v = v.to(torch.bfloat16).transpose(1, 2)                # (B, Hk, S, hd)
        # Qwen3 QK-norm: per-head RMSNorm of q and k before RoPE
        q = _rms_norm(q, self.q_norm[i], cfg.rms_eps)
        k = _rms_norm(k, self.k_norm[i], cfg.rms_eps)
        q = _apply_rope(q.transpose(1, 2), sin, cos).to(torch.bfloat16)
        k = _apply_rope(k.transpose(1, 2), sin, cos).to(torch.bfloat16)
        # GQA: each kv head against its group of query heads, q as
        # (B, Hk, G*S, hd), so k and v are never repeated
        qg = q.reshape(B, cfg.n_kv_heads, groups * S, hd)
        logits = bmm_f32(qg, k.transpose(-1, -2), plain).reshape(
            B, cfg.n_kv_heads, groups, S, S) / math.sqrt(hd)
        logits = torch.where(attn_mask[:, :, None], logits, -1e9)
        weights = torch.softmax(logits, dim=-1).to(torch.bfloat16)
        del logits
        ctx = bmm_f32(weights.reshape(B, cfg.n_kv_heads, groups * S, S), v,
                      plain).to(torch.bfloat16)
        ctx = ctx.reshape(B, cfg.n_heads, S, hd).transpose(1, 2).reshape(
            B, S, cfg.q_dim)
        x = x + mm_f32(ctx, self.wo[i], plain).to(torch.bfloat16)
        h = _rms_norm(x, self.ln2[i], cfg.rms_eps)
        gate = mm_f32(h, self.w_gate[i], plain)
        up = mm_f32(h, self.w_up[i], plain)
        ff = (F.silu(gate) * up).to(torch.bfloat16)
        del gate, up
        return x + mm_f32(ff, self.w_down[i], plain).to(torch.bfloat16)

    @torch.inference_mode()
    def forward(self, token_ids: torch.Tensor,
                plain: Optional[bool] = None) -> torch.Tensor:
        cfg = self.cfg
        token_ids = token_ids.to(self.device, torch.int64)
        plain = use_plain(token_ids, plain)
        B, S = token_ids.shape
        pad_mask = token_ids != 0
        x = self.tok_emb[token_ids]                             # (B, S, D) bf16
        sin, cos = _rope_tables(S, cfg.head_dim, cfg.rope_theta, self.device)
        causal = torch.ones(S, S, dtype=torch.bool, device=self.device).tril()
        attn_mask = causal[None, None] & pad_mask[:, None, None, :]
        for i in range(cfg.n_layers):
            x = self._layer(x, i, sin, cos, attn_mask, plain)
        x = _rms_norm(x, self.final_norm, cfg.rms_eps)
        last = torch.clamp(pad_mask.sum(dim=1) - 1, min=0)
        pooled = x[torch.arange(B, device=self.device), last].float()
        out = pooled[:, : cfg.embed_dim]                        # 2560 -> 1024
        return out / torch.clamp(
            torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-6)


def encode(model: Qwen3Encoder, token_ids, plain: Optional[bool] = None
           ) -> torch.Tensor:
    """(B, S) int32 -> (B, embed_dim) unit vectors."""
    return model(torch.as_tensor(np.asarray(token_ids)), plain)


def init_params(cfg: Qwen3Config, key: torch.Tensor,
                device: DeviceLike) -> Qwen3Encoder:
    """Synthetic weights, made on ``device`` (8 GB at the 4b preset, never
    on the host): the JAX package's ``init_params(cfg, key)``, value for
    value — each ``w`` is ``normal(bf16) * 1/sqrt(fan_in)`` in bf16, each
    norm scale ones."""
    model = Qwen3Encoder(cfg, device)
    specs = _param_specs(cfg)
    keys = prng.split(key, len(specs))
    with torch.no_grad():
        for (name, shape, kind), k in zip(specs, keys):
            param = getattr(model, name)
            if kind == "ones":
                param.fill_(1.0)
            else:
                # fan-in scaling keeps activations O(1) through 36 layers
                fan_in = shape[-2] if len(shape) > 1 else shape[-1]
                prng.normal(k, shape, out=param.data,
                            scale=float(1.0 / np.sqrt(fan_in)))
    return model


def from_jax_params(params: Mapping[str, np.ndarray], cfg: Qwen3Config,
                    device: DeviceLike) -> Qwen3Encoder:
    """The encoder from the JAX package's parameters (numpy leaves; bf16
    leaves as ``ml_dtypes.bfloat16`` or as their uint16 bits)."""
    model = Qwen3Encoder(cfg, device)
    flat = {}
    for name, param in model.named_parameters():
        arr = np.asarray(params[name])
        flat[name] = (_bf16_from_bits(arr.view(np.uint16))
                      if param.dtype == torch.bfloat16 else arr)
    load_flat(model, flat)
    return model


def _bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.require(bits, requirements="CW").view(
        np.int16)).view(torch.bfloat16)


def load_params(path: str, device: DeviceLike
                ) -> Tuple[Qwen3Encoder, Qwen3Config]:
    """Restore a checkpoint: an npz with the ``_param_specs`` layout, bf16
    tensors as uint16 bits named in ``__bf16__``, plus an ``__cfg__`` row.
    A real checkpoint keeps real token id i at ``tok_emb`` row i+1 and row
    0 zeros (id 0 is the pad), matching ``models/tokenizer.BpeTokenizer``'s
    +1 shift."""
    with np.load(path, allow_pickle=False) as data:
        v = data["__cfg__"]
        cfg = Qwen3Config(
            vocab_buckets=int(v[0]), d_model=int(v[1]), n_layers=int(v[2]),
            n_heads=int(v[3]), n_kv_heads=int(v[4]), head_dim=int(v[5]),
            d_ff=int(v[6]), max_len=int(v[7]), embed_dim=int(v[8]),
        )
        bf16 = set(str(n) for n in data.get("__bf16__", np.array([])))
        model = Qwen3Encoder(cfg, device)
        flat = {}
        for name, _, _ in _param_specs(cfg):
            arr = data[name]
            flat[name] = _bf16_from_bits(arr) if name in bf16 else arr
        load_flat(model, flat)
    return model, cfg


def save_params(path: str, model: Qwen3Encoder) -> None:
    # npz has no bf16 dtype: bf16 tensors ship as uint16 bit views with a
    # name manifest
    cfg = model.cfg
    flat = {}
    bf16_names = []
    for name, t in model.params().items():
        if t.dtype == torch.bfloat16:
            bf16_names.append(name)
            flat[name] = t.cpu().view(torch.int16).numpy().view(np.uint16)
        else:
            flat[name] = t.cpu().numpy()
    flat["__bf16__"] = np.array(bf16_names)
    flat["__cfg__"] = np.array(
        [cfg.vocab_buckets, cfg.d_model, cfg.n_layers, cfg.n_heads,
         cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.max_len, cfg.embed_dim],
        dtype=np.int64,
    )
    np.savez(path, **flat)


# ------------------------------------------------------------ tokenizer ----

def batch_tokenize(
    texts: Sequence[str], cfg: Qwen3Config, seq_len: Optional[int] = None,
    bpe=None,
) -> np.ndarray:
    """Text -> (B, seq) int32 ids, 0 = pad.

    With ``bpe`` (a ``models/tokenizer.BpeTokenizer``): byte-level BPE ids
    shifted +1 so id 0 stays the pad. Without: word-level FNV-1a hashing
    into vocab buckets (1-based), the synthetic weights' stand-in."""
    seq = seq_len or cfg.max_len
    out = np.zeros((len(texts), seq), dtype=np.int32)
    if bpe is not None:
        for i, text in enumerate(texts):
            ids = bpe.encode(text, max_len=seq, add_eos=True)
            out[i, : len(ids)] = ids
        return out
    for i, text in enumerate(texts):
        for j, word in enumerate(text.lower().split()):
            if j >= seq:
                break
            h = fnv1a64(b"qtok:" + word.encode("utf-8"))
            out[i, j] = int(h % (cfg.vocab_buckets - 1)) + 1
    return out


# ---------------------------------------------------- provider interface ----

def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def seq_bucket(longest: int, cfg: Qwen3Config) -> int:
    """The padded sequence length of a batch whose longest text has
    ``longest`` tokens: ``min(pow2(longest, lo=16), max_len)``."""
    return min(_pow2(max(longest, 1), lo=16), cfg.max_len)


class Qwen3EmbeddingProvider:
    """Serves the embed_texts contract from the in-process Qwen3-shaped
    encoder (EMBEDDINGS_PROVIDER=qwen3), on the device its entry point
    named (``device.models_device()``) unless one is given. Sequence
    lengths bucket to powers of two (``seq_bucket``); the batch is not
    padded (rows are independent)."""

    _instance: Optional["Qwen3EmbeddingProvider"] = None

    def __init__(self, cfg: Optional[Qwen3Config] = None, seed: int = 0,
                 device: Optional[DeviceLike] = None):
        from ..config import settings

        self.device = resolve_device(device) if device is not None \
            else models_device()
        path = (settings.qwen3_params_path or "").strip()
        if cfg is None and path:
            self.model, self.cfg = load_params(path, self.device)
            suffix = "-ckpt"
        else:
            self.cfg = cfg or preset(settings.qwen3_preset)
            self.model = init_params(self.cfg, prng.PRNGKey(seed), self.device)
            suffix = "-synthetic"
        if int(self.cfg.embed_dim) != int(settings.embeddings_dim):
            raise RuntimeError(
                f"qwen3 config produces {self.cfg.embed_dim}-d vectors but "
                f"EMBEDDINGS_DIM={settings.embeddings_dim}"
            )
        self.bpe = None
        tok_path = (settings.qwen3_tokenizer_path or "").strip()
        if tok_path:
            from .tokenizer import BpeTokenizer

            self.bpe = BpeTokenizer.load(tok_path)
            if self.bpe.vocab_size > self.cfg.vocab_buckets:
                raise RuntimeError(
                    f"tokenizer vocab ({self.bpe.vocab_size} incl. the "
                    f"+1 pad shift) exceeds the model's vocab_buckets "
                    f"({self.cfg.vocab_buckets})"
                )
            suffix += "-bpe"
        elif path:
            logger.warning(
                "qwen3: real checkpoint loaded but QWEN3_TOKENIZER_PATH "
                "is unset — hash-token ids will NOT match the trained "
                "embedding table; set the tokenizer for real quality"
            )
        self.model_id = (
            f"qwen3-shaped-{self.cfg.d_model}d{self.cfg.n_layers}L{suffix}"
        )

    @classmethod
    def shared(cls) -> "Qwen3EmbeddingProvider":
        if cls._instance is None or cls._instance.device != models_device():
            cls._instance = cls()
        return cls._instance

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        """-> (n, seq_bucket) int32 ids, as ``embed`` pads them."""
        n = len(texts)
        if self.bpe is not None:
            id_lists = [
                self.bpe.encode(t, max_len=self.cfg.max_len) for t in texts
            ]
            seq = seq_bucket(max((len(x) for x in id_lists), default=1),
                             self.cfg)
            tokens = np.zeros((n, seq), dtype=np.int32)
            for i, ids in enumerate(id_lists):
                tokens[i, : len(ids)] = ids
            return tokens
        seq = seq_bucket(max((len(t.split()) for t in texts), default=1),
                         self.cfg)
        return batch_tokenize(texts, self.cfg, seq_len=seq)

    def embed(self, texts: Sequence[str]):
        from ..embed.provider import EmbeddingResult

        tokens = torch.from_numpy(self.tokenize(texts))
        vectors = self.model(tokens).cpu().numpy()
        return EmbeddingResult(vectors=vectors, model=self.model_id)
