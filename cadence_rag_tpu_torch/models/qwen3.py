"""The Qwen3-Embedding-4B-shaped encoder, in torch.

Counterpart of ``cadence_rag_tpu/models/qwen3.py``: the config and
presets, the synthetic weights (made on the device through
``models/prng.py``, the JAX package's numbers), the npz checkpoints, the
tokenizers (hash and byte-level BPE), ``encode``, the
``EMBEDDINGS_PROVIDER=qwen3`` provider, and the forward tensor-parallel
over a mesh's ``model`` axis (``param_shardings``, ``ShardedQwen3``,
weights born sharded by ``init_params(..., mesh=)``), JAX's
``encode(..., sharded=True)``.

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
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, models_device, resolve_device
from ..logging_utils import get_logger
from ..ops.hashing import fnv1a64
from ..parallel import tensor as tp
from ..utils import events
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


def _attention(h, w, i, cfg: Qwen3Config, n_heads: int, n_kv: int, sin, cos,
               attn_mask, plain) -> torch.Tensor:
    """Layer ``i``'s attention over ``n_heads`` query and ``n_kv`` key/value
    heads (the weights' own: all of them, or one position's under tensor
    parallelism), through its output product -> (B, S, d_model) f32, the
    residual's addend (a partial to sum over the model axis when sharded)."""
    B, S, _ = h.shape
    groups = n_heads // n_kv
    hd = cfg.head_dim
    q = mm_f32(h, w["wq"][i], plain).reshape(B, S, n_heads, hd)
    k = mm_f32(h, w["wk"][i], plain).reshape(B, S, n_kv, hd)
    v = mm_f32(h, w["wv"][i], plain).reshape(B, S, n_kv, hd)
    v = v.to(torch.bfloat16).transpose(1, 2)                # (B, Hk, S, hd)
    # Qwen3 QK-norm: per-head RMSNorm of q and k before RoPE
    q = _rms_norm(q, w["q_norm"][i], cfg.rms_eps)
    k = _rms_norm(k, w["k_norm"][i], cfg.rms_eps)
    q = _apply_rope(q.transpose(1, 2), sin, cos).to(torch.bfloat16)
    k = _apply_rope(k.transpose(1, 2), sin, cos).to(torch.bfloat16)
    # GQA: each kv head against its group of query heads, q as
    # (B, Hk, G*S, hd), so k and v are never repeated
    qg = q.reshape(B, n_kv, groups * S, hd)
    logits = bmm_f32(qg, k.transpose(-1, -2), plain).reshape(
        B, n_kv, groups, S, S) / math.sqrt(hd)
    logits = torch.where(attn_mask[:, :, None], logits, -1e9)
    weights = torch.softmax(logits, dim=-1).to(torch.bfloat16)
    del logits
    ctx = bmm_f32(weights.reshape(B, n_kv, groups * S, S), v,
                  plain).to(torch.bfloat16)
    ctx = ctx.reshape(B, n_heads, S, hd).transpose(1, 2).reshape(
        B, S, n_heads * hd)
    return mm_f32(ctx, w["wo"][i], plain)


def _mlp(h, w, i, plain) -> torch.Tensor:
    """Layer ``i``'s SwiGLU over the weights' own columns of d_ff -> (B, S,
    d_model) f32, the residual's addend (a partial when sharded)."""
    gate = mm_f32(h, w["w_gate"][i], plain)
    up = mm_f32(h, w["w_up"][i], plain)
    ff = (F.silu(gate) * up).to(torch.bfloat16)
    del gate, up
    return mm_f32(ff, w["w_down"][i], plain)


def _pool(x, final_norm, pad_mask, cfg: Qwen3Config) -> torch.Tensor:
    """The final norm, the last non-pad position pooled, the hidden
    truncated and L2-normalised -> (B, embed_dim) f32."""
    x = _rms_norm(x, final_norm, cfg.rms_eps)
    last = torch.clamp(pad_mask.sum(dim=1) - 1, min=0)
    pooled = x[torch.arange(x.shape[0], device=x.device), last].float()
    out = pooled[:, : cfg.embed_dim]                        # 2560 -> 1024
    return out / torch.clamp(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-6)


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

    def _layer(self, x, w, i, sin, cos, attn_mask, plain):
        cfg = self.cfg
        h = _rms_norm(x, w["ln1"][i], cfg.rms_eps)
        x = x + _attention(h, w, i, cfg, cfg.n_heads, cfg.n_kv_heads, sin, cos,
                           attn_mask, plain).to(torch.bfloat16)
        h = _rms_norm(x, w["ln2"][i], cfg.rms_eps)
        return x + _mlp(h, w, i, plain).to(torch.bfloat16)

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
        w = self.params()
        for i in range(cfg.n_layers):
            x = self._layer(x, w, i, sin, cos, attn_mask, plain)
        return _pool(x, w["final_norm"], pad_mask, cfg)


def encode(model: Qwen3Encoder, token_ids, plain: Optional[bool] = None
           ) -> torch.Tensor:
    """(B, S) int32 -> (B, embed_dim) unit vectors."""
    return model(torch.as_tensor(np.asarray(token_ids)), plain)


def init_params(cfg: Qwen3Config, key: torch.Tensor,
                device: DeviceLike, mesh=None):
    """Synthetic weights, made on ``device`` (8 GB at the 4b preset, never
    on the host): the JAX package's ``init_params(cfg, key)``, value for
    value — each ``w`` is ``normal(bf16) * 1/sqrt(fan_in)`` in bf16, each
    norm scale ones. With ``mesh`` they are born sharded on the mesh's
    devices (``_init_sharded``) -> a ``ShardedQwen3``."""
    if mesh is not None:
        return _init_sharded(cfg, key, mesh)
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
    tensors as uint16 bits named in ``__bf16__``, plus an ``__cfg__`` row of
    the nine integer fields and, where written, a ``__cfg_f__`` row of
    ``rope_theta`` and ``rms_eps`` (a file without it takes their
    defaults). A real checkpoint keeps real token id i at ``tok_emb`` row
    i+1 and row 0 zeros (id 0 is the pad), matching
    ``models/tokenizer.BpeTokenizer``'s +1 shift."""
    with np.load(path, allow_pickle=False) as data:
        v = data["__cfg__"]
        floats = {}
        if "__cfg_f__" in data.files:
            f = data["__cfg_f__"]
            floats = dict(rope_theta=float(f[0]), rms_eps=float(f[1]))
        cfg = Qwen3Config(
            vocab_buckets=int(v[0]), d_model=int(v[1]), n_layers=int(v[2]),
            n_heads=int(v[3]), n_kv_heads=int(v[4]), head_dim=int(v[5]),
            d_ff=int(v[6]), max_len=int(v[7]), embed_dim=int(v[8]), **floats,
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
    # the two float fields ride in a key of their own, written where they
    # differ from the defaults, so a default config's file is the JAX
    # package's, key for key
    if (cfg.rope_theta, cfg.rms_eps) != (Qwen3Config.rope_theta,
                                         Qwen3Config.rms_eps):
        flat["__cfg_f__"] = np.array([cfg.rope_theta, cfg.rms_eps],
                                     dtype=np.float64)
    np.savez(path, **flat)


# ---------------------------------------------------- tensor parallelism ----

def _kv_layout(cfg: Qwen3Config, n: int) -> tp.Layout:
    """The key/value columns each model index holds: the heads its query
    columns use (JAX's contiguous cut of ``wq``). Where the model axis is
    wider than the key/value heads, a head is replicated to every index
    whose query heads use it (Megatron's rule when tp exceeds the kv
    heads); JAX's own cut would give a position part of a head."""
    hd, groups = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    q_cols = cfg.q_dim // n
    ranges = []
    for m in range(n):
        first_q = (m * q_cols) // hd
        last_q = -(-((m + 1) * q_cols) // hd) - 1
        ranges.append(((first_q // groups * hd, (last_q // groups + 1) * hd),))
    return tp.Layout(2, tuple(ranges))


def param_shardings(cfg: Qwen3Config, mesh) -> Dict[str, tp.Layout]:
    """JAX's Megatron layout over the stacked (L, ...) weights and the
    ``model`` axis: ``tok_emb`` split by vocab; ``wq``, ``w_gate`` and
    ``w_up`` column-parallel (their output columns cut in contiguous
    pieces); ``wk`` and ``wv`` the key/value heads of each index's query
    columns (``_kv_layout``); ``wo`` and ``w_down`` row-parallel (input
    rows); the norms replicated. The ``data`` axis replicates every
    weight."""
    n = mesh.axis_size("model")
    kv = _kv_layout(cfg, n)
    return {
        "tok_emb": tp.split(cfg.vocab_buckets, 0, n),
        "ln1": tp.Layout(), "ln2": tp.Layout(),
        "q_norm": tp.Layout(), "k_norm": tp.Layout(),
        "wq": tp.split(cfg.q_dim, 2, n),
        "wk": kv, "wv": kv,
        "wo": tp.split(cfg.q_dim, 1, n),
        "w_gate": tp.split(cfg.d_ff, 2, n),
        "w_up": tp.split(cfg.d_ff, 2, n),
        "w_down": tp.split(cfg.d_ff, 1, n),
        "final_norm": tp.Layout(),
    }


class ShardedQwen3:
    """The encoder tensor-parallel over ``mesh``: each position holds its
    shards of the weights (``param_shardings``) and its rows of the batch
    (the batch split over ``data``, as JAX's ``P("data", None, None)``
    constrains the activations; there is no sequence parallelism). Each
    layer runs the column-parallel products, QK-norm, RoPE and attention
    over the position's own heads, then the row-parallel products as f32
    partials summed over the ``model`` group before the cast to bf16, where
    GSPMD sums JAX's ``preferred_element_type=f32`` partials. Positions on
    one device share the replicated activations (``tp.each``)."""

    def __init__(self, cfg: Qwen3Config, mesh, params: tp.ShardedParams):
        self.cfg = cfg
        self.mesh = mesh
        self.params = params

    def heads(self) -> Tuple[int, int]:
        """(query heads, key/value heads) of a position. The forward needs
        whole query heads on each: a model axis wider than the query heads
        (the tiny preset over ``model:8``) holds the weights, and raises
        here."""
        cfg, n = self.cfg, self.mesh.axis_size("model")
        if cfg.n_heads % n:
            raise ValueError(f"{cfg.n_heads} query heads do not split over a "
                             f"model axis of {n}")
        (kv,) = self.params.layouts["wk"].ranges[0]
        q_heads, kv_heads = cfg.n_heads // n, (kv[1] - kv[0]) // cfg.head_dim
        if q_heads % kv_heads:
            raise ValueError(f"{q_heads} query heads a position do not group "
                             f"over its {kv_heads} key/value heads")
        return q_heads, kv_heads

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def groups(self) -> List[List[int]]:
        """One model group per data index: its positions, in model order."""
        return [self.mesh.model_group(self.mesh.shard_positions(d)[0])
                for d in range(self.mesh.axis_size("data"))]

    def _embed(self, group, token_ids):
        ids = tp.replicate(token_ids, self.mesh, group)
        vocab = self.params.layouts["tok_emb"]
        parts = {pos: tp.vocab_rows(self.params.at(pos)["tok_emb"],
                                  vocab.ranges[self.mesh.axis_index(pos, "model")][0][0],
                                  ids[pos])
                 for pos in group}
        return tp.all_reduce(parts, self.mesh)

    def _group_forward(self, group, token_ids, plain):
        cfg, mesh = self.cfg, self.mesh
        B, S = token_ids.shape
        w = {pos: self.params.at(pos) for pos in group}
        pad = tp.replicate(token_ids != 0, mesh, group)
        tables = {}
        for pos in group:
            dev = mesh.devices[pos]
            if dev not in tables:
                sin, cos = _rope_tables(S, cfg.head_dim, cfg.rope_theta, dev)
                causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
                tables[dev] = (sin, cos, causal[None, None] & pad[pos][:, None, None, :])
        x = self._embed(group, token_ids)
        q_heads, kv_heads = self.heads()
        for i in range(cfg.n_layers):
            h = tp.each(x, lambda pos, t: _rms_norm(t, w[pos]["ln1"][i], cfg.rms_eps))
            parts = {pos: _attention(h[pos], w[pos], i, cfg, q_heads, kv_heads,
                                     *tables[mesh.devices[pos]], plain)
                     for pos in group}
            attn = tp.all_reduce(parts, mesh)
            del parts
            x = tp.each(x, lambda pos, t: t + attn[pos].to(torch.bfloat16))
            h = tp.each(x, lambda pos, t: _rms_norm(t, w[pos]["ln2"][i], cfg.rms_eps))
            parts = {pos: _mlp(h[pos], w[pos], i, plain) for pos in group}
            ff = tp.all_reduce(parts, mesh)
            del parts, h
            x = tp.each(x, lambda pos, t: t + ff[pos].to(torch.bfloat16))
        first = group[0]
        return _pool(x[first], w[first]["final_norm"], pad[first], cfg)

    @torch.inference_mode()
    def forward(self, token_ids: torch.Tensor, plain: Optional[bool] = None
                ) -> torch.Tensor:
        """(B, S) ids, B a multiple of the ``data`` size -> (B, embed_dim)
        unit vectors on the first position's device."""
        token_ids = torch.as_tensor(np.asarray(token_ids)).to(torch.int64)
        groups = self.groups()
        if token_ids.shape[0] % len(groups):
            raise ValueError(f"batch {token_ids.shape[0]} does not split over "
                             f"the data axis ({len(groups)})")
        rows = token_ids.shape[0] // len(groups)
        outs = {}
        for d, group in enumerate(groups):
            dev = self.mesh.devices[group[0]]
            ids = token_ids[d * rows:(d + 1) * rows].to(dev)
            outs[group[0]] = self._group_forward(group, ids, use_plain(ids, plain))
        return tp.all_gather(outs, self.mesh, 0)[min(outs)]

    __call__ = forward


def _init_sharded(cfg: Qwen3Config, key: torch.Tensor, mesh) -> ShardedQwen3:
    """``init_params(cfg, key)`` born sharded over ``mesh``: each position's
    shard is drawn alone (``prng.normal(index=)``), so no device holds a
    whole sharded weight: JAX's ``init_params(shardings=)``."""
    layouts = param_shardings(cfg, mesh)
    specs = {name: (shape, kind, k) for (name, shape, kind), k in zip(
        _param_specs(cfg), prng.split(key, len(_param_specs(cfg))))}
    shapes = {name: shape for name, (shape, _kind, _k) in specs.items()}

    def make(name, m, dev):
        shape, kind, k = specs[name]
        blocks = layouts[name].block(shape, m)
        if kind == "ones":
            (block,) = blocks
            return torch.ones(prng._block_shape(shape, block), dtype=torch.float32,
                              device=dev)
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        pieces = [prng.normal(k, shape, torch.bfloat16, dev,
                              scale=float(1.0 / np.sqrt(fan_in)), index=block)
                  for block in blocks]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces,
                                                            dim=layouts[name].dim)

    params = tp.ShardedParams(mesh, layouts, shapes).fill(make)
    return ShardedQwen3(cfg, mesh, params)


def shard_params(model: Qwen3Encoder, mesh) -> ShardedQwen3:
    """The encoder's weights (seeded, loaded, or carried from JAX with
    ``from_jax_params``) laid over ``mesh``."""
    params = tp.ShardedParams.shard(mesh, param_shardings(model.cfg, mesh),
                                    model.params())
    return ShardedQwen3(model.cfg, mesh, params)


def gather_params(sharded: ShardedQwen3, device: Optional[DeviceLike] = None
                  ) -> Qwen3Encoder:
    """The whole encoder from its shards, on ``device`` (default: the first
    position's): ``shard_params``' inverse."""
    device = sharded.device if device is None else resolve_device(device)
    model = Qwen3Encoder(sharded.cfg, device)
    load_flat(model, sharded.params.gather(device=device))
    return model


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
        self.settings_key = _settings_key()

    @classmethod
    def shared(cls) -> "Qwen3EmbeddingProvider":
        """The process's provider, made anew when the models' device or the
        settings it was made from (preset, checkpoint, tokenizer) change."""
        if (cls._instance is None or cls._instance.device != models_device()
                or cls._instance.settings_key != _settings_key()):
            cls._instance = None        # the old weights go before the new load
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
        """``encode``'s vectors, rounded to bfloat16 once (the comment at
        the rounding says why). While the event ring is on, each call
        records one ``embed.encode``: ``batch``, ``seq`` (the bucket),
        ``tokens`` (real positions), ``positions`` (batch x seq), ``pairs``
        (the causal (query, key) pairs of the real positions, sum of
        t(t+1)/2), ``tokenize_s``, ``host_s`` (the whole call) and on CUDA
        ``device_s``: timing events around the forward on its stream, read
        after the output's copy to the host, which waits for them anyway."""
        from ..embed.provider import EmbeddingResult

        trace = events.enabled()
        if trace:
            t0 = time.monotonic()
        ids = self.tokenize(texts)
        if trace:
            tokenize_s = time.monotonic() - t0
            start = end = None
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
        out = self.model(torch.from_numpy(ids))
        if trace and end is not None:
            end.record(stream)
        # the vectors leave in the model's bfloat16: the index scores a
        # query in bfloat16 and its packed upload carries it as float16,
        # which holds a bfloat16 value of |x| >= 2^-17 exactly, so the card
        # scores this value and not a second rounding of a float16 one
        vectors = out.to(torch.bfloat16).float().cpu().numpy()
        if trace:
            lengths = (ids != 0).sum(axis=1).astype(np.int64)
            fields = dict(batch=int(ids.shape[0]), seq=int(ids.shape[1]),
                          tokens=int(lengths.sum()), positions=int(ids.size),
                          pairs=int((lengths * (lengths + 1) // 2).sum()),
                          tokenize_s=round(tokenize_s, 6),
                          host_s=round(time.monotonic() - t0, 6))
            if start is not None:
                fields["device_s"] = round(start.elapsed_time(end) / 1e3, 6)
            events.record("embed.encode", **fields)
        return EmbeddingResult(vectors=vectors, model=self.model_id)


def _settings_key() -> tuple:
    from ..config import settings

    return (settings.qwen3_preset, settings.qwen3_params_path,
            settings.qwen3_tokenizer_path)
