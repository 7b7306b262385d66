"""The neural text embedder, in torch.

Counterpart of ``cadence_rag_tpu/models/embedder.py``: the config, the hash
tokenizer, the seeded initial weights (``models/prng.py`` reproduces
``jax.random``), the forward pass, the contrastive training step (InfoNCE,
AdamW), the npz checkpoints, the ``EMBEDDINGS_PROVIDER=neural`` provider,
and the model dp+tp over a mesh (``param_shardings``, ``ShardedEmbedder``,
``sharded_train_step``: JAX's ``sharded=True``). The vector contract is the JAX
package's: a causal transformer, last-token pooling, the hidden projected to
``embed_dim`` and mixed with a frozen hash-bag head, L2 normalised.

Precision. Every product the JAX package takes with bf16 operands and an f32
result (``preferred_element_type=f32``) runs here one of two ways:

- the plain path (``plain=True``; the default on the CPU): f32 arithmetic
  on bf16-rounded operands. Each product of two bf16 values is exact in
  f32, so it matches JAX up to summation order;
- the card path (the default on CUDA): bf16 tensor-core GEMMs with an f32
  output (``torch.mm``/``torch.bmm`` with ``out_dtype``).

Layer norms, softmax, GELU and the bag term run in f32 on both.

Training. Autograd over the same forward takes the place of
``jax.value_and_grad``. The plain path's gradients are the reference: each
cast's backward rounds the cotangent to bf16, as the transpose of JAX's
``convert_element_type`` does. The card path's products carry their own
backward (``F32Product``): the cotangent rounded to bf16 times the other
bf16 operand, a bf16 GEMM with an f32 result, rounded to bf16. With
``freeze_bag`` the bag and the mixture get no gradient (JAX's
``stop_gradient``), but AdamW updates every leaf, so weight decay still
shrinks them, as it does in the JAX package: ``tuned_small_v1.npz`` stores
``mix`` = [0.9851036, 0.4925518], the initial [1.0, 0.5] decayed. The
scale cancels in the final normalisation; the saved bytes do not.

Checkpoints are the JAX package's npz files, keyed by JAX tree paths
(``"['blocks']/[0]/['ln1']/['bias']"``): a file saved by either package
loads in the other. A frozen bag head is not stored; loading regenerates it
from ``(cfg, init_seed)``, on the model's device.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, models_device, resolve_device
from ..ops.hashing import fnv1a64
from ..parallel import tensor as tp
from . import prng

# --------------------------------------------------------------- config ----


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    vocab_buckets: int = 32768
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1024
    max_len: int = 128
    embed_dim: int = 1024          # output dim (truncation target)
    # residual hash-bag head, frozen: see the JAX package's config
    use_bag: bool = True
    bag_init_scale: float = 1.0    # bag mixture weight at init
    tfm_init_scale: float = 0.5    # transformer mixture weight at init
    freeze_bag: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ------------------------------------------------------------ tokenizer ----

def hash_tokenize(text: str, cfg: EmbedderConfig) -> np.ndarray:
    """Word-level FNV-1a hashing into vocab buckets; ids are 1-based
    (0 = pad). Deterministic, no external vocab."""
    ids: List[int] = []
    for word in text.lower().split():
        h = fnv1a64(b"tok:" + word.encode("utf-8"))
        ids.append(int(h % (cfg.vocab_buckets - 1)) + 1)
        if len(ids) >= cfg.max_len:
            break
    return np.asarray(ids, dtype=np.int32)


def batch_tokenize(texts: Sequence[str], cfg: EmbedderConfig) -> np.ndarray:
    batch = np.zeros((len(texts), cfg.max_len), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = hash_tokenize(text, cfg)
        batch[i, : len(ids)] = ids
    return batch


# ------------------------------------------------- products and trees ----

class F32Product(torch.autograd.Function):
    """``a @ b`` of bf16 operands with an f32 result on the card: one bf16
    GEMM (``torch.mm``/``torch.bmm`` with ``out_dtype``) for 2-d or 3-d
    operands. Its backward is the JAX package's dot transpose on the card:
    each operand's cotangent is the f32 cotangent rounded to bf16 times the
    other bf16 operand, a bf16 GEMM with an f32 result, rounded to bf16
    (the operand's type)."""

    @staticmethod
    def forward(ctx, a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a16, b16)
        product = torch.mm if a16.dim() == 2 else torch.bmm
        return product(a16, b16, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a16, b16 = ctx.saved_tensors
        product = torch.mm if a16.dim() == 2 else torch.bmm
        g16 = grad.to(torch.bfloat16)
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = product(g16, b16.transpose(-1, -2),
                             out_dtype=torch.float32).to(torch.bfloat16)
        if ctx.needs_input_grad[1]:
            grad_b = product(a16.transpose(-1, -2), g16,
                             out_dtype=torch.float32).to(torch.bfloat16)
        return grad_a, grad_b


def mm_f32(a: torch.Tensor, b: torch.Tensor, plain: bool) -> torch.Tensor:
    """``(..., K) @ (K, N)`` of bf16-rounded operands with an f32 result."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if plain:
        return a16.float() @ b16.float()
    out = F32Product.apply(a16.reshape(-1, a.shape[-1]), b16)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def bmm_f32(a: torch.Tensor, b: torch.Tensor, plain: bool) -> torch.Tensor:
    """Batched ``(..., M, K) @ (..., K, N)`` of bf16-rounded operands with
    an f32 result."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if plain:
        return a16.float() @ b16.float()
    lead = a.shape[:-2]
    out = F32Product.apply(a16.reshape(-1, *a.shape[-2:]),
                           b16.reshape(-1, *b.shape[-2:]))
    return out.reshape(*lead, *out.shape[-2:])


def use_plain(x: torch.Tensor, plain: Optional[bool]) -> bool:
    """The plain path unless asked otherwise on a CUDA tensor."""
    return x.device.type != "cuda" if plain is None else bool(plain)


def jax_path(name: str) -> str:
    """A module's parameter name -> the JAX tree path the npz files use
    (``blocks.0.ln1.bias`` -> ``['blocks']/[0]/['ln1']/['bias']``)."""
    return "/".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                    for p in name.split("."))


def module_name(path: str) -> str:
    """The inverse of ``jax_path``."""
    return ".".join(re.findall(r"\['?([^'\]]+)'?\]", path))


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested dict/list of arrays (the JAX package's params) ->
    {module name: array}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten_tree(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _tensor(value: Any) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.tensor(np.asarray(value))


def _frozen(value: Any, device: torch.device) -> nn.Parameter:
    return nn.Parameter(_tensor(value).to(device), requires_grad=False)


def load_flat(module: nn.Module, flat: Mapping[str, Any]) -> None:
    """Fill ``module``'s parameters from {module name: array}; every
    parameter must be given, with its shape."""
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"parameters missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, param in own.items():
            value = _tensor(flat[name])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                 f"expected {tuple(param.shape)}")
            param.copy_(value.to(param.dtype))


# ---------------------------------------------------------------- model ----

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """Biased variance, eps 1e-5, f32 (the JAX package's ``_layer_norm``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale + bias


class LayerNorm(nn.Module):
    """``layer_norm`` with its scale and bias."""

    def __init__(self, dim: int, device: torch.device):
        super().__init__()
        self.scale = _frozen(torch.ones(dim), device)
        self.bias = _frozen(torch.zeros(dim), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


def attention(h: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor,
              n_heads: int, mask: torch.Tensor, plain: bool) -> torch.Tensor:
    """Causal attention of the layer-normed ``h`` over ``n_heads`` heads,
    ``wqkv`` being ``[q | k | v]`` of those heads' columns, through the
    output product -> (B, L, d_model) f32, the residual's addend (a partial
    to sum over the model axis when the heads are one position's)."""
    batch, seq, _ = h.shape
    width = wqkv.shape[1] // 3
    head_dim = width // n_heads
    qkv = mm_f32(h, wqkv, plain)
    q, k, v = (t.reshape(batch, seq, n_heads, head_dim).transpose(1, 2)
               for t in qkv.split(width, dim=-1))
    logits = bmm_f32(q, k.transpose(-1, -2), plain) / math.sqrt(head_dim)
    causal = torch.ones(seq, seq, dtype=torch.bool, device=h.device).tril()
    attn_mask = causal[None, None] & mask[:, None, None, :]
    logits = torch.where(attn_mask, logits, -1e9)
    weights = torch.softmax(logits, dim=-1)
    ctx = bmm_f32(weights, v, plain)
    ctx = ctx.transpose(1, 2).reshape(batch, seq, width)
    return mm_f32(ctx, wo, plain)


def mlp(h: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
        plain: bool) -> torch.Tensor:
    """The GELU MLP of the layer-normed ``h`` over ``w_in``'s columns ->
    (B, L, d_model) f32 (a partial when the columns are one position's)."""
    ff = F.gelu(mm_f32(h, w_in, plain), approximate="tanh")
    return mm_f32(ff, w_out, plain)


class Block(nn.Module):
    """Pre-LN attention + GELU MLP; the attention is always causal (the
    reranker shares this block, as in the JAX package)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 device: torch.device):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = LayerNorm(d_model, device)
        self.wqkv = _frozen(torch.zeros(d_model, 3 * d_model), device)
        self.wo = _frozen(torch.zeros(d_model, d_model), device)
        self.ln2 = LayerNorm(d_model, device)
        self.w_in = _frozen(torch.zeros(d_model, d_ff), device)
        self.w_out = _frozen(torch.zeros(d_ff, d_model), device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                plain: bool) -> torch.Tensor:
        x = x + attention(self.ln1(x), self.wqkv, self.wo, self.n_heads, mask,
                          plain)
        return x + mlp(self.ln2(x), self.w_in, self.w_out, plain)


class Encoder(nn.Module):
    """Token and position embeddings, the blocks and the final layer norm,
    with the JAX package's parameter tree (shared with the reranker)."""

    def __init__(self, cfg: EmbedderConfig, device: DeviceLike):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.tok_emb = _frozen(torch.zeros(cfg.vocab_buckets, cfg.d_model), device)
        self.pos_emb = _frozen(torch.zeros(cfg.max_len, cfg.d_model), device)
        self.final_ln = LayerNorm(cfg.d_model, device)
        self.out_proj = _frozen(torch.zeros(cfg.d_model, cfg.embed_dim), device)
        self.blocks = nn.ModuleList(
            Block(cfg.d_model, cfg.n_heads, cfg.d_ff, device)
            for _ in range(cfg.n_layers))
        if cfg.use_bag:
            self.bag_emb = _frozen(
                torch.zeros(cfg.vocab_buckets, cfg.embed_dim), device)
            self.mix = _frozen(torch.zeros(2), device)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def hidden(self, token_ids: torch.Tensor, plain: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (final-layer-normed hidden (B, L, d) f32, pad mask (B, L))."""
        mask = token_ids != 0
        x = self.tok_emb[token_ids] + self.pos_emb[None, : token_ids.shape[1]]
        for block in self.blocks:
            x = block(x, mask, plain)
        return self.final_ln(x), mask

    def tree(self) -> Dict[str, torch.Tensor]:
        """{JAX tree path: tensor} of every parameter."""
        return {jax_path(n): p.detach() for n, p in self.named_parameters()}


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


class Embedder(Encoder):
    """(B, L) int token ids -> (B, embed_dim) unit vectors."""

    def vectors(self, token_ids: torch.Tensor,
                plain: Optional[bool] = None) -> torch.Tensor:
        """The forward pass, differentiable (``forward`` runs it under
        ``torch.inference_mode``)."""
        token_ids = token_ids.to(self.device, torch.int64)
        plain = use_plain(token_ids, plain)
        x, mask = self.hidden(token_ids, plain)
        pooled = last_token(x, mask)
        out = mm_f32(pooled, self.out_proj, plain)
        if self.cfg.use_bag:
            return mix_bag(out, self.bag_emb[token_ids], mask, self.mix, self.cfg)
        return _unit(out)

    @torch.inference_mode()
    def forward(self, token_ids: torch.Tensor,
                plain: Optional[bool] = None) -> torch.Tensor:
        return self.vectors(token_ids, plain)


def last_token(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Last-token pooling: each row's final non-pad position."""
    lengths = torch.clamp(mask.sum(dim=1) - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), lengths]


def mix_bag(out: torch.Tensor, bag_rows: torch.Tensor, mask: torch.Tensor,
            mix: torch.Tensor, cfg: EmbedderConfig) -> torch.Tensor:
    """The bag head: the mean of the tokens' bag rows (``bag_rows`` (B, L,
    embed_dim)), unit, mixed with the unit transformer output, unit."""
    if cfg.freeze_bag:
        # the lexical prior stays fixed: no gradient (JAX's stop_gradient);
        # AdamW still decays both
        bag_rows, mix = bag_rows.detach(), mix.detach()
    counts = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    bag = (mask[..., None].float() * bag_rows).sum(dim=1)
    bag = _unit(bag / counts)
    return _unit(mix[0] * bag + mix[1] * _unit(out))


def encode(model: Embedder, token_ids, plain: Optional[bool] = None
           ) -> torch.Tensor:
    """(B, L) int32 -> (B, embed_dim) unit vectors (last-token pooled)."""
    return model(torch.as_tensor(np.asarray(token_ids)), plain)


# --------------------------------------------------------------- params ----

def _init_makers(cfg: EmbedderConfig, key: torch.Tensor, device: torch.device
                 ) -> Dict[str, Any]:
    """{module name: () -> tensor}: the JAX package's ``init_params``, leaf
    by leaf, so a loader can draw only the leaves a file lacks."""
    keys = prng.split(key, 4 + cfg.n_layers)
    scale = 0.02

    def normal(k, shape, s=None):
        return lambda: prng.normal(k, shape, torch.float32, device, scale=s)

    def const(shape, value):
        return lambda: torch.full(shape, value, dtype=torch.float32, device=device)

    makers: Dict[str, Any] = {
        "tok_emb": normal(keys[0], (cfg.vocab_buckets, cfg.d_model), scale),
        "pos_emb": normal(keys[1], (cfg.max_len, cfg.d_model), scale),
        "final_ln.scale": const((cfg.d_model,), 1.0),
        "final_ln.bias": const((cfg.d_model,), 0.0),
        "out_proj": normal(keys[2], (cfg.d_model, cfg.embed_dim), scale),
    }
    if cfg.use_bag:
        # unit-gaussian rows: at init the bag term IS the hash stub
        makers["bag_emb"] = normal(keys[3], (cfg.vocab_buckets, cfg.embed_dim))
        makers["mix"] = lambda: torch.tensor(
            [cfg.bag_init_scale, cfg.tfm_init_scale], dtype=torch.float32,
            device=device)
    for i in range(cfg.n_layers):
        bkey = prng.split(keys[4 + i], 6)
        d, f = cfg.d_model, cfg.d_ff
        makers.update({
            f"blocks.{i}.ln1.scale": const((d,), 1.0),
            f"blocks.{i}.ln1.bias": const((d,), 0.0),
            f"blocks.{i}.wqkv": normal(bkey[0], (d, 3 * d), scale),
            f"blocks.{i}.wo": normal(bkey[1], (d, d), scale),
            f"blocks.{i}.ln2.scale": const((d,), 1.0),
            f"blocks.{i}.ln2.bias": const((d,), 0.0),
            f"blocks.{i}.w_in": normal(bkey[2], (d, f), scale),
            f"blocks.{i}.w_out": normal(bkey[3], (f, d), scale),
        })
    return makers


def init_params(cfg: EmbedderConfig, key: torch.Tensor,
                device: DeviceLike) -> Embedder:
    """The JAX package's ``init_params(cfg, key)``, made on ``device``."""
    device = resolve_device(device)
    model = Embedder(cfg, device)
    load_flat(model, {n: make() for n, make in
                      _init_makers(cfg, key, device).items()})
    return model


def from_jax_params(params: Mapping[str, Any], cfg: EmbedderConfig,
                    device: DeviceLike) -> Embedder:
    """The embedder from the JAX package's parameter tree (numpy leaves)."""
    model = Embedder(cfg, device)
    load_flat(model, flatten_tree(params))
    return model


# ------------------------------------------------------------- training ----

def tokens_on(model: nn.Module, token_ids) -> torch.Tensor:
    """Token ids (numpy or a tensor) as int64 on the model's device."""
    if not isinstance(token_ids, torch.Tensor):
        token_ids = torch.from_numpy(np.asarray(token_ids))
    return token_ids.to(model.device, torch.int64)


def info_nce_loss(model: Embedder, anchors, positives,
                  temperature: float = 0.05, *, negatives=None,
                  plain: Optional[bool] = None) -> torch.Tensor:
    """InfoNCE with in-batch negatives; ``negatives`` (B, L) adds one
    explicit hard negative per anchor as a second logit block. The three
    token blocks go through one forward pass (the rows are independent).
    A ``ShardedEmbedder`` takes the dp+tp loss (JAX's ``sharded=True``)."""
    if isinstance(model, ShardedEmbedder):
        return _sharded_info_nce(model, anchors, positives, temperature,
                                 negatives, plain)
    blocks = [tokens_on(model, anchors), tokens_on(model, positives)]
    if negatives is not None:
        blocks.append(tokens_on(model, negatives))
    batch = blocks[0].shape[0]
    z = model.vectors(torch.cat(blocks), plain)
    za, zp = z[:batch], z[batch:2 * batch]
    logits = za @ zp.T  # in-batch negatives
    if negatives is not None:
        logits = torch.cat([logits, za @ z[2 * batch:].T], dim=1)
    logits = logits / temperature
    return torch.mean(-torch.log_softmax(logits, dim=-1).diagonal())


def named_leaves(params) -> Dict[str, torch.Tensor]:
    """A module's parameters, or a {name: tensor} dict, as {name: tensor}."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments for every leaf of ``params`` (a module or a {name:
    tensor} dict) and an int32 step counter, on the leaves' device."""
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device
    return {"mu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in leaves.items()},
            "nu": {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in leaves.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_from_jax(opt_state: Mapping[str, Any], device: DeviceLike
                       ) -> Dict[str, Any]:
    """The JAX package's AdamW state (numpy leaves) as the port's, keyed by
    module names (``from_jax_params``' counterpart for the optimizer)."""
    device = resolve_device(device)

    def leaves(tree):
        return {n: _tensor(v).to(device, torch.float32)
                for n, v in flatten_tree(tree).items()}

    return {"mu": leaves(opt_state["mu"]), "nu": leaves(opt_state["nu"]),
            "step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads: Mapping[str, Optional[torch.Tensor]],
                 opt_state: Dict[str, Any], lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
    """The JAX package's AdamW, in place, on every leaf of ``params`` (a
    module or a {name: tensor} dict): bias-corrected moments, ``eps``
    outside the square root, ``weight_decay * p`` inside the ``lr``
    product. A leaf without a gradient (None) takes a zero one, so it is
    still decayed, as in JAX. Each step is JAX's f32 operations in JAX's
    order. -> (params, opt_state)"""
    leaves = named_leaves(params)
    names = list(leaves)
    p = [leaves[n] for n in names]
    g = [grads.get(n) if grads.get(n) is not None else torch.zeros_like(leaves[n])
         for n in names]
    mu = [opt_state["mu"][n] for n in names]
    nu = [opt_state["nu"][n] for n in names]
    f32 = lambda x: float(np.float32(x))
    step = opt_state["step"] + 1
    # mu = b1 * m + (1 - b1) * g;  nu = b2 * v + (1 - b2) * g * g
    torch._foreach_mul_(mu, f32(b1))
    torch._foreach_add_(mu, torch._foreach_mul(g, f32(1 - b1)))
    torch._foreach_mul_(nu, f32(b2))
    g2 = torch._foreach_mul(g, f32(1 - b2))
    torch._foreach_mul_(g2, g)
    torch._foreach_add_(nu, g2)
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    mu_hat_scale = one / (one - torch.tensor(f32(b1), device=t.device) ** t)
    nu_hat_scale = one / (one - torch.tensor(f32(b2), device=t.device) ** t)
    # p - lr * (m * mu_hat_scale / (sqrt(v * nu_hat_scale) + eps) + wd * p)
    den = torch._foreach_mul(nu, nu_hat_scale)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, f32(eps))
    upd = torch._foreach_mul(mu, mu_hat_scale)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(upd, torch._foreach_mul(p, f32(weight_decay)))
    torch._foreach_mul_(upd, f32(lr))
    torch._foreach_sub_(p, upd)
    opt_state["step"] = step
    return params, opt_state


def trainable(model: nn.Module) -> nn.Module:
    """Every parameter of ``model`` asks for gradients (the serving path's
    numbers do not change: ``forward`` runs under inference mode)."""
    for param in model.parameters():
        param.requires_grad_(True)
    return model


def gradients(model: nn.Module, loss: torch.Tensor
              ) -> Dict[str, Optional[torch.Tensor]]:
    """{name: the gradient of ``loss``} for every leaf that asks for one;
    None where ``loss`` does not depend on the leaf (JAX's zero)."""
    leaves = {n: p for n, p in model.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return dict(zip(leaves, grads))


def apply_gradients(model: nn.Module, opt_state: Dict[str, Any],
                    loss: torch.Tensor, lr: float) -> None:
    """The gradient of ``loss`` for every leaf, then ``adamw_update``."""
    adamw_update(model, gradients(model, loss), opt_state, lr=lr)


def train_step(model: Embedder, opt_state: Dict[str, Any], anchors, positives,
               *, negatives=None, lr: float = 1e-4,
               plain: Optional[bool] = None):
    """One InfoNCE step: the loss, its gradient for every leaf and an AdamW
    update, in place. -> (model, opt_state, loss (a 0-dim tensor)). A
    ``ShardedEmbedder`` (``shard_params(model, mesh)``) takes one dp+tp
    step (``sharded_train_step``), JAX's ``train_step(..., sharded=True)``."""
    if isinstance(model, ShardedEmbedder):
        return sharded_train_step(model, opt_state, anchors, positives,
                                  negatives=negatives, lr=lr, plain=plain)
    trainable(model)
    loss = info_nce_loss(model, anchors, positives, negatives=negatives,
                         plain=plain)
    apply_gradients(model, opt_state, loss, lr)
    return model, opt_state, loss.detach()


# ---------------------------------------------------- tensor parallelism ----

def param_shardings(cfg: EmbedderConfig, mesh) -> Dict[str, tp.Layout]:
    """JAX's Megatron layout over the ``model`` axis (``embedder.py``'s
    ``param_shardings``), by module name: ``w_in`` and ``out_proj``
    column-parallel, ``wo`` and ``w_out`` row-parallel, ``tok_emb`` and
    ``bag_emb`` split by vocab (a masked lookup, the partials summed),
    ``pos_emb``, the layer norms and ``mix`` replicated; the ``data`` axis
    replicates every weight.

    The fused ``wqkv`` (d, 3d) is JAX's ``P(None, "model")``, a contiguous
    cut of the ``[q | k | v]`` columns, which does not fall along heads:
    model index ``m`` of ``n`` would hold columns ``[m*3d/n, (m+1)*3d/n)``.
    The port lays it out by heads instead: index ``m`` holds its heads'
    slice of each of q, k and v, ``[q_m | k_m | v_m]``, with ``q_m`` the
    columns ``[m*d/n, (m+1)*d/n)`` (heads ``m*H/n ..``) and ``k_m``, ``v_m``
    the same columns of their thirds, so its attention is local.
    ``gather_params`` puts the thirds back into JAX's (d, 3d) matrix."""
    n = mesh.axis_size("model")
    if cfg.n_heads % n:
        raise ValueError(f"{cfg.n_heads} heads do not split over a model axis of {n}")
    d, f = cfg.d_model, cfg.d_ff
    out = {
        "tok_emb": tp.split(cfg.vocab_buckets, 0, n),
        "pos_emb": tp.Layout(),
        "final_ln.scale": tp.Layout(), "final_ln.bias": tp.Layout(),
        "out_proj": tp.split(cfg.embed_dim, 1, n),
    }
    for i in range(cfg.n_layers):
        out.update({
            f"blocks.{i}.ln1.scale": tp.Layout(), f"blocks.{i}.ln1.bias": tp.Layout(),
            f"blocks.{i}.wqkv": tp.split(3 * d, 1, n, pieces=3),
            f"blocks.{i}.wo": tp.split(d, 0, n),
            f"blocks.{i}.ln2.scale": tp.Layout(), f"blocks.{i}.ln2.bias": tp.Layout(),
            f"blocks.{i}.w_in": tp.split(f, 1, n),
            f"blocks.{i}.w_out": tp.split(f, 0, n),
        })
    if cfg.use_bag:
        out["bag_emb"] = tp.split(cfg.vocab_buckets, 0, n)
        out["mix"] = tp.Layout()
    return out


class ShardedEmbedder:
    """The embedder dp+tp over ``mesh``: each position holds its shards of
    the weights (``param_shardings``) and its rows of the batch, split over
    ``data`` (JAX's ``with_sharding_constraint(x, P("data", None, None))``
    shards the batch, not the sequence). A layer runs the position's heads
    and ``w_in`` columns; the row-parallel products are f32 partials summed
    over the ``model`` group; ``out_proj``'s column slices are gathered over
    it. The forward is differentiable: one autograd graph spans every
    position (``parallel/tensor.py``)."""

    def __init__(self, cfg: EmbedderConfig, mesh, params: tp.ShardedParams):
        self.cfg = cfg
        self.mesh = mesh
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def groups(self) -> List[List[int]]:
        """One model group per data index: its positions, in model order."""
        return [self.mesh.model_group(self.mesh.shard_positions(d)[0])
                for d in range(self.mesh.axis_size("data"))]

    def _lookup(self, name: str, group, ids) -> Dict[int, torch.Tensor]:
        first = self.params.layouts[name].ranges
        return tp.all_reduce({
            pos: tp.vocab_rows(self.params.at(pos)[name],
                               first[self.mesh.axis_index(pos, "model")][0][0], ids[pos])
            for pos in group}, self.mesh)

    def group_vectors(self, group: List[int], token_ids: torch.Tensor,
                      plain: bool) -> torch.Tensor:
        """One model group's rows of the batch -> (b, embed_dim) unit
        vectors on the group's first device."""
        cfg, mesh = self.cfg, self.mesh
        w = {pos: self.params.at(pos) for pos in group}
        heads = cfg.n_heads // mesh.axis_size("model")
        ids = tp.replicate(token_ids, mesh, group)
        mask = tp.replicate(token_ids != 0, mesh, group)
        x = tp.each(self._lookup("tok_emb", group, ids), lambda pos, t: (
            t + w[pos]["pos_emb"][None, : token_ids.shape[1]]))
        for i in range(cfg.n_layers):
            b = f"blocks.{i}."
            h = tp.each(x, lambda pos, t: layer_norm(
                t, w[pos][b + "ln1.scale"], w[pos][b + "ln1.bias"]))
            attn = tp.all_reduce({pos: attention(
                h[pos], w[pos][b + "wqkv"], w[pos][b + "wo"], heads, mask[pos], plain)
                for pos in group}, mesh)
            x = tp.each(x, lambda pos, t: t + attn[pos])
            h = tp.each(x, lambda pos, t: layer_norm(
                t, w[pos][b + "ln2.scale"], w[pos][b + "ln2.bias"]))
            ff = tp.all_reduce({pos: mlp(h[pos], w[pos][b + "w_in"], w[pos][b + "w_out"],
                                         plain) for pos in group}, mesh)
            x = tp.each(x, lambda pos, t: t + ff[pos])
        pooled = tp.each(x, lambda pos, t: last_token(layer_norm(
            t, w[pos]["final_ln.scale"], w[pos]["final_ln.bias"]), mask[pos]))
        first = group[0]
        out = tp.all_gather({pos: mm_f32(pooled[pos], w[pos]["out_proj"], plain)
                             for pos in group}, mesh, -1)[first]
        if cfg.use_bag:
            rows = self._lookup("bag_emb", group, ids)[first]
            return mix_bag(out, rows, mask[first], w[first]["mix"], cfg)
        return _unit(out)

    def split_batch(self, token_ids) -> List[Tuple[List[int], torch.Tensor]]:
        """[(model group, its rows of the batch on its first device)], one
        per data index; the batch must divide over ``data``."""
        if not isinstance(token_ids, torch.Tensor):
            token_ids = torch.from_numpy(np.asarray(token_ids))
        groups = self.groups()
        if token_ids.shape[0] % len(groups):
            raise ValueError(f"batch {token_ids.shape[0]} does not split over "
                             f"the data axis ({len(groups)})")
        rows = token_ids.shape[0] // len(groups)
        return [(g, token_ids[d * rows:(d + 1) * rows].to(
            self.mesh.devices[g[0]], torch.int64)) for d, g in enumerate(groups)]

    def vectors(self, token_ids, plain: Optional[bool] = None) -> torch.Tensor:
        """(B, L) ids -> (B, embed_dim) unit vectors on the first position's
        device, differentiable."""
        parts = {g[0]: self.group_vectors(g, ids, use_plain(ids, plain))
                 for g, ids in self.split_batch(token_ids)}
        return tp.all_gather(parts, self.mesh, 0)[min(parts)]

    @torch.inference_mode()
    def __call__(self, token_ids, plain: Optional[bool] = None) -> torch.Tensor:
        return self.vectors(token_ids, plain)


def shard_params(model: Embedder, mesh) -> ShardedEmbedder:
    """The embedder's weights (seeded, loaded, or carried from JAX with
    ``from_jax_params``) laid over ``mesh``."""
    params = tp.ShardedParams.shard(mesh, param_shardings(model.cfg, mesh),
                                    dict(model.named_parameters()))
    return ShardedEmbedder(model.cfg, mesh, params)


def gather_params(sharded: ShardedEmbedder, device: Optional[DeviceLike] = None
                  ) -> Embedder:
    """The whole embedder from its shards (JAX's fused ``wqkv`` included),
    on ``device`` (default: the first position's)."""
    device = sharded.device if device is None else resolve_device(device)
    model = Embedder(sharded.cfg, device)
    load_flat(model, sharded.params.gather(device=device))
    return model


def _sharded_info_nce(model: ShardedEmbedder, anchors, positives, temperature,
                      negatives, plain) -> torch.Tensor:
    """``info_nce_loss`` dp+tp: each data group's anchors, positives (and
    negatives) through one forward, then the vectors gathered over ``data``
    before the logits: the in-batch negatives span the GLOBAL batch, as
    JAX's ``za @ zp.T`` over data-sharded vectors does."""
    blocks = [anchors, positives] + ([negatives] if negatives is not None else [])
    split = [model.split_batch(b) for b in blocks]
    zs: List[Dict[int, torch.Tensor]] = [{} for _ in blocks]
    for d, (group, _ids) in enumerate(split[0]):
        ids = torch.cat([s[d][1] for s in split])
        z = model.group_vectors(group, ids, use_plain(ids, plain))
        for j, part in enumerate(z.split(split[0][d][1].shape[0])):
            zs[j][group[0]] = part
    za, zp, *zn = (tp.all_gather(z, model.mesh, 0)[min(z)] for z in zs)
    logits = za @ zp.T
    if zn:
        logits = torch.cat([logits, za @ zn[0].T], dim=1)
    logits = logits / temperature
    return torch.mean(-torch.log_softmax(logits, dim=-1).diagonal())


def sharded_train_step(model: ShardedEmbedder, opt_state: Dict[str, Any],
                       anchors, positives, *, negatives=None, lr: float = 1e-4,
                       plain: Optional[bool] = None):
    """One dp+tp InfoNCE step: the loss over the global batch, its gradient
    for every shard (a leaf shared by positions on one device sums their
    gradients through autograd; copies on distinct devices are summed by
    ``ShardedParams.sync_grads``), then ``adamw_update`` on each shard as it
    lies (``opt_state``: ``adamw_init(model.params.leaves())``). -> (model,
    opt_state, loss)"""
    params = model.params.requires_grad_(True)
    loss = _sharded_info_nce(model, anchors, positives, 0.05, negatives, plain)
    keys = list(params.tensors)
    grads = torch.autograd.grad(loss, [params.tensors[k] for k in keys],
                                allow_unused=True)
    grads = params.sync_grads(dict(zip(keys, grads)))
    adamw_update(params.leaves(), {f"{n}@{m}@{d}": g for (n, m, d), g in grads.items()},
                 opt_state, lr=lr)
    return model, opt_state, loss.detach()


# ------------------------------------------------------------ persistence ----

def save_params(path: str, model: Embedder, init_seed: int = 0) -> None:
    """Flat-key npz checkpoint in the JAX package's format; a frozen bag
    head is not stored (it regenerates from ``(cfg, init_seed)``)."""
    cfg = model.cfg
    flat = {}
    for name, leaf in model.tree().items():
        if cfg.use_bag and cfg.freeze_bag and name == "['bag_emb']":
            continue
        flat[name] = leaf.cpu().numpy()
    flat["__cfg__"] = np.array(
        [cfg.vocab_buckets, cfg.d_model, cfg.n_layers, cfg.n_heads,
         cfg.d_ff, cfg.max_len, cfg.embed_dim, int(cfg.use_bag),
         int(cfg.freeze_bag), int(init_seed)],
        dtype=np.int64,
    )
    np.savez(path, **flat)


def load_params(path: str, device: DeviceLike
                ) -> Tuple[Embedder, EmbedderConfig]:
    """-> (the model on ``device``, its config); leaves the file lacks (the
    frozen bag) are drawn from ``(cfg, init_seed)`` on ``device``."""
    device = resolve_device(device)
    with np.load(path) as data:
        vals = data["__cfg__"]
        cfg = EmbedderConfig(
            vocab_buckets=int(vals[0]), d_model=int(vals[1]),
            n_layers=int(vals[2]), n_heads=int(vals[3]), d_ff=int(vals[4]),
            max_len=int(vals[5]), embed_dim=int(vals[6]),
            # checkpoints predating the bag head have 7 fields -> no bag
            use_bag=bool(vals[7]) if vals.shape[0] > 7 else False,
            freeze_bag=bool(vals[8]) if vals.shape[0] > 8 else True,
        )
        init_seed = int(vals[9]) if vals.shape[0] > 9 else 0
        makers = _init_makers(cfg, prng.PRNGKey(init_seed), device)
        flat = {name: (data[jax_path(name)] if jax_path(name) in data.files
                       else make())
                for name, make in makers.items()}
    model = Embedder(cfg, device)
    load_flat(model, flat)
    return model, cfg


# ---------------------------------------------------- provider interface ----

class NeuralEmbeddingProvider:
    """Serves the embed_texts contract from the in-process model, on the
    device its entry point named (``device.models_device()``) unless one is
    given."""

    _instance: Optional["NeuralEmbeddingProvider"] = None

    def __init__(self, cfg: Optional[EmbedderConfig] = None, seed: int = 0,
                 device: Optional[DeviceLike] = None):
        from ..config import settings

        self.device = resolve_device(device) if device is not None \
            else models_device()
        params_path = (settings.embedder_params_path or "").strip()
        if cfg is None and params_path:
            self.model, self.cfg = load_params(params_path, self.device)
            if int(self.cfg.embed_dim) != int(settings.embeddings_dim):
                # fail at startup with the actual misconfiguration, not as
                # wrong-width vectors on every request
                raise RuntimeError(
                    f"embedder checkpoint {params_path} produces "
                    f"{self.cfg.embed_dim}-d vectors but EMBEDDINGS_DIM="
                    f"{settings.embeddings_dim}; retrain or fix the env"
                )
            suffix = "-tuned"
        else:
            self.cfg = cfg or EmbedderConfig(
                embed_dim=int(settings.embeddings_dim)
            )
            self.model = init_params(self.cfg, prng.PRNGKey(seed), self.device)
            suffix = ""
        self.model_id = (
            f"cadence-neural-embedder-{self.cfg.d_model}d"
            f"{self.cfg.n_layers}L{suffix}"
        )

    @classmethod
    def shared(cls) -> "NeuralEmbeddingProvider":
        if cls._instance is None or cls._instance.device != models_device():
            cls._instance = cls()
        return cls._instance

    def embed(self, texts: Sequence[str]):
        from ..embed.provider import EmbeddingResult

        # rows are independent and eager torch compiles nothing, so the
        # batch is not padded to a power of two as the JAX provider does
        tokens = torch.from_numpy(batch_tokenize(texts, self.cfg))
        vectors = self.model(tokens).float().cpu().numpy()
        return EmbeddingResult(vectors=vectors, model=self.model_id)
