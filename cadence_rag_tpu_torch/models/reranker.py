"""The cross-encoder reranker, in torch.

Counterpart of ``cadence_rag_tpu/models/reranker.py``: the config, the pair
tokenizer, the seeded initial weights, ``score_pairs``, the pairwise
(RankNet) loss and its training step, the npz checkpoints and
``NeuralReranker`` (``RERANK_PROVIDER=neural`` and
``neural_raw``). A pair is hash-tokenized as ``query [SEP] doc``, run
through the embedder's blocks, mean-pooled over its tokens and projected to
one relevance logit; with ``prior_residual`` the frozen lexical prior, times
``prior_gain``, is added.

The blocks are the embedder's (``models/embedder.Block``), and they apply
the causal mask: the JAX package's docstring calls the reranker
bidirectional, but its ``score_pairs`` runs the embedder's causal
``_block``, and the port does what that code does. The parameter tree is
the embedder's with ``embed_dim`` 1, bag head included (the committed
artifacts carry ``bag_emb`` (V, 1) and ``mix``, which scoring never reads).
Precision as in ``models/embedder.py``: the plain path on the CPU, bf16
GEMMs with f32 results on the card, for the gradients too. Training updates
every leaf with AdamW, so the bag head and ``mix``, which scoring never
reads, are decayed as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, models_device, resolve_device
from ..ops.hashing import fnv1a64
from . import prng
from .embedder import (
    EmbedderConfig,
    Encoder,
    _init_makers,
    apply_gradients,
    flatten_tree,
    jax_path,
    load_flat,
    mm_f32,
    tokens_on,
    trainable,
    use_plain,
)

SEP_TOKEN_ID = 1  # reserved: hash ids start at 2


@dataclasses.dataclass(frozen=True)
class RerankerConfig:
    vocab_buckets: int = 32768
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_len: int = 256
    # final score = frozen lexical prior (an input) + transformer residual
    prior_residual: bool = False
    # fixed scale on the prior before it joins the logits
    prior_gain: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def encoder_config(self) -> EmbedderConfig:
        return EmbedderConfig(
            vocab_buckets=self.vocab_buckets, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads, d_ff=self.d_ff,
            max_len=self.max_len, embed_dim=1,
        )


def pair_tokenize(query: str, doc: str, cfg: RerankerConfig) -> np.ndarray:
    ids: List[int] = []
    for word in query.lower().split():
        h = fnv1a64(b"tok:" + word.encode("utf-8"))
        ids.append(int(h % (cfg.vocab_buckets - 2)) + 2)
    ids.append(SEP_TOKEN_ID)
    for word in doc.lower().split():
        h = fnv1a64(b"tok:" + word.encode("utf-8"))
        ids.append(int(h % (cfg.vocab_buckets - 2)) + 2)
        if len(ids) >= cfg.max_len:
            break
    out = np.zeros(cfg.max_len, dtype=np.int32)
    ids = ids[: cfg.max_len]
    out[: len(ids)] = ids
    return out


class Reranker(Encoder):
    """(P, L) int pair tokens (+ an optional (P,) prior) -> (P,) logits."""

    def __init__(self, cfg: RerankerConfig, device: DeviceLike):
        super().__init__(cfg.encoder_config(), device)
        self.rerank_cfg = cfg

    def logits(self, token_ids: torch.Tensor,
               prior: Optional[torch.Tensor] = None,
               plain: Optional[bool] = None) -> torch.Tensor:
        """The forward pass, differentiable (``forward`` runs it under
        ``torch.inference_mode``); the prior is an input, never a gradient
        path."""
        token_ids = token_ids.to(self.device, torch.int64)
        plain = use_plain(token_ids, plain)
        x, mask = self.hidden(token_ids, plain)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
        pooled = (x * mask[..., None]).sum(dim=1) / denom
        logits = mm_f32(pooled, self.out_proj, plain)[:, 0]
        cfg = self.rerank_cfg
        if cfg.prior_residual and prior is not None:
            logits = logits + cfg.prior_gain * torch.as_tensor(
                prior, dtype=torch.float32).to(self.device).detach()
        return logits

    @torch.inference_mode()
    def forward(self, token_ids: torch.Tensor,
                prior: Optional[torch.Tensor] = None,
                plain: Optional[bool] = None) -> torch.Tensor:
        return self.logits(token_ids, prior, plain)


def score_pairs(model: Reranker, token_ids, prior=None,
                plain: Optional[bool] = None) -> torch.Tensor:
    """(P, L) int32 -> (P,) relevance logits."""
    prior_t = None if prior is None else torch.as_tensor(
        np.asarray(prior, np.float32))
    return model(torch.as_tensor(np.asarray(token_ids)), prior_t, plain)


# ------------------------------------------------------------- training ----

def pairwise_loss(model: Reranker, tokens_hi, tokens_lo, prior_hi=None,
                  prior_lo=None, plain: Optional[bool] = None) -> torch.Tensor:
    """RankNet-style pairwise logistic loss, ``softplus(-(s_hi - s_lo))``
    averaged: it distills the teacher's ordering, not its scale. Under
    ``prior_residual`` the frozen prior joins each score (both priors must
    be given). The two blocks go through one forward pass."""
    hi, lo = tokens_on(model, tokens_hi), tokens_on(model, tokens_lo)
    prior = None
    if prior_hi is not None and prior_lo is not None:
        prior = torch.cat([torch.as_tensor(p, dtype=torch.float32, device=model.device)
                           for p in (prior_hi, prior_lo)])
    s = model.logits(torch.cat([hi, lo]), prior, plain)
    margin = s[: hi.shape[0]] - s[hi.shape[0]:]
    return torch.mean(torch.logaddexp(-margin, torch.zeros_like(margin)))


def train_step(model: Reranker, opt_state, tokens_hi, tokens_lo,
               lr: float = 1e-4, prior_hi=None, prior_lo=None,
               plain: Optional[bool] = None):
    """One pairwise step: the loss, its gradient for every leaf and the
    embedder's AdamW update, in place. -> (model, opt_state, loss)"""
    trainable(model)
    loss = pairwise_loss(model, tokens_hi, tokens_lo, prior_hi, prior_lo, plain)
    apply_gradients(model, opt_state, loss, lr)
    return model, opt_state, loss.detach()


def init_params(cfg: RerankerConfig, key: torch.Tensor,
                device: DeviceLike) -> Reranker:
    """The JAX package's ``init_params(cfg, key)``, made on ``device``."""
    device = resolve_device(device)
    model = Reranker(cfg, device)
    load_flat(model, {n: make() for n, make in _init_makers(
        cfg.encoder_config(), key, device).items()})
    return model


def from_jax_params(params: Mapping[str, Any], cfg: RerankerConfig,
                    device: DeviceLike) -> Reranker:
    """The reranker from the JAX package's parameter tree (numpy leaves)."""
    model = Reranker(cfg, device)
    load_flat(model, flatten_tree(params))
    return model


def save_params(path: str, model: Reranker) -> None:
    cfg = model.rerank_cfg
    flat = {name: leaf.cpu().numpy() for name, leaf in model.tree().items()}
    flat["__rerank_cfg__"] = np.array(
        [cfg.vocab_buckets, cfg.d_model, cfg.n_layers, cfg.n_heads,
         cfg.d_ff, cfg.max_len, int(cfg.prior_residual),
         int(round(cfg.prior_gain * 1000))], dtype=np.int64,
    )
    np.savez(path, **flat)


def load_params(path: str, device: DeviceLike
                ) -> Tuple[Reranker, RerankerConfig]:
    with np.load(path) as data:
        vals = data["__rerank_cfg__"]
        cfg = RerankerConfig(
            vocab_buckets=int(vals[0]), d_model=int(vals[1]),
            n_layers=int(vals[2]), n_heads=int(vals[3]), d_ff=int(vals[4]),
            max_len=int(vals[5]),
            # 6-field rows are artifacts from before the prior head
            prior_residual=bool(vals[6]) if vals.shape[0] > 6 else False,
            prior_gain=(
                float(vals[7]) / 1000.0 if vals.shape[0] > 7 else 1.0
            ),
        )
        model = Reranker(cfg, device)
        load_flat(model, {name: data[jax_path(name)]
                          for name, _ in model.named_parameters()})
    return model, cfg


class NeuralReranker:
    """The process-wide cross-encoder, on the device its entry point named
    (``device.models_device()``) unless one is given."""

    _instance: Optional["NeuralReranker"] = None

    def __init__(self, cfg: Optional[RerankerConfig] = None, seed: int = 0,
                 device: Optional[DeviceLike] = None):
        from ..config import settings

        self.device = resolve_device(device) if device is not None \
            else models_device()
        params_path = (settings.reranker_params_path or "").strip()
        if cfg is None and params_path:
            self.model, self.cfg = load_params(params_path, self.device)
        else:
            self.cfg = cfg or RerankerConfig()
            self.model = init_params(self.cfg, prng.PRNGKey(seed), self.device)

    @classmethod
    def shared(cls) -> "NeuralReranker":
        if cls._instance is None or cls._instance.device != models_device():
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests and weight reloads)."""
        cls._instance = None

    def score(self, query: str, docs: Sequence[str],
              priors: Optional[np.ndarray] = None) -> np.ndarray:
        if not docs:  # candidates may have vanished from the store (race
            return np.zeros(0, dtype=np.float32)  # with a concurrent delete)
        tokens = np.stack([pair_tokenize(query, d, self.cfg) for d in docs])
        prior = None
        if self.cfg.prior_residual:
            prior = (np.zeros(len(docs), np.float32) if priors is None
                     else np.asarray(priors, np.float32))
        return score_pairs(self.model, tokens, prior).cpu().numpy()
