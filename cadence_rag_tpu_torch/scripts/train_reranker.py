"""Distill the lexical rescorer into the neural cross-encoder reranker.

Counterpart of ``cadence_rag_tpu/scripts/train_reranker.py``. The rerank
contract is the ORDERING of the fused top-k (``engine/rerank.py`` applies
order only, keeping the RRF score ladder). The deterministic lexical
rescorer is gate-stable, so it serves as the teacher: synthesize queries
from the corpus, score candidate sets with the lexical provider, and train
the cross-encoder with a pairwise (RankNet) loss until its ordering
matches. The triples and the batches are the JAX package's (the same store
rows and numpy ``default_rng`` draws); the steps run on ``--device`` (the
card unless the caller asks for the CPU; asking for CUDA without a card
raises).

Usage: python -m cadence_rag_tpu_torch.scripts.train_reranker --out rr.npz
       [--steps 300] [--batch 32] [--queries 200] [--d-model 128]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import settings
from ..device import DeviceLike, pin_f32_matmul, resolve_device
from ..logging_utils import configure_logging, get_logger
from ..store.db import get_store

logger = get_logger(__name__)


def build_triples(
    n_queries: int, cand_per_query: int = 12, seed: int = 0,
) -> List[Tuple[str, str, str]]:
    """-> (query, higher_doc, lower_doc) triples labeled by the lexical
    teacher over lexical near-miss candidate sets."""
    from ..core.index import get_index
    from ..engine.rerank import _lexical_scores
    from ..ingest import featurize
    from .train_embedder import _STOP, _WORD_RE

    store = get_store()
    rng = np.random.default_rng(seed)
    with store.read() as conn:
        rows = conn.execute(
            "SELECT chunk_id, text, lex_sig FROM chunks "
            "WHERE lex_sig IS NOT NULL"
        ).fetchall()
    if len(rows) < cand_per_query:
        raise SystemExit("not enough chunks to distill from")
    dim = int(settings.lexical_dim)
    sigs = np.zeros((len(rows), dim), dtype=np.float32)
    for i, row in enumerate(rows):
        sig = np.frombuffer(row["lex_sig"], dtype=np.int8)
        if sig.shape[0] == dim:
            sigs[i] = sig
    texts = [r["text"] for r in rows]
    ids = [int(r["chunk_id"]) for r in rows]
    doc_freq = get_index().chunks.doc_freq
    n_docs = max(get_index().chunks.count, len(rows))

    triples: List[Tuple[str, str, str]] = []
    for _ in range(n_queries):
        src = int(rng.integers(0, len(rows)))
        words = [w for w in _WORD_RE.findall(texts[src])
                 if w.lower() not in _STOP]
        if len(words) < 3:
            continue
        picked = rng.choice(len(words), size=max(2, len(words) // 3),
                            replace=False)
        query = " ".join(words[i] for i in sorted(picked))
        q_vec = featurize.query_lexical_vector(query, doc_freq, n_docs)
        order = np.argsort(-(sigs @ q_vec))[:cand_per_query]
        cand_ids = [ids[i] for i in order]
        teacher: Dict[int, float] = _lexical_scores(
            query, "chunks", "chunk_id", "text", cand_ids, doc_freq, n_docs
        )
        ranked = sorted(cand_ids, key=lambda d: -teacher.get(d, 0.0))
        id_to_text = {ids[i]: texts[i] for i in order}
        # pairs with a clear teacher margin
        for hi_pos in range(len(ranked) - 1):
            lo_pos = int(rng.integers(hi_pos + 1, len(ranked)))
            hi, lo = ranked[hi_pos], ranked[lo_pos]
            if teacher.get(hi, 0) - teacher.get(lo, 0) < 0.5:
                continue
            triples.append((query, id_to_text[hi], id_to_text[lo]))
    rng.shuffle(triples)
    return triples


def attach_priors(
    triples: List[Tuple[str, str, str]],
) -> List[Tuple[str, str, str, float, float]]:
    """The frozen lexical prior of each triple's hi/lo texts
    (``engine/rerank.prior_for_texts``, the rescore the serving path feeds
    the prior-residual model)."""
    from ..core.index import get_index
    from ..engine.rerank import prior_for_texts

    index = get_index()
    doc_freq = index.chunks.doc_freq
    n_docs = max(index.chunks.count, 1)
    avgdl = index.chunks.avgdl or 400.0
    out = []
    for query, hi, lo in triples:
        p = prior_for_texts(query, [hi, lo], doc_freq, n_docs, avgdl)
        out.append((query, hi, lo, float(p[0]), float(p[1])))
    return out


def train(
    triples,
    *,
    out_path: str,
    steps: int,
    batch: int,
    lr: float,
    d_model: int,
    n_layers: int,
    vocab_buckets: int = 32768,
    max_len: int = 128,
    seed: int = 0,
    prior_residual: bool = False,
    prior_gain: float = 1.0,
    device: DeviceLike = "cuda",
    history: Optional[list] = None,
) -> float:
    """``triples``: (query, hi, lo) or, with ``prior_residual``,
    (query, hi, lo, prior_hi, prior_lo) — see ``attach_priors``. With
    ``history`` (a list), each step appends ``{"loss", "t"}`` (every step
    waited for). -> the final loss"""
    import torch

    from ..models import prng
    from ..models.embedder import adamw_init
    from ..models.reranker import (
        RerankerConfig,
        init_params,
        pair_tokenize,
        save_params,
        train_step,
    )

    dev = resolve_device(device)
    pin_f32_matmul(dev)
    cfg = RerankerConfig(
        vocab_buckets=vocab_buckets, d_model=d_model, n_layers=n_layers,
        n_heads=max(4, d_model // 32), d_ff=4 * d_model, max_len=max_len,
        prior_residual=prior_residual, prior_gain=prior_gain,
    )
    logger.info("train_reranker.start triples=%s cfg=%s device=%s",
                len(triples), cfg, dev)
    model = init_params(cfg, prng.PRNGKey(seed), dev)
    opt_state = adamw_init(model)
    rng = np.random.default_rng(seed)

    def pairs(idx, col):
        return torch.from_numpy(np.stack([
            pair_tokenize(triples[i][0], triples[i][col], cfg) for i in idx
        ])).to(dev)

    loss = None
    for step in range(steps):
        idx = rng.choice(len(triples), size=batch,
                         replace=len(triples) < batch)
        hi, lo = pairs(idx, 1), pairs(idx, 2)
        if prior_residual:
            phi = np.array([triples[i][3] for i in idx], np.float32)
            plo = np.array([triples[i][4] for i in idx], np.float32)
        else:
            phi = np.zeros(len(idx), np.float32)
            plo = np.zeros(len(idx), np.float32)
        model, opt_state, loss = train_step(
            model, opt_state, hi, lo, lr=lr,
            prior_hi=torch.from_numpy(phi).to(dev),
            prior_lo=torch.from_numpy(plo).to(dev))
        if history is not None:
            history.append({"loss": float(loss), "t": time.perf_counter()})
        if step % 50 == 0:
            logger.info("train_reranker.step step=%s loss=%.4f",
                        step, float(loss))
    save_params(out_path, model)
    logger.info("train_reranker.done steps=%s final_loss=%.4f out=%s",
                steps, float(loss), out_path)
    return float(loss)


def pairwise_agreement(
    triples: List[Tuple[str, str, str]], params_path: str,
    device: DeviceLike = "cuda",
) -> float:
    """Fraction of teacher-ordered pairs the tuned model orders the same
    way (the distillation fidelity metric)."""
    from ..models.reranker import load_params, pair_tokenize, score_pairs

    model, cfg = load_params(params_path, resolve_device(device))
    agree = total = 0
    for start in range(0, len(triples), 64):
        window = triples[start:start + 64]
        hi = np.stack([pair_tokenize(q, h, cfg) for q, h, _ in window])
        lo = np.stack([pair_tokenize(q, l, cfg) for q, _, l in window])
        s_hi = score_pairs(model, hi).cpu().numpy()
        s_lo = score_pairs(model, lo).cpu().numpy()
        agree += int((s_hi > s_lo).sum())
        total += len(window)
    return agree / max(total, 1)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="distill the lexical rescorer into the neural reranker"
    )
    parser.add_argument("--out", required=True)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--queries", type=int, default=200)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--vocab-buckets", type=int, default=32768)
    parser.add_argument("--max-len", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="device of the training steps (and the index "
                        "whose df table the teacher reads): cuda (default) "
                        "or cpu")
    args = parser.parse_args()
    configure_logging(settings.log_level)
    from ..core.index import get_index

    device = resolve_device(args.device)
    get_index(device)
    triples = build_triples(args.queries, seed=args.seed)
    if len(triples) < args.batch:
        raise SystemExit(
            f"not enough distillation triples ({len(triples)})"
        )
    holdout = triples[: max(len(triples) // 10, 8)]
    train_set = triples[len(holdout):]
    train(
        train_set, out_path=args.out, steps=args.steps, batch=args.batch,
        lr=args.lr, d_model=args.d_model, n_layers=args.n_layers,
        vocab_buckets=args.vocab_buckets, max_len=args.max_len,
        seed=args.seed, device=device,
    )
    fidelity = pairwise_agreement(holdout, args.out, device)
    logger.info("train_reranker.fidelity holdout_agreement=%.4f", fidelity)
    print(f"holdout pairwise agreement with teacher: {fidelity:.4f}")


if __name__ == "__main__":
    main()
