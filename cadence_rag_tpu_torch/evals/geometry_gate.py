"""Recall/quantization gates on REALISTIC embedding geometry.

Counterpart of ``cadence_rag_tpu/evals/geometry_gate.py``, on the device the
caller names (the card unless asked for the CPU). The synthetic gates
(``ann_recall_gate``, the int8 tests) run on random or mixture-of-gaussian
vectors; this harness runs three gates on either:

- ``--npz PATH``: any local (N, dim) f32 dump under the key ``emb`` (pass
  ``--query-npz`` for real query vectors, else queries are held-out
  perturbations), or
- the default: the TUNED in-process embedder
  (``artifacts/embedder/tuned_small_v1.npz``) encoding a generated
  domain-style corpus — transformer-embedding geometry (topic clusters,
  anisotropic spectrum), not synthetic gaussians. Queries are encoded
  PARAPHRASES (different template, same topic).

Gates (each prints measured vs floor; exit 1 on failure):

- ann: the port's approximate dense lane, kernel K1's dense half
  (``filtered_recall_sweep.ann_topk``: ``ops/fused_scan.fused_topk`` with an
  all-zero lexical plane, one winner per strided 8-row group, then the exact
  top-k of the candidates), over the rows stored bf16, as the served index
  stores them. The gated ``ann_recall`` is recall@k against the exact scan
  of the same bf16 rows (``ops/topk.dense_scores``: the query rounded to
  bf16, f32 products); ``ann_recall_f32`` is recall@k against the exact f32
  ranking, the truth the JAX gate uses. The JAX gate measures
  ``lax.approx_max_k`` over f32 rows instead; the port has no
  ``approx_max_k``, and K1 is its only approximate top-k.
- int8: recall@k of int8-quantized-storage scoring (the
  ``INDEX_EMBEDDING_DTYPE=int8`` contract: ``dense_scores`` over
  ``round(x * 127)`` rows) against the exact f32 ranking, as in the JAX
  gate. Reported two ways, because clustered real-geometry corpora are
  saturated with near-ties:
    int8_recall      — plain id overlap with the true f32 top-k
    int8_eps_recall  — fraction of int8-retrieved docs whose TRUE f32
                       score >= (kth true score - eps)
  eps defaults to 1e-2, a ~3-sigma bound of the storage error
  (<= 0.5/127 a component). The gate passes int8 on id-recall OR
  eps-recall (floors ``--min-int8`` / ``--min-int8-eps``).
- ivf: probed-cluster recall@k against the exact f32 ranking, with
  ``ops/ivf.py`` over the f32 rows (skipped below ``--ivf-min`` rows).

Tokenizing the corpus hashes each distinct word once
(``models/embedder.hash_tokenize``'s ids, cached by word), since a 1M-text
corpus repeats its template words.

Usage:
  python -m cadence_rag_tpu_torch.evals.geometry_gate [--n 1000000]
      [--queries 256] [--k 10] [--npz PATH] [--query-npz PATH]
      [--min-ann 0.95] [--min-int8 0.90] [--min-int8-eps 0.99]
      [--int8-eps 1e-2] [--skip-ivf] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, pin_f32_matmul, resolve_device
from ..ops.topk import dense_scores, topk_lowest_index_first
from .filtered_recall_sweep import ann_topk
from .train_corpus import EVENTS, FILLER, SERVICES

DEFAULT_EMBEDDER = "artifacts/embedder/tuned_small_v1.npz"
# rows per slab of the exact f32 scan (64 queries x 65536 rows of f32)
SCAN_ROWS = 65536


def corpus_texts(n: int, seed: int) -> Tuple[List[str], List[str]]:
    """(doc_texts, paraphrase_pool) — domain-style sentences with varied
    identifiers so the embedder produces clustered-but-distinct rows."""
    rng = np.random.default_rng(seed)
    events = list(EVENTS)
    docs: List[str] = []
    paras: List[str] = []
    for _ in range(n):
        svc = SERVICES[int(rng.integers(0, len(SERVICES)))]
        event = events[int(rng.integers(0, len(events)))]
        spec = EVENTS[event]
        t_lines = spec["transcript"]
        line = t_lines[int(rng.integers(0, len(t_lines)))].format(svc=svc)
        filler = FILLER[int(rng.integers(0, len(FILLER)))]
        docs.append(f"{line} {filler} ref-{int(rng.integers(0, 99999))}")
        if len(paras) < n:
            alt = spec["summary"][int(rng.integers(0, len(spec["summary"])))]
            paras.append(alt.format(svc=svc))
    return docs, paras


def tokenize_cached(texts: Sequence[str], cfg, cache: Dict[str, int]
                    ) -> np.ndarray:
    """``models/embedder.batch_tokenize`` with each distinct word hashed
    once (``cache`` maps a word to its id)."""
    from ..models.embedder import hash_tokenize

    out = np.zeros((len(texts), cfg.max_len), dtype=np.int32)
    for i, text in enumerate(texts):
        words = text.lower().split()[: cfg.max_len]
        ids = []
        for word in words:
            tok = cache.get(word)
            if tok is None:
                tok = cache[word] = int(hash_tokenize(word, cfg)[0])
            ids.append(tok)
        out[i, : len(ids)] = ids
    return out


def encode_corpus(texts: Sequence[str], model, cfg, batch: int = 8192,
                  cache=None, timings=None) -> torch.Tensor:
    """(N, embed_dim) f32 unit vectors on the model's device, encoded in
    batches of ``batch`` texts. ``timings`` (a dict) accumulates the host
    tokenizing seconds (``tokenize_s``) and the encoder's (``encode_s``,
    waited for)."""
    cache = {} if cache is None else cache
    timings = {} if timings is None else timings
    out = torch.empty((len(texts), cfg.embed_dim), dtype=torch.float32,
                      device=model.device)
    for lo in range(0, len(texts), batch):
        t0 = time.perf_counter()
        tokens = torch.from_numpy(
            tokenize_cached(texts[lo:lo + batch], cfg, cache))
        t1 = time.perf_counter()
        out[lo:lo + tokens.shape[0]] = model(tokens)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        t2 = time.perf_counter()
        timings["tokenize_s"] = timings.get("tokenize_s", 0.0) + t1 - t0
        timings["encode_s"] = timings.get("encode_s", 0.0) + t2 - t1
    return out


def exact_f32_topk(q: torch.Tensor, docs: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact f32 ranking (JAX's ``dense_scores`` over f32 rows: f32
    query, f32 products), ``lax.top_k``'s tie order, by row slabs."""
    n = docs.shape[0]
    scores = torch.empty((q.shape[0], n), dtype=torch.float32, device=docs.device)
    for r0 in range(0, n, SCAN_ROWS):
        r1 = min(n, r0 + SCAN_ROWS)
        torch.matmul(q, docs[r0:r1].T, out=scores[:, r0:r1])
    return topk_lowest_index_first(scores, k)


def _recall(truth: np.ndarray, got: np.ndarray, k: int) -> List[float]:
    return [len(set(t.tolist()) & set(g.tolist())) / k for t, g in zip(truth, got)]


def run_gates(
    docs,
    queries,
    k: int,
    recall_target: float,
    batch: int = 64,
    skip_ivf: bool = False,
    ivf_min: int = 200_000,
    int8_eps: float = 1e-2,
    device: DeviceLike = "cuda",
) -> Dict:
    """``docs`` (N, dim) and ``queries`` (Q, dim) unit vectors, numpy or
    tensors, f32; they are staged on ``device`` as f32, bf16 and int8 rows.
    ``recall_target`` is reported; K1 has one partition whatever the target
    (``engine/planner.py``)."""
    from ..ops.ivf import build_buckets, ivf_topk, kmeans

    dev = resolve_device(device)
    pin_f32_matmul(dev)
    d_docs = torch.as_tensor(docs).to(dev, torch.float32)
    n, dim = d_docs.shape
    d_bf16 = d_docs.to(torch.bfloat16)
    d_int8 = torch.clamp(torch.round(d_docs * 127.0), -127, 127).to(torch.int8)
    q_all = torch.as_tensor(queries).to(dev, torch.float32)

    recalls: Dict[str, List[float]] = {"ann": [], "ann_f32": [], "int8": [],
                                       "int8_eps": []}
    losses: List[float] = []
    for lo in range(0, q_all.shape[0], batch):
        q = q_all[lo:lo + batch]
        mask = torch.ones((q.shape[0], n), dtype=torch.bool, device=dev)
        exact_scores, exact_idx = exact_f32_topk(q, d_docs, k)
        _, bf16_idx = topk_lowest_index_first(dense_scores(q, d_bf16), k)
        _, ann_idx = ann_topk(q, d_bf16, mask, k)
        _, i8_idx = topk_lowest_index_first(dense_scores(q, d_int8), k)
        # TRUE f32 scores of the int8-retrieved ids
        i8_true = torch.einsum("bd,bkd->bk", q, d_docs[i8_idx])
        exact_idx, bf16_idx, ann_idx, i8_idx = (
            t.cpu().numpy() for t in (exact_idx, bf16_idx, ann_idx, i8_idx))
        kth = exact_scores[:, -1].cpu().numpy()
        i8_true = i8_true.cpu().numpy()
        recalls["ann"] += _recall(bf16_idx, ann_idx, k)
        recalls["ann_f32"] += _recall(exact_idx, ann_idx, k)
        recalls["int8"] += _recall(exact_idx, i8_idx, k)
        for row in range(exact_idx.shape[0]):
            recalls["int8_eps"].append(
                float(np.mean(i8_true[row] >= kth[row] - int8_eps)))
            losses.append(max(0.0, float(kth[row]) - float(i8_true[row].min())))
    out: Dict = {
        "n": int(n), "dim": int(dim), "k": k,
        "queries": int(q_all.shape[0]),
        "recall_target": recall_target,
        "ann_recall": round(float(np.mean(recalls["ann"])), 4),
        "ann_recall_f32": round(float(np.mean(recalls["ann_f32"])), 4),
        "int8_recall": round(float(np.mean(recalls["int8"])), 4),
        "int8_eps": int8_eps,
        "int8_eps_recall": round(float(np.mean(recalls["int8_eps"])), 4),
        "int8_score_loss_mean": round(float(np.mean(losses)), 6),
        "int8_score_loss_p99": round(float(np.percentile(losses, 99)), 6),
    }

    if not skip_ivf and n >= ivf_min:
        t0 = time.perf_counter()
        clusters = max(64, int(np.sqrt(n)))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        centroids, assign = kmeans(d_docs, n_clusters=clusters, iters=10,
                                   generator=gen)
        bucket_cap = max(8, int(2.0 * n / clusters))
        buckets_np, overflow_np = build_buckets(
            assign.cpu().numpy(), clusters, bucket_cap)
        nprobe = max(4, int(clusters * 0.08))
        overflow = np.full(max(8, len(overflow_np)), -1, np.int32)
        overflow[: len(overflow_np)] = overflow_np
        buckets = torch.from_numpy(buckets_np).to(dev)
        overflow_t = torch.from_numpy(overflow).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        ivf_recall: List[float] = []
        for lo in range(0, min(q_all.shape[0], 128), batch):
            q = q_all[lo:lo + batch]
            mask = torch.ones((q.shape[0], n), dtype=torch.bool, device=dev)
            _, exact_idx = exact_f32_topk(q, d_docs, k)
            _, ivf_idx = ivf_topk(q, d_docs, centroids, buckets, overflow_t,
                                  mask, k=k, nprobe=nprobe)
            ivf_recall += _recall(exact_idx.cpu().numpy(),
                                  ivf_idx.cpu().numpy(), k)
        out["ivf_recall"] = round(float(np.mean(ivf_recall)), 4)
        out["ivf_clusters"] = int(clusters)
        out["ivf_nprobe"] = int(nprobe)
        out["ivf_candidate_frac"] = round(nprobe * bucket_cap / n, 4)
        out["ivf_build_s"] = round(build_s, 1)
    return out


def embedder_geometry(n: int, n_queries: int, seed: int, params_path: str,
                      device: DeviceLike, timings=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The default corpus: ``n`` generated domain texts and ``n_queries``
    paraphrases, encoded by the embedder at ``params_path`` on ``device``.
    -> (docs (n, dim), queries (n_queries, dim)) f32 on ``device``.
    ``timings`` (a dict) gets the corpus generation, tokenizing and encoder
    seconds and the texts per second."""
    from ..models.embedder import load_params

    timings = {} if timings is None else timings
    dev = resolve_device(device)
    t0 = time.perf_counter()
    doc_texts, para_pool = corpus_texts(n, seed)
    timings["texts_s"] = time.perf_counter() - t0
    model, cfg = load_params(params_path, dev)
    cache: Dict[str, int] = {}
    t0 = time.perf_counter()
    docs = encode_corpus(doc_texts, model, cfg, cache=cache, timings=timings)
    queries = encode_corpus(para_pool[:n_queries], model, cfg, cache=cache,
                            timings=timings)
    timings["encode_total_s"] = time.perf_counter() - t0
    timings["texts_per_s"] = (n + n_queries) / timings["encode_total_s"]
    return docs, queries


def main() -> None:
    parser = argparse.ArgumentParser(description="realistic-geometry gates")
    parser.add_argument("--device", default="cuda",
                        help="device of the encoder and the scans: cuda "
                        "(default) or cpu")
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--queries", type=int, default=256)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--npz", type=str, default="")
    parser.add_argument("--query-npz", type=str, default="")
    parser.add_argument("--min-ann", type=float, default=0.95)
    parser.add_argument("--min-int8", type=float, default=0.90)
    parser.add_argument("--min-int8-eps", type=float, default=0.99)
    parser.add_argument("--int8-eps", type=float, default=1e-2)
    parser.add_argument("--skip-ivf", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    from ..config import settings
    from ..engine.planner import recall_target_for_ef_search

    device = resolve_device(args.device)
    timings: Dict[str, float] = {}
    if args.npz:
        docs = np.load(args.npz)["emb"].astype(np.float32)
        docs /= np.maximum(
            np.linalg.norm(docs, axis=1, keepdims=True), 1e-9
        )
        if args.query_npz:
            queries = np.load(args.query_npz)["emb"].astype(np.float32)
        else:  # perturbed held-out docs
            rng = np.random.default_rng(args.seed)
            pick = rng.choice(docs.shape[0], args.queries, replace=False)
            queries = docs[pick] + 0.05 * rng.standard_normal(
                (args.queries, docs.shape[1])
            ).astype(np.float32)
        queries /= np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-9
        )
        source = args.npz
    else:
        params_path = settings.embedder_params_path.strip() or DEFAULT_EMBEDDER
        docs, queries = embedder_geometry(args.n, args.queries, args.seed,
                                          params_path, device, timings)
        print(json.dumps({"phase": "encoded", **{
            key: round(value, 1) for key, value in timings.items()}}),
            file=sys.stderr, flush=True)
        source = "tuned-embedder-synthetic-domain"

    result = run_gates(
        docs, queries, args.k,
        recall_target_for_ef_search(settings.embeddings_hnsw_ef_search),
        skip_ivf=args.skip_ivf, int8_eps=args.int8_eps, device=device,
    )
    result["source"] = source
    int8_ok = (
        result["int8_recall"] >= args.min_int8
        or result["int8_eps_recall"] >= args.min_int8_eps
    )
    result["pass"] = bool(result["ann_recall"] >= args.min_ann and int8_ok)
    print(json.dumps(result))
    sys.exit(0 if result["pass"] else 1)


if __name__ == "__main__":
    main()
