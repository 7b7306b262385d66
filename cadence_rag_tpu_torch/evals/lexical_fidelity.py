"""Lexical-lane fidelity: hashed-signature BM25 vs exact BM25.

The lexical lane approximates pg_search's BM25 with signed-hash signatures
(ops/hashing.py) — collisions trade memory for fidelity, controlled by
LEXICAL_DIM. This harness quantifies that trade: rank documents for a set
of queries with (a) EXACT BM25 over true term statistics and (b) the
hashed signature dot product, and report top-k rank overlap per signature
width. Run it when tuning LEXICAL_DIM for a corpus size.

Usage: python -m cadence_rag_tpu_torch.evals.lexical_fidelity [--docs 2000]
       [--queries 64] [--k 10] [--dims 1024 2048 4096 16384]
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List

import numpy as np

from ..ops import hashing


def _synth_corpus(n_docs: int, rng: np.random.Generator) -> List[str]:
    """Zipfian vocabulary text, ~40 words/doc (chunk-like)."""
    vocab = [f"term{i}" for i in range(4000)]
    weights = 1.0 / np.arange(1, len(vocab) + 1) ** 1.1
    weights /= weights.sum()
    docs = []
    for _ in range(n_docs):
        length = int(rng.integers(20, 60))
        words = rng.choice(len(vocab), size=length, p=weights)
        docs.append(" ".join(vocab[w] for w in words))
    return docs


def _exact_bm25_rank(
    docs: List[str], queries: List[str], k: int
) -> List[List[int]]:
    """Reference-exact BM25 over true word terms (k1/b as the lane)."""
    k1, b = hashing.BM25_K1, hashing.BM25_B
    doc_terms = [d.split() for d in docs]
    doc_lens = np.array([len(t) for t in doc_terms], dtype=np.float64)
    avgdl = doc_lens.mean()
    df: Dict[str, int] = {}
    tfs: List[Dict[str, int]] = []
    for terms in doc_terms:
        counts: Dict[str, int] = {}
        for t in terms:
            counts[t] = counts.get(t, 0) + 1
        tfs.append(counts)
        for t in counts:
            df[t] = df.get(t, 0) + 1
    n = len(docs)
    out = []
    for q in queries:
        scores = np.zeros(n)
        for t in set(q.split()):
            if t not in df:
                continue
            idf = math.log(1.0 + (n - df[t] + 0.5) / (df[t] + 0.5))
            for i, counts in enumerate(tfs):
                tf = counts.get(t, 0)
                if tf:
                    norm = 1.0 - b + b * doc_lens[i] / avgdl
                    scores[i] += idf * tf * (k1 + 1.0) / (tf + k1 * norm)
        out.append(list(np.argsort(-scores, kind="stable")[:k]))
    return out


def _exact_feature_bm25_rank(
    docs: List[str], queries: List[str], k: int
) -> List[List[int]]:
    """Exact BM25 over the SAME word+trigram feature space the signatures
    hash (collision-free) — divergence from this isolates pure hashing
    loss, while divergence from word-BM25 also includes the intentional
    trigram robustness component."""
    k1, b = hashing.BM25_K1, hashing.BM25_B
    feats = [hashing.lexical_features(d) for d in docs]
    doc_lens = np.array([sum(f.values()) for f in feats], dtype=np.float64)
    avgdl = doc_lens.mean()
    df: Dict[int, int] = {}
    for f in feats:
        for h in f:
            df[h] = df.get(h, 0) + 1
    n = len(docs)
    out = []
    for q in queries:
        qf = hashing.lexical_features(q)
        scores = np.zeros(n)
        for h, qtf in qf.items():
            if h not in df:
                continue
            idf = math.log(1.0 + (n - df[h] + 0.5) / (df[h] + 0.5))
            weight = idf * min(qtf, 3)
            for i, f in enumerate(feats):
                tf = f.get(h, 0)
                if tf:
                    norm = 1.0 - b + b * doc_lens[i] / avgdl
                    scores[i] += weight * tf * (k1 + 1.0) / (tf + k1 * norm)
        out.append(list(np.argsort(-scores, kind="stable")[:k]))
    return out


def _top_df_vocab(docs: List[str], head: int) -> np.ndarray:
    """Top-``head`` feature hashes by document frequency (the same
    selection core/vocab.build_vocab_from_store learns from a store)."""
    df: Dict[int, int] = {}
    for d in docs:
        for h in hashing.lexical_features(d):
            df[h] = df.get(h, 0) + 1
    keys = np.fromiter(df.keys(), dtype=np.uint64, count=len(df))
    cnts = np.fromiter(df.values(), dtype=np.int64, count=len(df))
    order = np.lexsort((keys, -cnts))[: min(head, keys.size)]
    return np.sort(keys[order])


def _hashed_rank(
    docs: List[str], queries: List[str], k: int, dim: int,
    vocab: np.ndarray | None = None,
) -> List[List[int]]:
    dls = []
    sigs = np.zeros((len(docs), dim), dtype=np.int8)
    df = np.zeros(dim, dtype=np.int64)
    # two-pass: avgdl first (as the index does with its running average)
    feats = [hashing.lexical_features(d) for d in docs]
    avgdl = float(np.mean([sum(f.values()) for f in feats]))
    for i, doc in enumerate(docs):
        raw_h, raw_t = hashing.raw_feature_arrays(doc)
        sig, touched, dl = hashing.doc_signature_from_raw(
            raw_h, raw_t, dim, avgdl, vocab
        )
        sigs[i] = sig
        df[touched] += 1
        dls.append(dl)
    out = []
    for q in queries:
        raw_h, raw_t = hashing.raw_feature_arrays(q)
        b, s, t = hashing.query_feature_arrays_from_raw(raw_h, raw_t, dim, vocab)
        qv = hashing.query_vector_from_features(b, s, t, dim, df, len(docs))
        scores = sigs.astype(np.float32) @ qv
        out.append(list(np.argsort(-scores, kind="stable")[:k]))
    return out


def measure_fidelity(
    n_docs: int = 2000, n_queries: int = 64, k: int = 10,
    dims: List[int] = (1024, 2048, 4096, 16384), seed: int = 0,
    head: int = 0,
) -> Dict:
    rng = np.random.default_rng(seed)
    docs = _synth_corpus(n_docs, rng)
    queries = []
    for _ in range(n_queries):
        doc = docs[int(rng.integers(n_docs))].split()
        start = int(rng.integers(0, max(len(doc) - 5, 1)))
        queries.append(" ".join(doc[start : start + 5]))
    exact_words = _exact_bm25_rank(docs, queries, k)
    exact_feats = _exact_feature_bm25_rank(docs, queries, k)
    result = {"docs": n_docs, "queries": n_queries, "k": k, "overlap_at_k": {}}
    variants = [("", None)]
    if head:
        variants.append((f"+head{head}", _top_df_vocab(docs, head)))
    for dim in dims:
        for suffix, vocab in variants:
            if vocab is not None and vocab.size >= dim:
                continue
            hashed = _hashed_rank(docs, queries, k, dim, vocab)

            def mean_overlap(ref):
                return float(np.mean([
                    len(set(ref[i]) & set(hashed[i])) / k
                    for i in range(n_queries)
                ]))

            result["overlap_at_k"][f"{dim}{suffix}"] = {
                "vs_word_bm25": round(mean_overlap(exact_words), 4),
                "vs_feature_bm25": round(mean_overlap(exact_feats), 4),
                "top1_vs_feature": round(float(np.mean([
                    exact_feats[i][0] == hashed[i][0]
                    for i in range(n_queries)
                ])), 4),
            }
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description="hashed-BM25 fidelity")
    parser.add_argument("--docs", type=int, default=2000)
    parser.add_argument("--queries", type=int, default=64)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--dims", nargs="+", type=int,
                        default=[1024, 2048, 4096, 16384])
    parser.add_argument("--head", type=int, default=0,
                        help="also measure with a top-df vocab head of "
                             "this size (core/vocab.py)")
    args = parser.parse_args()
    print(json.dumps(
        measure_fidelity(args.docs, args.queries, args.k, args.dims,
                         head=args.head),
        indent=2,
    ))


if __name__ == "__main__":
    main()
