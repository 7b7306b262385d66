"""Retrieval quality metrics: recall@k, MRR, nDCG@k.

Same definitions as the reference harness (reference: eval/run_eval.py:
14-75): binary relevance, recall normalized by |relevant| (not min(k, .)),
nDCG against an ideal list of min(|relevant|, k) ones, macro-averaged over
queries that have at least one relevant id.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Sequence


def dcg(relevances: Sequence[int]) -> float:
    return sum(
        rel / math.log2(rank + 1)
        for rank, rel in enumerate(relevances, start=1)
        if rel > 0
    )


def compute_metrics(
    gold: Dict[str, List[str]],
    results: Dict[str, List[str]],
    ks: Sequence[int] = (5, 10, 20),
) -> Dict[str, float]:
    totals: Dict[str, float] = {f"recall@{k}": 0.0 for k in ks}
    totals["mrr"] = 0.0
    for k in ks:
        totals[f"ndcg@{k}"] = 0.0

    evaluated = 0
    for query_id, relevant_ids in gold.items():
        if not relevant_ids:
            continue
        evaluated += 1
        retrieved = results.get(query_id, [])
        relevant = set(relevant_ids)

        reciprocal = 0.0
        for rank, doc_id in enumerate(retrieved, start=1):
            if doc_id in relevant:
                reciprocal = 1.0 / rank
                break
        totals["mrr"] += reciprocal

        for k in ks:
            top = retrieved[:k]
            hits = sum(1 for doc_id in top if doc_id in relevant)
            totals[f"recall@{k}"] += hits / max(len(relevant_ids), 1)
            gains = [1 if doc_id in relevant else 0 for doc_id in top]
            ideal = [1] * min(len(relevant_ids), k)
            totals[f"ndcg@{k}"] += dcg(gains) / (dcg(ideal) or 1.0)

    if evaluated == 0:
        return {key: 0.0 for key in totals}
    return {key: value / evaluated for key, value in totals.items()}


def load_jsonl(path: str | Path) -> List[dict]:
    rows = []
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if line:
            rows.append(json.loads(line))
    return rows
