"""Threshold regression gate over JSONL gold/results files.

Usage: python -m cadence_rag_tpu_torch.evals.gate --gold gold.jsonl
       --results results.jsonl [--min-mrr 0.60] [--min-recall 0.80
       --recall-k 20] [--min-ndcg 0.70 --ndcg-k 10]

Exit 1 when any metric is below threshold (reference:
eval/regression_gate.py:10-61).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from .metrics import compute_metrics, load_jsonl


def evaluate_gate(
    gold: Dict[str, List[str]],
    results: Dict[str, List[str]],
    *,
    min_mrr: float = 0.60,
    min_recall: float = 0.80,
    recall_k: int = 20,
    min_ndcg: float = 0.70,
    ndcg_k: int = 10,
) -> tuple:
    ks = sorted({5, 10, 20, recall_k, ndcg_k})
    metrics = compute_metrics(gold, results, ks)
    failures = []
    if metrics["mrr"] < min_mrr:
        failures.append(f"mrr {metrics['mrr']:.4f} < {min_mrr}")
    if metrics[f"recall@{recall_k}"] < min_recall:
        failures.append(
            f"recall@{recall_k} {metrics[f'recall@{recall_k}']:.4f} < {min_recall}"
        )
    if metrics[f"ndcg@{ndcg_k}"] < min_ndcg:
        failures.append(
            f"ndcg@{ndcg_k} {metrics[f'ndcg@{ndcg_k}']:.4f} < {min_ndcg}"
        )
    return metrics, failures


def main() -> None:
    parser = argparse.ArgumentParser(description="retrieval regression gate")
    parser.add_argument("--gold", required=True)
    parser.add_argument("--results", required=True)
    parser.add_argument("--min-mrr", type=float, default=0.60)
    parser.add_argument("--min-recall", type=float, default=0.80)
    parser.add_argument("--recall-k", type=int, default=20)
    parser.add_argument("--min-ndcg", type=float, default=0.70)
    parser.add_argument("--ndcg-k", type=int, default=10)
    args = parser.parse_args()

    gold = {
        row["query_id"]: row.get("relevant_ids", [])
        for row in load_jsonl(args.gold)
    }
    results = {
        row["query_id"]: row.get("retrieved_ids", row.get("retrieved", []))
        for row in load_jsonl(args.results)
    }
    metrics, failures = evaluate_gate(
        gold, results,
        min_mrr=args.min_mrr,
        min_recall=args.min_recall, recall_k=args.recall_k,
        min_ndcg=args.min_ndcg, ndcg_k=args.ndcg_k,
    )
    print(json.dumps(metrics, indent=2))
    if failures:
        print("GATE FAILED:", "; ".join(failures), file=sys.stderr)
        sys.exit(1)
    print("GATE PASSED")


if __name__ == "__main__":
    main()
