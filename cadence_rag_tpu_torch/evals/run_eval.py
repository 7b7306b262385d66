"""Metrics-only eval CLI (operator surface parity with the reference's
eval/run_eval.py): compute recall@k / MRR / nDCG@k from gold + results
JSONL files, no thresholds.

Usage: python -m cadence_rag_tpu_torch.evals.run_eval --gold gold.jsonl
       --results results.jsonl [--k 5 10 20]
"""

from __future__ import annotations

import argparse
import json

from .metrics import compute_metrics, load_jsonl


def main() -> None:
    parser = argparse.ArgumentParser(description="evaluate retrieval results")
    parser.add_argument("--gold", required=True)
    parser.add_argument("--results", required=True)
    parser.add_argument("--k", nargs="+", type=int, default=[5, 10, 20])
    args = parser.parse_args()
    gold = {
        row["query_id"]: row.get("relevant_ids", [])
        for row in load_jsonl(args.gold)
    }
    results = {
        row["query_id"]: row.get("retrieved_ids", row.get("retrieved", []))
        for row in load_jsonl(args.results)
    }
    print(json.dumps(compute_metrics(gold, results, args.k), indent=2))


if __name__ == "__main__":
    main()
