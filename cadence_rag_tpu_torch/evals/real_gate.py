"""End-to-end regression gate over a disposable store + device index.

Counterpart of ``cadence_rag_tpu/evals/real_gate.py`` on the port's
engine, on the device the caller names. Flow parity with the reference
gate (reference: eval/run_real_regression_gate.py:93-388): create an
isolated namespace (temp SQLite store + fresh device index instead of a
temp Postgres schema), ingest the fixture corpus, embed it (deterministic
in-process provider, so the dense lane is exercised — the reference gate
runs lexical-only), resolve gold ids, run retrieve_evidence(ids_only) per
gold query, compute recall@k / MRR / nDCG@k, and fail below thresholds
(defaults mrr>=0.60, recall@20>=0.80, ndcg@10>=0.70). ``build_vocab``
gates the learned vocab head end to end and ``rerank_provider`` the rerank
lane (``lexical``, or the cross-encoder of ``reranker_params_path`` with
``neural``/``neural_raw``); ``provider="neural"`` embeds with the weights of
``embedder_params_path``. The in-process models live on ``device`` too.

Usage: python -m cadence_rag_tpu_torch.evals.real_gate [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

from ..config import settings
from ..device import DeviceLike
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)

DEFAULT_THRESHOLDS = {"min_mrr": 0.60, "min_recall20": 0.80, "min_ndcg10": 0.70}


def run_gate(
    *,
    device: DeviceLike = "cuda",
    keep_store: bool = False,
    min_mrr: float = DEFAULT_THRESHOLDS["min_mrr"],
    min_recall20: float = DEFAULT_THRESHOLDS["min_recall20"],
    min_ndcg10: float = DEFAULT_THRESHOLDS["min_ndcg10"],
    store_dir: Optional[str] = None,
    provider: str = "stub",
    embedder_params_path: Optional[str] = None,
    build_vocab: bool = False,
    rerank_provider: str = "",
    reranker_params_path: str = "",
) -> Dict:
    from ..core.index import get_index, reset_index
    from ..device import set_models_device
    from ..models.embedder import NeuralEmbeddingProvider
    from ..models.reranker import NeuralReranker
    from ..store.db import reset_store

    workdir = Path(store_dir or tempfile.mkdtemp(prefix="cadence_gate_"))
    workdir.mkdir(parents=True, exist_ok=True)
    saved = {
        key: getattr(settings, key)
        for key in ("store_path", "embeddings_provider", "embeddings_base_url",
                    "index_initial_capacity", "embedder_params_path",
                    "rerank_enabled", "rerank_provider",
                    "reranker_params_path")
    }
    settings.store_path = str(workdir / "gate.db")
    settings.embeddings_provider = provider
    settings.embeddings_base_url = ""
    settings.index_initial_capacity = 256
    if rerank_provider:
        # gate the FULL path with the rerank lane on: the fixture gate is
        # the lexically-saturated register a reranker must not regress
        settings.rerank_enabled = True
        settings.rerank_provider = rerank_provider
        if reranker_params_path:
            settings.reranker_params_path = reranker_params_path
        NeuralReranker.reset()
    if embedder_params_path is not None:
        settings.embedder_params_path = embedder_params_path
        NeuralEmbeddingProvider._instance = None  # rebind to these weights
    reset_store()
    reset_index()
    try:
        from ..embed.pipeline import run_embedding_backfill
        from ..engine.retrieve import retrieve_evidence_batch
        from ..schemas import RetrieveRequest
        from .fixtures import GOLD_QUERIES, ingest_fixtures, resolve_gold
        from .metrics import compute_metrics

        set_models_device(get_index(device).device)
        ingest_fixtures()
        run_embedding_backfill(batch_size=16, source="real_gate")
        if build_vocab:
            # gate the learned vocab head end-to-end: build + re-featurize
            # (scripts/build_lex_vocab flow), then run the same queries
            from ..core.vocab import build_and_apply
            from ..store.db import get_store

            build_and_apply(get_store(), get_index(), head=256)
        gold = resolve_gold()
        for query_id, ids in gold.items():
            if not ids:
                raise RuntimeError(f"gold resolution empty for {query_id}")

        # the production batched path: all gold queries in one dispatch group
        responses = retrieve_evidence_batch([
            RetrieveRequest(query=query, return_style="ids_only")
            for _query_id, query, _needles in GOLD_QUERIES
        ])
        results: Dict[str, List[str]] = {
            query_id: response["retrieved_ids"]
            for (query_id, _q, _n), response in zip(GOLD_QUERIES, responses)
        }

        metrics = compute_metrics(gold, results, ks=(5, 10, 20))
        failures = []
        if metrics["mrr"] < min_mrr:
            failures.append(f"mrr {metrics['mrr']:.4f} < {min_mrr}")
        if metrics["recall@20"] < min_recall20:
            failures.append(f"recall@20 {metrics['recall@20']:.4f} < {min_recall20}")
        if metrics["ndcg@10"] < min_ndcg10:
            failures.append(f"ndcg@10 {metrics['ndcg@10']:.4f} < {min_ndcg10}")
        return {"metrics": metrics, "failures": failures, "workdir": str(workdir)}
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        reset_index()
        if embedder_params_path is not None:
            NeuralEmbeddingProvider._instance = None
        if rerank_provider:
            NeuralReranker.reset()
        if not keep_store:
            shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    parser = argparse.ArgumentParser(description="end-to-end regression gate")
    parser.add_argument("--device", default="cuda",
                        help="device of the index: cuda (default) or cpu")
    parser.add_argument("--keep-store", action="store_true")
    parser.add_argument("--min-mrr", type=float,
                        default=DEFAULT_THRESHOLDS["min_mrr"])
    parser.add_argument("--min-recall20", type=float,
                        default=DEFAULT_THRESHOLDS["min_recall20"])
    parser.add_argument("--min-ndcg10", type=float,
                        default=DEFAULT_THRESHOLDS["min_ndcg10"])
    parser.add_argument("--provider", default="stub",
                        choices=["stub", "neural", "http"])
    parser.add_argument("--embedder-params", default=None,
                        help="weights for --provider neural")
    args = parser.parse_args()
    configure_logging(settings.log_level)
    outcome = run_gate(
        device=args.device,
        keep_store=args.keep_store,
        min_mrr=args.min_mrr,
        min_recall20=args.min_recall20,
        min_ndcg10=args.min_ndcg10,
        provider=args.provider,
        embedder_params_path=args.embedder_params,
    )
    print(json.dumps(outcome["metrics"], indent=2))
    if outcome["failures"]:
        print("GATE FAILED:", "; ".join(outcome["failures"]), file=sys.stderr)
        sys.exit(1)
    print("GATE PASSED")


if __name__ == "__main__":
    main()
