"""The readings a limit is set from, many seeds in one process.

``python -m rag_bench.readings --workload <name> --seeds 1,2,... --seconds
<s>`` runs the cell (``run.run_cell``, at its full size and load, with a
window of ``--seconds``) once per seed and prints the program's reading of
each number compared. For each seed it also reads the control on the same
sampled queries, the reference put in the program's place one precision
below what the deployment states at both of its steps: the embedder's
control vectors (its ``control``, the plain reference one precision below
the embedder's own; the stub's float32 gives bfloat16) as the vectors
served, and the dense lane in int8 (both sides rounded to ``round(127
x)``, below the index's bfloat16). Its answers and
vectors are judged as the program's are, and given their own verdict by
the rule the program's run is given (``verdict.py``): it has to come out
not correct. The last line is a JSON summary: each seed's readings, the
largest program reading of each gap (the lower end of its limit) and the
smallest control reading (the upper end). The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

import numpy as np

from . import run, verdict
from .reference import judge, search
from .spec import ROOT, load_cell
from .traffic import texts as row_texts
from .traffic.queries import call_uuid


def control_answer(cell, seed: int, fused: Dict[str, Any]) -> Dict[str, Any]:
    """What a program serving the control's lists would answer."""
    cfg = cell.config
    if cell.traffic["return_style"] == "ids_only":
        merged = sorted(
            [(("artifact_chunk", r + 1), s) for r, s in fused["artifacts"]]
            + [(("chunk", r + 1), s) for r, s in fused["chunks"]],
            key=lambda kv: (-kv[1], kv[0][0] != "artifact_chunk", kv[0][1]))
        return {"retrieved_ids": [f"{k}:{n}" for (k, n), _ in merged]}
    n_c = int(cfg["chunks_rows"])
    n_a = int(cfg["artifacts_rows"])
    calls = int(cfg["calls"])
    arts = [{"artifact_chunk_id": r + 1, "artifact_id": r + 1,
             "call_id": call_uuid(r * calls // n_a),
             "snippet": row_texts.artifact_text(seed, r)}
            for r, _ in fused["artifacts"][:judge.MAX_ARTIFACTS]]
    quotes, per_call = [], {}
    for r, _ in fused["chunks"]:
        call = r * calls // n_c
        if per_call.get(call, 0) >= judge.MAX_QUOTES_PER_CALL:
            continue
        per_call[call] = per_call.get(call, 0) + 1
        ts = row_texts.start_ts_ms(cfg, n_c, r)
        quotes.append({"chunk_id": r + 1, "call_id": call_uuid(call),
                       "speaker": row_texts.speaker(r), "start_ts_ms": ts,
                       "end_ts_ms": ts + 14000,
                       "snippet": row_texts.chunk_text(seed, r)})
    items = arts + quotes[:judge.MAX_ITEMS - len(arts)]
    kept = []
    for item, snippet in zip(items, judge.snippets([i["snippet"] for i in items],
                                                   judge.MAX_CHARS)):
        if snippet is None:     # the budget is spent: the pack stops
            break
        kept.append(dict(item, snippet=snippet))
    return {"artifacts": [i for i in kept if "artifact_id" in i],
            "quotes": [i for i in kept if "chunk_id" in i]}


def control_checks(cell, seed: int, sample: Dict[str, Any], device: str
                   ) -> verdict.Checks:
    """The control's numbers, each with its limit: its vectors and answers
    on the program's sampled queries, in the place of the program's (it
    serves every request and in the cell's plan modes)."""
    ref_embs, embs = sample["reference_embs"], sample["control_embs"]
    lists = search.fused(cell.config, seed, sample["texts"], sample["calls"], embs,
                         device, cell.own["modes"], precision="int8")
    answers = [control_answer(cell, seed, f) for f in lists]
    gap, wrong = run.judge_all(cell, seed, sample["reference"], answers)
    embed_gap = float(np.abs(embs - ref_embs).max(initial=0.0))
    return verdict.checks(cell, gap, embed_gap, wrong, 0, 0, len(answers))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = load_cell(args.workload, ROOT)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    seeds = [int(s) for s in args.seeds.split(",")]
    rows: List[Dict[str, Any]] = []
    for seed in seeds:
        out = run.run_cell(cell, seed, args.seconds, False, args.device, log,
                           control=True)
        reading = {k: c["value"] for k, c in out["checks"].items()}
        reading["seed"] = seed
        reading["correct"] = out["result"]["correct"]
        control = control_checks(cell, seed, out["sample"], args.device)
        verdict.log_checks(control, log, prefix=f"seed {seed} control")
        reading["control_rrf_gap"] = control["rrf_gap"]["value"]
        reading["control_embed_gap"] = control["embed_gap"]["value"]
        reading["control_wrong_answers"] = control["wrong_answers"]["value"]
        reading["control_correct"] = verdict.correct(control)
        rows.append(reading)
        print(json.dumps(reading), flush=True)
    print(json.dumps({
        "workload": cell.name, "seconds": args.seconds, "readings": rows,
        "program_rrf_gap_max": max(r["rrf_gap"] for r in rows),
        "control_rrf_gap_min": min(r["control_rrf_gap"] for r in rows),
        "program_embed_gap_max": max(r["embed_gap"] for r in rows),
        "control_embed_gap_min": min(r["control_embed_gap"] for r in rows),
        "program_correct": all(r["correct"] for r in rows),
        "control_ever_correct": any(r["control_correct"] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
