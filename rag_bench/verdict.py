"""The numbers a run is judged by, each with its limit, and the verdict.

One rule for the program's answers (``run.py``) and for the control put in
their place (``readings.py``): ``correct`` holds when every number is within
its limit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

Checks = Dict[str, Dict[str, Any]]


def checks(cell, rrf_gap: float, embed_gap: float, wrong_answers: int,
           window_failures: int, plan_modes: int, answers_compared: int) -> Checks:
    """{name: {"value", "limit"[, "at_least"]}} of one run of ``cell``."""
    limits = cell.own["limits"]
    return {
        "rrf_gap": {"value": rrf_gap, "limit": float(limits["rrf_gap"])},
        "embed_gap": {"value": embed_gap, "limit": float(limits["embed_gap"])},
        "wrong_answers": {"value": wrong_answers, "limit": 0},
        "window_failures": {"value": window_failures, "limit": 0},
        "plan_modes": {"value": plan_modes, "limit": 0},
        # at least half the sample the cell asks for
        "answers_compared": {"value": answers_compared,
                             "limit": int(cell.own["sample"]) // 2, "at_least": True},
    }


def correct(judged: Checks) -> bool:
    return all((c["value"] >= c["limit"]) if c.get("at_least")
               else (c["value"] <= c["limit"]) for c in judged.values())


def log_checks(judged: Checks, log: Callable[[str], None], prefix: str = "check") -> None:
    """One line per number compared, beside its limit."""
    for name, c in judged.items():
        sense = "at least" if c.get("at_least") else "limit"
        log(f"{prefix} {name}: {c['value']!r} ({sense} {c['limit']!r})")
