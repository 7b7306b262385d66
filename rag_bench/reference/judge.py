"""Holding served answers to the reference's.

The number compared, ``rrf_gap``: for each compared position p of a
served list, the reference's p-th best fused score less the reference's
fused score of the id served at p (0 for an id the reference's lanes do not
hold); the widest such gap over the sample. Near-ties between rows (two
dense scores closer than the program's rounding, an approximate lane that
misses a row far down its list) move a served id by a rank or two and give
gaps of a few 1e-4; a lane scored wrongly moves ids by many ranks or out of
the list and gives gaps of 1e-2 (1/60 is a whole lane's first place).

``embed_gap``: the widest elementwise |served - reference| over the
compared queries' vectors, the served one as the engine's embedder gave it
(float32, widened) and the reference one from the deployment's plain
reference embedder, both float64.

``wrong_answers`` counts what is wrong whatever the scores: an id that is
not an id of the corpus, an id served twice, fewer ids than compared
positions, a pack whose snippet is not its row's stored text, or whose
call, speaker or time is not its row's, and a compared query that has no
served vector.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..traffic import corpus as gen
from ..traffic import texts
from ..traffic.queries import call_uuid

MAX_ARTIFACTS = 2
MAX_QUOTES_PER_CALL = 2
SNIPPET_CHARS = 800
MAX_ITEMS = 8
MAX_CHARS = 6000

Fused = Dict[str, List[Tuple[int, float]]]


def _clip(text: str, max_chars: int) -> str:
    if max_chars <= 0:
        return ""
    if len(text) <= max_chars:
        return text
    return text[:max_chars - 1].rstrip() + "…"


def vectors(served: Mapping[str, Any], texts: Sequence[str], reference: np.ndarray
            ) -> Tuple[np.ndarray, float, int]:
    """The compared queries' served vectors against the reference's ->
    (the vectors the reference's dense lane takes, (n, dim) float64: the
    served one, or the reference's where none was served; embed_gap; the
    queries with no served vector)."""
    out = np.array(reference, dtype=np.float64)
    gap, missing = 0.0, 0
    for i, text in enumerate(texts):
        vector = served.get(text)
        if vector is None:
            missing += 1
            continue
        out[i] = np.asarray(vector, dtype=np.float32)     # as the engine takes it
        gap = max(gap, float(np.abs(out[i] - reference[i]).max()))
    return out, gap, missing


def _gaps(ref: List[Tuple[Any, float]], served: List[Any], depth: int,
          score: Optional[Dict[Any, float]] = None) -> Tuple[float, int]:
    """-> (widest gap over the first ``depth`` positions of ``ref``, wrong);
    ``score`` holds every id's fused score (default: ``ref``'s)."""
    score = dict(ref) if score is None else score
    want = [s for _, s in ref[:depth]]
    wrong = len(served) != len(set(served)) or any(s is None for s in served)
    gap = 0.0
    for p, best in enumerate(want):
        got = score.get(served[p], 0.0) if p < len(served) else 0.0
        gap = max(gap, best - got)
    return gap, int(wrong or len(served) < len(want))


def ids_only(ref: Fused, answer: Dict[str, Any], config: Dict[str, Any],
             depth: int) -> Tuple[float, int]:
    """An ids_only answer: ``retrieved_ids`` against both corpora's fused
    lists merged as the service merges them (score desc, artifact chunks
    before chunks on a tie, then id)."""
    merged = sorted(
        [(("artifact_chunk", row + 1), s) for row, s in ref["artifacts"]]
        + [(("chunk", row + 1), s) for row, s in ref["chunks"]],
        key=lambda kv: (-kv[1], kv[0][0] != "artifact_chunk", kv[0][1]))
    served = [_parse(x, config) for x in answer.get("retrieved_ids", [])]
    return _gaps(merged, served, depth)


def _parse(item: Any, config: Dict[str, Any]) -> Optional[Tuple[str, int]]:
    if not isinstance(item, str) or ":" not in item:
        return None
    kind, _, num = item.partition(":")
    corpus = {"chunk": "chunks", "artifact_chunk": "artifacts"}.get(kind)
    if corpus is None or not num.isdigit():
        return None
    if not 1 <= int(num) <= gen.rows(config, corpus):
        return None
    return kind, int(num)


def pack(ref: Fused, answer: Dict[str, Any], config: Dict[str, Any], seed: int
         ) -> Tuple[float, int]:
    """An evidence pack: its artifacts and quotes against the fused lists
    (at most two artifacts; quotes in fused order, at most two a call),
    each snippet against its row's stored text under the pack's budget."""
    n_c, n_a = gen.rows(config, "chunks"), gen.rows(config, "artifacts")
    calls = int(config["calls"])
    arts = answer.get("artifacts") or []
    quotes = answer.get("quotes") or []
    a_all = {row + 1: s for row, s in ref["artifacts"]}
    c_all = {row + 1: s for row, s in ref["chunks"]}
    a_ref = [(row + 1, s) for row, s in ref["artifacts"]][:MAX_ARTIFACTS]
    q_ref, per_call = [], {}
    for row, s in ref["chunks"]:
        call = row * calls // n_c
        if per_call.get(call, 0) < MAX_QUOTES_PER_CALL:
            per_call[call] = per_call.get(call, 0) + 1
            q_ref.append((row + 1, s))
    budget = answer.get("budget") or {}
    items = int(budget.get("max_evidence_items", MAX_ITEMS))
    q_ref = q_ref[:max(0, items - len(a_ref))]
    gap_a, wrong_a = _gaps(a_ref, [a.get("artifact_chunk_id") for a in arts],
                           len(a_ref), a_all)
    gap_q, wrong_q = _gaps(q_ref, [q.get("chunk_id") for q in quotes], len(q_ref),
                           c_all)
    wrong = wrong_a + wrong_q + int(len(arts) > len(a_ref) or len(quotes) > len(q_ref))
    served_texts, served_ok = [], []
    for a in arts:
        doc = a.get("artifact_chunk_id")
        ok = isinstance(doc, int) and 1 <= doc <= n_a
        served_ok.append(ok and a.get("call_id") == call_uuid((doc - 1) * calls // n_a)
                         and a.get("artifact_id") == doc)
        served_texts.append(texts.artifact_text(seed, doc - 1) if ok else "")
    for q in quotes:
        doc = q.get("chunk_id")
        ok = isinstance(doc, int) and 1 <= doc <= n_c
        row = doc - 1 if ok else 0
        ts = texts.start_ts_ms(config, n_c, row)
        served_ok.append(ok and q.get("call_id") == call_uuid(row * calls // n_c)
                         and q.get("speaker") == texts.speaker(row)
                         and q.get("start_ts_ms") == ts and q.get("end_ts_ms") == ts + 14000)
        served_texts.append(texts.chunk_text(seed, row) if ok else "")
    want = snippets(served_texts, int(budget.get("max_total_chars", MAX_CHARS)))
    for item, ok, snippet in zip(arts + quotes, served_ok, want):
        wrong += int(not ok or snippet is None or item.get("snippet") != snippet)
    return max(gap_a, gap_q), wrong


def snippets(full: List[str], budget_chars: int) -> List[Optional[str]]:
    """The snippets of a pack whose items have these texts, in the pack's
    order (artifacts, then quotes): each clipped to ``SNIPPET_CHARS`` and to
    what the pack's character budget has left; None from where the budget
    is spent, since the pack stops there."""
    out: List[Optional[str]] = []
    remaining = budget_chars
    for text in full:
        if remaining <= 0:
            out.append(None)
            continue
        snippet = _clip(text, min(SNIPPET_CHARS, remaining))
        remaining -= len(snippet)
        out.append(snippet)
    return out
