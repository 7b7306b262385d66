"""The plain reference: each query's three lanes per corpus, and RRF.

What the deployment states a request returns (the upstream service's
``app/retrieve.py``): per corpus, the dense lane (cosine of the query's
embedding with every row's, the best ``k_dense``), the lexical lane (the
query's idf-weighted vector against each row's signature, rows scoring
above 1e-3, the best ``k_lex``) and the tech lane (rows holding one of the
query's tech tokens, the most recent call first, then the lowest row, the
first ``k_tech``), over the rows the request's filters allow (its call,
when it names one); ties go to the lowest row. RRF fuses a corpus's lanes
in the order lexical, tech, dense: a row scores the sum of 1/(60 + rank)
over the lanes that hold it.

Search over every row, in float64, corpus block by block from the seed
(``traffic/corpus.py``): nothing of the program is read but the query
vectors it served. The dense lane takes each query's vector as the
program's embedder served it (recorded in the window, ``serve.EmbedLog``),
which the run judges on its own against the deployment's plain reference
embedder (``embedders/``, ``embed_gap``): a float32 or bfloat16 encoder
differs from float64 by far more than neighbouring dense scores over
millions of rows, so a reference embedding of its own would swap their
ranks. The lexical and tech lanes come from the text. The dense lane
compares the query and the rows in the embedding type the deployment
states, bfloat16, on both sides. A corpus searched in the ``ann`` plan mode
takes its dense and lexical lanes from candidates, as that mode is
defined: the best row of each group of 8 (group g of 1,024-row block b is
rows ``b*1024 + w*128 + g``; the lowest row wins a tie), then the best k
candidates (the lowest candidate, b*128 + g, first among ties); the
``exact`` mode searches every row. The control (``precision="int8"``,
``readings.py``) scores the dense lane with both sides rounded to int8
(``round(127 x)``), the step below the bfloat16 that the deployment
states.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..traffic import corpus as gen
from . import features

RRF_K = 60
LEX_THRESHOLD = 1e-3
LANES = ("lex", "tech", "dense")
MODES = ("ann", "exact")
# the ann mode's candidate groups
GROUP_BLOCK, GROUPS = 1024, 128


def lane_ks(config: Dict[str, Any], corpus: str) -> Dict[str, int]:
    dense, lex, tech = config["lane_k"][corpus]
    return {"dense": int(dense), "lex": int(lex), "tech": int(tech)}


class _Best:
    """A running best-k of float scores, ties to the lowest row."""

    def __init__(self, batch: int, k: int, device):
        self.k = k
        self.vals = torch.full((batch, 0), float("-inf"), dtype=torch.float64,
                               device=device)
        self.rows = torch.zeros((batch, 0), dtype=torch.int64, device=device)

    def add(self, scores: torch.Tensor, rows: torch.Tensor) -> None:
        """``scores`` (B, n) of ``rows`` (B, n) or (n,), in the order that
        wins a tie."""
        # earlier blocks' rows come first and each part is in tie order, so a
        # stable sort keeps the first among equal scores
        vals = torch.cat([self.vals, scores], dim=1)
        cat_rows = torch.cat([self.rows, rows.expand(scores.shape[0], -1)], dim=1)
        order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :self.k]
        self.vals = torch.gather(vals, 1, order)
        self.rows = torch.gather(cat_rows, 1, order)

    def lists(self) -> List[List[int]]:
        keep = torch.isfinite(self.vals).cpu().numpy()
        rows = self.rows.cpu().numpy()
        return [rows[i][keep[i]].tolist() for i in range(rows.shape[0])]


class _Recent:
    """A running first-k of the tech lane's (start second desc, row asc)."""

    def __init__(self, batch: int, k: int, device):
        self.k = k
        self.keys = torch.zeros((batch, 0), dtype=torch.int64, device=device)

    def add(self, match: torch.Tensor, started: torch.Tensor, r0: int) -> None:
        rows = torch.arange(r0, r0 + match.shape[1], device=match.device)
        key = (started[None, :] << 32) | (0xFFFFFFFF - rows)[None, :]
        key = torch.where(match, key, torch.full_like(key, -1))
        keys = torch.cat([self.keys, key], dim=1)
        self.keys = torch.topk(keys, min(self.k, keys.shape[1]), dim=1).values

    def lists(self) -> List[List[int]]:
        keys = self.keys.cpu().numpy()
        return [(0xFFFFFFFF - (row[row >= 0] & 0xFFFFFFFF)).tolist() for row in keys]


def _dense_scores(q: torch.Tensor, emb: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "int8":
        q8 = torch.clamp(torch.round(q * 127.0), -127, 127)
        e8 = torch.clamp(torch.round(emb.double() * 127.0), -127, 127)
        return (q8 @ e8.T) / (127.0 * 127.0)
    q16 = q.to(torch.bfloat16).double()
    return q16 @ emb.double().T


def group_best(scores: torch.Tensor, r0: int) -> tuple:
    """(B, n) scores of rows r0.. (r0 a multiple of ``GROUP_BLOCK``) -> the
    ann mode's candidates: (values (B, m), rows (B, m)), one per group in
    candidate order, the lowest row of a group winning a tie; -inf where a
    group holds no row."""
    batch, n = scores.shape
    blocks = -(-n // GROUP_BLOCK)
    pad = blocks * GROUP_BLOCK - n
    if pad:
        scores = torch.cat([scores, torch.full((batch, pad), float("-inf"),
                                               dtype=scores.dtype,
                                               device=scores.device)], dim=1)
    tiles = scores.view(batch, blocks, GROUP_BLOCK // GROUPS, GROUPS)
    # the first of equal maxima along w is the lowest row
    vals, w = tiles.max(dim=2)
    base = (r0 + torch.arange(blocks, device=scores.device)[:, None] * GROUP_BLOCK
            + torch.arange(GROUPS, device=scores.device)[None, :])
    rows = base[None] + w * GROUPS
    return vals.reshape(batch, -1), rows.reshape(batch, -1)


def lanes(config: Dict[str, Any], corpus: str, seed: int,
          queries: Sequence[Dict[str, Any]], device, mode: str,
          precision: str = "bf16") -> List[Dict[str, List[int]]]:
    """Each query's lanes over ``corpus`` in plan ``mode`` -> [{lane: rows,
    best first}]. A query is {"emb": (dim,) float64, "lex": {corpus:
    (lexical_dim,) float64}, "tech": int64 hashes, "call": int or None}."""
    if mode not in MODES:
        raise ValueError(f"plan mode {mode!r}: one of {MODES}")
    ks = lane_ks(config, corpus)
    batch = len(queries)
    q_emb = torch.from_numpy(np.stack([q["emb"] for q in queries])).to(device)
    q_lex = torch.from_numpy(np.stack([q["lex"][corpus] for q in queries])).to(device)
    width = max(1, max(len(q["tech"]) for q in queries))
    q_tech = torch.full((batch, width), -1, dtype=torch.int64)
    for i, q in enumerate(queries):
        q_tech[i, :len(q["tech"])] = torch.from_numpy(q["tech"])
    q_tech = q_tech.to(device)
    calls = torch.tensor([-1 if q["call"] is None else q["call"] for q in queries],
                         dtype=torch.int64, device=device)
    starts = torch.from_numpy(gen.call_starts(config, seed)).to(device)
    dense = _Best(batch, ks["dense"], device)
    lex = _Best(batch, ks["lex"], device)
    tech = _Recent(batch, ks["tech"], device)
    neg = torch.tensor(float("-inf"), dtype=torch.float64, device=device)
    for block in range(gen.n_blocks(config, corpus)):
        r0, r1 = gen.block_range(config, corpus, block)
        made = gen.make_block(config, corpus, seed, block, device)
        call = gen.call_of_rows(config, corpus, r0, r1, device)
        allowed = (calls[:, None] < 0) | (calls[:, None] == call[None, :])
        rows = torch.arange(r0, r1, device=device)
        for best, scores in (
                (dense, torch.where(allowed, _dense_scores(q_emb, made["emb"],
                                                           precision), neg)),
                (lex, torch.where(allowed, q_lex @ made["lex"].double().T, neg))):
            if best is lex:
                scores = torch.where(scores > LEX_THRESHOLD, scores, neg)
            best.add(*(group_best(scores, r0) if mode == "ann" else (scores, rows)))
        held = made["tech"].long()
        match = (held[None, :, :, None] == q_tech[:, None, None, :]).any(-1).any(-1)
        tech.add(match & allowed, starts[call], r0)
        del made, scores, match
    out = []
    for lx, tc, dn in zip(lex.lists(), tech.lists(), dense.lists()):
        out.append({"lex": lx, "tech": tc, "dense": dn})
    return out


def rrf(lane_rows: Dict[str, List[int]]) -> List[Tuple[int, float]]:
    """[(row, score)] by score desc, first occurrence breaking ties."""
    scores: Dict[int, float] = {}
    for lane in LANES:
        for rank, row in enumerate(lane_rows.get(lane, []), start=1):
            scores[row] = scores.get(row, 0.0) + 1.0 / (RRF_K + rank)
    first = {row: i for i, row in enumerate(scores)}
    return sorted(scores.items(), key=lambda kv: (-kv[1], first[kv[0]]))


def query_inputs(config: Dict[str, Any], seed: int, texts: Sequence[str],
                 calls: Sequence[Optional[int]], embs: np.ndarray
                 ) -> List[Dict[str, Any]]:
    """The reference's view of each query: its embedding (``embs``, (n,
    dim) float64: the vectors served), its lexical vector under each
    corpus's document frequencies, its tech hashes."""
    lex_dim = int(config["lexical_dim"])
    stats = {c: (gen.doc_freq(config, c, seed), gen.rows(config, c))
             for c in gen.CORPORA}
    return [{"emb": embs[i],
             "lex": {c: features.lexical_query(t, lex_dim, df, n)
                     for c, (df, n) in stats.items()},
             "tech": features.tech_hashes(t), "call": call}
            for i, (t, call) in enumerate(zip(texts, calls))]


def fused(config: Dict[str, Any], seed: int, texts: Sequence[str],
          calls: Sequence[Optional[int]], embs: np.ndarray, device,
          modes: Sequence[str], precision: str = "bf16", block_queries: int = 256
          ) -> List[Dict[str, List[Tuple[int, float]]]]:
    """Each query's RRF list per corpus -> [{corpus: [(row, score)]}];
    ``embs`` are the queries' vectors, ``modes`` the plan modes of the
    chunks and the artifacts."""
    inputs = query_inputs(config, seed, texts, calls, embs)
    out: List[Dict[str, List[Tuple[int, float]]]] = [{} for _ in inputs]
    for q0 in range(0, len(inputs), block_queries):
        part = inputs[q0:q0 + block_queries]
        for corpus, mode in zip(gen.CORPORA, modes):
            for i, lane_rows in enumerate(lanes(config, corpus, seed, part, device,
                                                mode, precision)):
                out[q0 + i][corpus] = rrf(lane_rows)
    return out
