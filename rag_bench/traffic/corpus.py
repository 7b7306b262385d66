"""The deployment's rows, made on the device from the run seed.

The benchmark's own generator: the program and the reference both get the
corpus from here, the program's copy installed by ``load.py``, the
reference's worked out again block by block after the window. Rows are
made in blocks of ``BLOCK_ROWS``, each block from a generator of its own
(seed, corpus, block), so any block can be made again alone.

A row of corpus ``c`` (``chunks`` or ``artifacts``):

- its embedding: a Gaussian vector normalised to unit length, stored in
  the configuration's ``embedding_dtype`` (bfloat16);
- its lexical signature: ``lexical_dim`` int8 values, about
  ``lexical_nonzero_share`` of them nonzero, even values in [-40, 40] (a
  BM25 term weight quantised at 127/4 is about 32);
- its tech slots: 0 to 3 of the deployment's identifiers (``idents.py``),
  with the probabilities ``tech_identifiers_per_row``, each in slot
  ``h % S`` or, when that is taken, ``(h >> 8) % S`` (both taken: left
  out), a repeat left out, 0 in an empty slot;
- its call: calls hold contiguous runs of rows, as ingest appends one
  call's chunks together (row r of n is in call ``r * calls // n``); every
  row of a call has the call's start second.

The corpus's document frequencies (one per lexical bucket) are drawn on
the host, in [1, rows / 4).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import idents
from .queries import rng_for

BLOCK_ROWS = 131072
CORPORA = ("chunks", "artifacts")
# the lexical draw: u uniform in [-_LEX_SPAN, _LEX_SPAN]; |u| <= 20 keeps 2u
_LEX_KEEP = 20


def rows(config: Dict[str, Any], corpus: str) -> int:
    return int(config[f"{corpus}_rows"])


def capacity(config: Dict[str, Any], corpus: str) -> int:
    return int(config[f"{corpus}_capacity"])


def n_blocks(config: Dict[str, Any], corpus: str) -> int:
    return -(-rows(config, corpus) // BLOCK_ROWS)


def block_range(config: Dict[str, Any], corpus: str, block: int) -> Tuple[int, int]:
    r0 = block * BLOCK_ROWS
    return r0, min(rows(config, corpus), r0 + BLOCK_ROWS)


def call_of_rows(config: Dict[str, Any], corpus: str, r0: int, r1: int,
                 device) -> torch.Tensor:
    """(r1 - r0,) int64: each row's call."""
    r = torch.arange(r0, r1, dtype=torch.int64, device=device)
    return r * int(config["calls"]) // rows(config, corpus)


def call_starts(config: Dict[str, Any], seed: int) -> np.ndarray:
    """(calls,) int64: each call's start second."""
    return rng_for(seed, 10).integers(1_600_000_000, 1_750_000_000,
                                      int(config["calls"]))


def doc_freq(config: Dict[str, Any], corpus: str, seed: int) -> np.ndarray:
    n = rows(config, corpus)
    return rng_for(seed, 11, CORPORA.index(corpus)).integers(
        1, max(n // 4, 2), int(config["lexical_dim"])).astype(np.int64)


def _generator(seed: int, corpus: str, block: int, device) -> torch.Generator:
    state = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), 20, CORPORA.index(corpus), block]
    ).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def make_block(config: Dict[str, Any], corpus: str, seed: int, block: int,
               device) -> Dict[str, torch.Tensor]:
    """Rows ``block_range(...)`` -> {"emb" (b, dim) embedding dtype,
    "lex" (b, lexical_dim) int8, "tech" (b, slots) int32}."""
    r0, r1 = block_range(config, corpus, block)
    b = r1 - r0
    dim, lex_dim = int(config["embedding_dim"]), int(config["lexical_dim"])
    slots = int(config["tech_slots"])
    gen = _generator(seed, corpus, block, device)
    emb = torch.randn((b, dim), generator=gen, device=device)
    emb = (emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)).to(
        getattr(torch, config["embedding_dtype"]))
    span = int(round(((2 * _LEX_KEEP + 1) / float(config["lexical_nonzero_share"])
                      - 1) / 2))
    u = torch.randint(-span, span + 1, (b, lex_dim), generator=gen,
                      device=device, dtype=torch.int16)
    lex = torch.where(u.abs() <= _LEX_KEEP, u * 2, 0).to(torch.int8)
    del u
    probs = torch.tensor(config["tech_identifiers_per_row"], dtype=torch.float64)
    edges = torch.cumsum(probs, 0)[:-1].to(device=device, dtype=torch.float32)
    n_ids = torch.bucketize(torch.rand((b,), generator=gen, device=device), edges,
                            right=True)
    table = torch.from_numpy(idents.hashes(config)).to(device)
    picks = torch.randint(0, table.numel(), (b, 3), generator=gen, device=device)
    tech = torch.zeros((b, slots), dtype=torch.int64, device=device)
    for j in range(3):
        h = table[picks[:, j]]
        s1, s2 = (h % slots)[:, None], ((h >> 8) % slots)[:, None]
        cur1, cur2 = tech.gather(1, s1)[:, 0], tech.gather(1, s2)[:, 0]
        free = (j < n_ids) & (cur1 != h) & (cur2 != h)
        put1 = free & (cur1 == 0)
        put2 = free & ~put1 & (cur2 == 0)
        tech.scatter_(1, s1, torch.where(put1, h, cur1)[:, None])
        cur2 = tech.gather(1, s2)[:, 0]
        tech.scatter_(1, s2, torch.where(put2, h, cur2)[:, None])
    return {"emb": emb, "lex": lex, "tech": tech.to(torch.int32)}
