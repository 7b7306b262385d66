"""The text of each stored row, a function of (config, seed, row).

Rows are as long as the upstream service's chunker makes them: a target of
350 tokens, at most 600 (``TARGET_TOKENS``, ``MAX_TOKENS``). A row's token
count is drawn from its hash: 300-400 tokens, and one row in eight up to
200 more. Its text is the row's id in brackets and three words for every
four tokens, a run of ``POOL_WORDS`` pseudo-words starting at a place drawn
from the same hash: about 1,600 characters at 350 tokens, 2,700 at 600.
The store holds the token count as the row's ``token_count`` and
``lex_dl``, and the index's ``dl_sum`` is their sum. The reference works
out the text of any row again from here to check the snippets an evidence
pack returns.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np

from .queries import rng_for, vocabulary

TARGET_TOKENS = 350
MAX_TOKENS = 600
POOL_WORDS = 1 << 20
_VOCAB = {"vocabulary": {"words": 4096, "seed": 7}}
_CORPUS = {"chunks": 0, "artifacts": 1}
_M64 = (1 << 64) - 1


@functools.lru_cache(maxsize=1)
def _pool() -> Tuple[str, np.ndarray]:
    """(the pool's text, (POOL_WORDS + 1,) offset of each word's start)."""
    words = vocabulary(_VOCAB)
    picks = rng_for(0, 30).integers(0, len(words), POOL_WORDS)
    chosen = [words[j] for j in picks]
    lengths = np.fromiter((len(w) + 1 for w in chosen), np.int64, POOL_WORDS)
    offsets = np.zeros(POOL_WORDS + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return " ".join(chosen) + " ", offsets


def _hash(seed: int, corpus: str, rows: np.ndarray) -> np.ndarray:
    """(n,) uint64 splitmix64 of (seed, corpus, row)."""
    x = np.asarray(rows, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    x ^= np.uint64((int(seed) * 0xD1B54A32D192ED03 + _CORPUS[corpus]) & _M64)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def tokens(seed: int, corpus: str, rows: np.ndarray) -> np.ndarray:
    """(n,) int64: each row's token count, 300-600."""
    h = _hash(seed, corpus, rows)
    n = 300 + (h % np.uint64(101)).astype(np.int64)
    long = ((h >> np.uint64(12)) % np.uint64(8)) == 0
    extra = ((h >> np.uint64(16)) % np.uint64(MAX_TOKENS - 400 + 1)).astype(np.int64)
    return n + np.where(long, extra, 0)


def texts(seed: int, corpus: str, r0: int, r1: int) -> Tuple[list, np.ndarray]:
    """Rows ``[r0, r1)`` of ``corpus``: ([text], (r1 - r0,) token counts)."""
    pool, offsets = _pool()
    rows = np.arange(r0, r1, dtype=np.int64)
    h = _hash(seed, corpus, rows)
    n = tokens(seed, corpus, rows)
    start = ((h >> np.uint64(24)) % np.uint64(POOL_WORDS - MAX_TOKENS)).astype(np.int64)
    lo = offsets[start]
    hi = offsets[start + n * 3 // 4] - 1
    head = "[{}] " if corpus == "chunks" else "[summary {}] "
    out = [head.format(r + 1) + pool[a:b] + "."
           for r, a, b in zip(rows.tolist(), lo.tolist(), hi.tolist())]
    return out, n


def chunk_text(seed: int, row: int) -> str:
    return texts(seed, "chunks", row, row + 1)[0][0]


def artifact_text(seed: int, row: int) -> str:
    return texts(seed, "artifacts", row, row + 1)[0][0]


def dl_sum(seed: int, corpus: str, n: int) -> int:
    """The sum of the first ``n`` rows' token counts: the index's ``dl_sum``."""
    return int(tokens(seed, corpus, np.arange(n, dtype=np.int64)).sum())


def speaker(row: int) -> str:
    return "Ana" if row % 2 == 0 else "Ben"


def first_row_of_call(config: Dict[str, Any], corpus_rows: int, call: int) -> int:
    """The first row r with r * calls // rows == call."""
    calls = int(config["calls"])
    return -(-call * corpus_rows // calls)


def start_ts_ms(config: Dict[str, Any], corpus_rows: int, row: int) -> int:
    """A chunk's offset in its call: 15 s a chunk."""
    call = row * int(config["calls"]) // corpus_rows
    return (row - first_row_of_call(config, corpus_rows, call)) * 15000
