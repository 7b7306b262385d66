"""The one request generator: a traffic file's parameters -> request bodies.

A traffic file (``traffic/<name>.json``) gives:

- ``return_style``: ``ids_only`` or ``evidence_pack_json``;
- ``scope``: ``none`` (unscoped) or ``one_call`` (``filters.call_ids`` of
  one call, drawn per request);
- ``words``: [least, most] words a query has, drawn uniformly;
- ``identifier_share``: [share with one identifier, share with two];
- ``vocabulary``: {"words": n, "seed": s}: the query words, pseudo-words
  made of consonant-vowel syllables, the same for every run seed.

The identifiers come from the deployment (``idents.py``), so a query's tech
tokens match rows of the corpus. The run seed draws the queries, in chunks
of ``CHUNK`` that each have a generator of their own, so query i can be
made without the ones before it and a run takes as many as its rate needs;
queries are unique within a chunk, and two chunks share one with odds of
about 1e-6 a run. Every seed draws from the same distributions, so the
sizes of the work do not move with the seed.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import idents

_CONSONANTS = "bdfgklmnprstvz"
_VOWELS = "aeiou"

Query = Tuple[str, Optional[int]]      # (text, the call it is scoped to)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for (seed, stream...): any whole seed, negative ones too."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2**64 - 1), *stream]))


def vocabulary(traffic: Dict[str, Any]) -> List[str]:
    """The mix's query words, fixed by its vocabulary seed."""
    spec = traffic["vocabulary"]
    return list(_vocabulary(int(spec["words"]), int(spec["seed"])))


@functools.lru_cache(maxsize=8)
def _vocabulary(n_words: int, seed: int) -> tuple:
    rng = rng_for(seed, 1)
    syllables = [c + v for c in _CONSONANTS for v in _VOWELS]
    words: Dict[str, None] = {}
    while len(words) < n_words:
        n = int(rng.integers(2, 4))
        words["".join(syllables[i] for i in rng.integers(0, len(syllables), n))] = None
    return tuple(words)


def call_uuid(call: int) -> str:
    """The store's id of call ``call`` (its ``call_seq``)."""
    return f"00000000-0000-4000-8000-{call:012d}"


CHUNK = 4096


def query_chunk(traffic: Dict[str, Any], config: Dict[str, Any], seed: int,
                chunk: int, stream: int = 0) -> List[Query]:
    """Queries ``chunk * CHUNK`` to ``(chunk + 1) * CHUNK - 1`` of the run
    (``stream`` separates the warm-up's queries from the window's)."""
    rng = rng_for(seed, 2, stream, chunk)
    spec = traffic["vocabulary"]
    words = _vocabulary(int(spec["words"]), int(spec["seed"]))
    names = idents.identifiers(config)
    lo, hi = traffic["words"]
    one, two = traffic["identifier_share"]
    scoped = traffic["scope"] == "one_call"
    n_calls = int(config["calls"])
    seen = set()
    out: List[Query] = []
    n = CHUNK
    while len(out) < n:
        m = n - len(out)
        lengths = rng.integers(int(lo), int(hi) + 1, m)
        picks = rng.integers(0, len(words), (m, int(hi)))
        u = rng.random(m)
        n_ids = np.where(u < two, 2, np.where(u < two + one, 1, 0))
        id_picks = rng.integers(0, len(names), (m, 2))
        at = rng.random((m, 2))
        calls = rng.integers(0, n_calls, m)
        for i in range(m):
            tokens = [words[j] for j in picks[i, :lengths[i]]]
            for k in range(int(n_ids[i])):
                tokens.insert(int(at[i, k] * (len(tokens) + 1)), names[id_picks[i, k]])
            text = " ".join(tokens)
            if text in seen:
                continue
            seen.add(text)
            out.append((text, int(calls[i]) if scoped else None))
    return out


class Queries:
    """The run's queries as a sequence, each chunk made when first read."""

    def __init__(self, traffic, config, seed: int, stream: int = 0):
        self._args = (traffic, config, seed)
        self._stream = stream
        self._chunks: Dict[int, List[Query]] = {}

    def __getitem__(self, i: int) -> Query:
        chunk = self._chunks.get(i // CHUNK)
        if chunk is None:
            chunk = self._chunks[i // CHUNK] = query_chunk(
                *self._args, i // CHUNK, self._stream)
        return chunk[i % CHUNK]

    def prepare(self, n: int) -> None:
        """Make every chunk of the first ``n`` queries now."""
        for i in range(0, n, CHUNK):
            self[i]


def make_queries(traffic: Dict[str, Any], config: Dict[str, Any], seed: int,
                 n: int, stream: int = 0) -> List[Query]:
    """The run's first ``n`` queries."""
    queries = Queries(traffic, config, seed, stream)
    return [queries[i] for i in range(n)]


def marked(seed: int, i: int, share: float) -> bool:
    """Whether the client keeps query i's answer: a share of the queries,
    drawn from the seed (splitmix64 of seed and i)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (z ^ (z >> 31)) < share * 2.0**64


def body(traffic: Dict[str, Any], query: Query) -> Dict[str, Any]:
    """The POST /retrieve body of one query."""
    text, call = query
    out: Dict[str, Any] = {"query": text, "return_style": traffic["return_style"]}
    if call is not None:
        out["filters"] = {"call_ids": [call_uuid(call)]}
    return out


def warm_texts(traffic: Dict[str, Any], config: Dict[str, Any]) -> List[str]:
    """Texts holding every query word and identifier, in sentences of
    eight, twice in two orders: what the query embedder's per-feature
    cache holds once the mix has run a while."""
    tokens = vocabulary(traffic) + idents.identifiers(config)
    out = []
    for order in range(2):
        perm = rng_for(0, 3, order).permutation(len(tokens))
        out.extend(" ".join(tokens[j] for j in perm[i:i + 8])
                   for i in range(0, len(perm), 8))
    return out
