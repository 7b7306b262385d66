"""Loading a cell's data into the program: the device index and the store.

``install_corpus`` hands one of the port's ``CorpusIndex`` objects the
corpus of ``traffic/corpus.py`` through the index's own restore path,
``CorpusIndex.load_state_streaming``, one block of rows at a time (doc id
= row + 1), as a restore from a checkpoint would. ``write_store`` is the
benchmark's bulk loader: the calls and, where the cell reads rows, every
chunk, artifact and artifact chunk, in one transaction through a
connection of its own into the store the port created (its schema,
triggers and indexes), while the port holds the store closed.
"""

from __future__ import annotations

import sqlite3
from datetime import datetime, timezone
from typing import Any, Dict, Iterator

import numpy as np
import torch

from .traffic import corpus as gen
from .traffic import texts
from .traffic.queries import call_uuid


def install_corpus(corpus, config: Dict[str, Any], name: str, seed: int) -> None:
    """Fill the port's ``corpus`` (``index.chunks`` or ``index.artifacts``)
    with the configuration's rows of corpus ``name``."""
    n, cap = gen.rows(config, name), gen.capacity(config, name)
    if str(corpus.emb_dtype).split(".")[-1] != config["embedding_dtype"]:
        raise RuntimeError(f"{corpus.name} stores {corpus.emb_dtype}, the "
                           f"configuration {config['embedding_dtype']}")
    corpus.load_state_streaming(_shards(corpus.device, config, name, seed),
                                gen.doc_freq(config, name, seed),
                                texts.dl_sum(seed, name, n), n)
    if corpus.capacity != cap or corpus.count != n:
        raise RuntimeError(f"{corpus.name} holds {corpus.count} rows at capacity "
                           f"{corpus.capacity}; the configuration {n} at {cap}")


def _shards(device, config: Dict[str, Any], name: str, seed: int
            ) -> Iterator[Dict[str, Any]]:
    """The corpus's blocks in row order, as ``load_state_streaming`` takes
    them: the embeddings a device tensor in the stored type, the rest host
    arrays. The lexical block, the largest, goes through one page-locked
    buffer: the index uploads each block before it asks for the next."""
    starts = gen.call_starts(config, seed)
    lex = None
    for block in range(gen.n_blocks(config, name)):
        r0, r1 = gen.block_range(config, name, block)
        made = gen.make_block(config, name, seed, block, device)
        if lex is None:
            lex = torch.empty(made["lex"].shape, dtype=torch.int8,
                              pin_memory=torch.device(device).type == "cuda")
        host_lex = lex[:r1 - r0]
        host_lex.copy_(made["lex"])
        call = gen.call_of_rows(config, name, r0, r1, "cpu").numpy()
        yield {"ids": np.arange(r0 + 1, r1 + 1, dtype=np.int64),
               "emb": made["emb"],
               "lex": host_lex.numpy(),
               "tech": made["tech"].cpu().numpy(),
               "call": call.astype(np.int32),
               "started": starts[call].astype(np.int32),
               "has_emb": np.ones(r1 - r0, dtype=bool)}
        del made


def _iso(sec: int) -> str:
    return datetime.fromtimestamp(int(sec), timezone.utc).isoformat()


def write_store(path: str, config: Dict[str, Any], seed: int, rows: bool) -> None:
    """The calls (``call_seq`` = call, ids ``call_uuid``) and, with
    ``rows``, every chunk, artifact and artifact chunk of the corpus, in
    one transaction. The store must exist (the port creates its schema)
    and no connection may be open on it."""
    calls = int(config["calls"])
    starts = [_iso(s) for s in gen.call_starts(config, seed)]
    n_c, n_a = gen.rows(config, "chunks"), gen.rows(config, "artifacts")
    conn = sqlite3.connect(path, isolation_level=None)
    try:
        # no other connection is open: the rows are written once, into the
        # database file (no write-ahead log to copy back), and a page cache
        # that holds the transaction writes each page once, at commit
        conn.execute("PRAGMA journal_mode = OFF")
        conn.execute("PRAGMA synchronous = OFF")
        conn.execute("PRAGMA cache_size = -2097152")
        conn.execute("PRAGMA foreign_keys = ON")
        conn.execute("BEGIN IMMEDIATE")
        conn.executemany(
            "INSERT INTO calls (call_id, call_seq, started_at, title) VALUES (?,?,?,?)",
            ((call_uuid(c), c, starts[c], f"call {c}") for c in range(calls)))
        if rows:
            uuids = [call_uuid(c) for c in range(calls)]
            conn.executemany(
                "INSERT INTO chunks (chunk_id, call_id, call_started_at, speaker,"
                " start_ts_ms, end_ts_ms, token_count, text, tech_tokens, lex_dl)"
                " VALUES (?,?,?,?,?,?,?,?,'[]',?)",
                _chunk_rows(config, seed, n_c, calls, uuids, starts))
            conn.executemany(
                "INSERT INTO analysis_artifacts (artifact_id, call_id, "
                "call_started_at, kind, content, token_count) VALUES (?,?,?,?,?,?)",
                ((r + 1, uuids[c], starts[c], "summary", text, n)
                 for r, c, text, n in _artifact_rows(seed, n_a, calls)))
            conn.executemany(
                "INSERT INTO artifact_chunks (artifact_chunk_id, artifact_id, "
                "call_id, call_started_at, kind, ordinal, content, token_count, "
                "lex_dl) VALUES (?,?,?,?,'summary',0,?,?,?)",
                ((r + 1, r + 1, uuids[c], starts[c], text, n, n)
                 for r, c, text, n in _artifact_rows(seed, n_a, calls)))
        conn.execute("COMMIT")
    finally:
        conn.close()


def _chunk_rows(config, seed, n, calls, uuids, starts):
    for r0 in range(0, n, gen.BLOCK_ROWS):
        r1 = min(n, r0 + gen.BLOCK_ROWS)
        block, tokens = texts.texts(seed, "chunks", r0, r1)
        for r, text, k in zip(range(r0, r1), block, tokens.tolist()):
            call = r * calls // n
            ts = texts.start_ts_ms(config, n, r)
            yield (r + 1, uuids[call], starts[call], texts.speaker(r), ts, ts + 14000,
                   k, text, k)


def _artifact_rows(seed, n, calls):
    """(row, call, text, tokens) of every artifact chunk (one an artifact)."""
    for r0 in range(0, n, gen.BLOCK_ROWS):
        r1 = min(n, r0 + gen.BLOCK_ROWS)
        block, tokens = texts.texts(seed, "artifacts", r0, r1)
        for r, text, k in zip(range(r0, r1), block, tokens.tolist()):
            yield r, r * calls // n, text, k
