"""SQLite metadata store with ordered migrations and a version gate.

Counterpart of ``cadence_rag_tpu/store/db.py``: the same schema, the same
eight migrations and the same ``Store`` API, so a store file written by the
JAX package opens here and the other way round. Only ``fetch_info`` differs:
it reports the torch runtime and its device instead of jax's.

Replaces the reference's Postgres layer (reference: app/db.py, 8 alembic
migrations in alembic/versions/). Transactions, idempotency constraints and
keyset pagination carry over; vector/lexical/token search does NOT — that
lives on device (core/index.py). Embeddings and lexical signatures are
persisted here as blobs purely for durability/rebuild.

Parity notes:
- partial unique index on (external_id, external_source)  <- alembic 0002
- unique (source_uri, source_hash)                        <- alembic 0004
- transcript_ingests UNIQUE(call_id, transcript_hash)     <- alembic 0008
- ingest_jobs status CHECK + bundle_id unique             <- alembic 0007
- fail-fast version gate at startup                       <- app/db.py:38-63
"""

from __future__ import annotations

import json
import sqlite3
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..config import settings

SCHEMA_VERSION = 8

# Ordered DDL migrations (the reference evolves its schema through 8 alembic
# revisions; we group the same end-state into 4 logical revisions).
MIGRATIONS: List[Tuple[int, str]] = [
    (1, """
    CREATE TABLE calls (
        call_id TEXT PRIMARY KEY,
        call_seq INTEGER UNIQUE NOT NULL,
        external_id TEXT,
        external_source TEXT,
        started_at TEXT NOT NULL,
        ended_at TEXT,
        title TEXT,
        source_uri TEXT,
        source_hash TEXT,
        participants TEXT,
        tags TEXT,
        metadata TEXT,
        created_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now'))
    );
    CREATE UNIQUE INDEX calls_external_uq
        ON calls (external_id, COALESCE(external_source, ''))
        WHERE external_id IS NOT NULL;
    CREATE UNIQUE INDEX calls_source_uq
        ON calls (source_uri, source_hash)
        WHERE source_uri IS NOT NULL AND source_hash IS NOT NULL;
    CREATE INDEX calls_started_idx ON calls (started_at DESC, call_id DESC);

    CREATE TABLE utterances (
        utterance_id INTEGER PRIMARY KEY AUTOINCREMENT,
        call_id TEXT NOT NULL REFERENCES calls(call_id),
        speaker TEXT,
        speaker_id TEXT,
        start_ts_ms INTEGER NOT NULL,
        end_ts_ms INTEGER NOT NULL,
        confidence REAL,
        text TEXT NOT NULL
    );
    CREATE INDEX utterances_call_idx ON utterances (call_id, start_ts_ms);

    CREATE TABLE chunks (
        chunk_id INTEGER PRIMARY KEY AUTOINCREMENT,
        call_id TEXT NOT NULL REFERENCES calls(call_id),
        call_started_at TEXT NOT NULL,
        speaker TEXT,
        start_ts_ms INTEGER NOT NULL,
        end_ts_ms INTEGER NOT NULL,
        token_count INTEGER NOT NULL,
        text TEXT NOT NULL,
        tech_tokens TEXT NOT NULL DEFAULT '[]',
        embedding BLOB,
        lex_sig BLOB,
        lex_dl INTEGER NOT NULL DEFAULT 0
    );
    CREATE INDEX chunks_call_idx ON chunks (call_id);

    CREATE TABLE chunk_utterances (
        chunk_id INTEGER NOT NULL REFERENCES chunks(chunk_id),
        utterance_id INTEGER NOT NULL REFERENCES utterances(utterance_id),
        ordinal INTEGER NOT NULL,
        PRIMARY KEY (chunk_id, ordinal)
    );

    CREATE TABLE ingestion_runs (
        run_id INTEGER PRIMARY KEY AUTOINCREMENT,
        call_id TEXT NOT NULL REFERENCES calls(call_id),
        pipeline_version TEXT NOT NULL,
        chunking_config TEXT NOT NULL,
        embedding_config TEXT NOT NULL,
        ner_config TEXT NOT NULL,
        created_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now'))
    );
    """),
    (2, """
    CREATE TABLE analysis_artifacts (
        artifact_id INTEGER PRIMARY KEY AUTOINCREMENT,
        call_id TEXT NOT NULL REFERENCES calls(call_id),
        call_started_at TEXT NOT NULL,
        kind TEXT NOT NULL,
        content TEXT NOT NULL,
        token_count INTEGER NOT NULL,
        tech_tokens TEXT NOT NULL DEFAULT '[]',
        metadata TEXT,
        created_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now'))
    );
    CREATE INDEX artifacts_call_idx ON analysis_artifacts (call_id);

    CREATE TABLE artifact_chunks (
        artifact_chunk_id INTEGER PRIMARY KEY AUTOINCREMENT,
        artifact_id INTEGER NOT NULL REFERENCES analysis_artifacts(artifact_id),
        call_id TEXT NOT NULL REFERENCES calls(call_id),
        call_started_at TEXT NOT NULL,
        kind TEXT NOT NULL,
        ordinal INTEGER NOT NULL,
        content TEXT NOT NULL,
        token_count INTEGER NOT NULL,
        start_char INTEGER,
        end_char INTEGER,
        tech_tokens TEXT NOT NULL DEFAULT '[]',
        metadata TEXT,
        embedding BLOB,
        lex_sig BLOB,
        lex_dl INTEGER NOT NULL DEFAULT 0
    );
    CREATE INDEX artifact_chunks_call_idx ON artifact_chunks (call_id);
    """),
    (3, """
    CREATE TABLE ingest_jobs (
        ingest_job_id TEXT PRIMARY KEY,
        bundle_id TEXT UNIQUE NOT NULL,
        status TEXT NOT NULL CHECK
            (status IN ('queued','running','succeeded','failed','invalid')),
        attempts INTEGER NOT NULL DEFAULT 0,
        max_attempts INTEGER NOT NULL,
        error TEXT,
        call_id TEXT,
        bundle_path TEXT,
        manifest TEXT,
        created_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
        started_at TEXT,
        finished_at TEXT
    );
    CREATE INDEX ingest_jobs_status_idx ON ingest_jobs (status, created_at DESC);

    CREATE TABLE ingest_job_files (
        ingest_job_id TEXT NOT NULL REFERENCES ingest_jobs(ingest_job_id),
        path TEXT NOT NULL,
        sha256 TEXT NOT NULL,
        size_bytes INTEGER NOT NULL,
        role TEXT NOT NULL,
        PRIMARY KEY (ingest_job_id, path)
    );

    CREATE TABLE queue (
        message_id INTEGER PRIMARY KEY AUTOINCREMENT,
        queue_name TEXT NOT NULL,
        payload TEXT NOT NULL,
        available_at REAL NOT NULL,
        claimed_at REAL,
        claimed_by TEXT,
        done INTEGER NOT NULL DEFAULT 0
    );
    CREATE INDEX queue_poll_idx ON queue (queue_name, done, available_at);
    """),
    (4, """
    CREATE TABLE transcript_ingests (
        transcript_ingest_id INTEGER PRIMARY KEY AUTOINCREMENT,
        call_id TEXT NOT NULL REFERENCES calls(call_id),
        transcript_hash TEXT NOT NULL,
        utterance_count INTEGER NOT NULL DEFAULT 0,
        chunk_count INTEGER NOT NULL DEFAULT 0,
        created_at TEXT NOT NULL DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
        UNIQUE (call_id, transcript_hash)
    );

    CREATE TABLE index_meta (
        corpus TEXT PRIMARY KEY,
        doc_freq BLOB,
        avgdl REAL NOT NULL DEFAULT 0,
        doc_count INTEGER NOT NULL DEFAULT 0
    );
    """),
    # Inverted tag map: the reference's `tags && :arr` GIN lookup analogue.
    # Tag filtering resolves via this index instead of JSON-parsing every
    # call row per request (wrong shape at 100k calls).
    (5, """
    CREATE TABLE call_tags (
        tag TEXT NOT NULL,
        call_seq INTEGER NOT NULL,
        PRIMARY KEY (tag, call_seq)
    ) WITHOUT ROWID;
    CREATE INDEX call_tags_seq_idx ON call_tags (call_seq);
    """),
    # Index-mutation log: trigger-maintained so ANY writer process
    # (worker daemon, backfill CLI, the API itself) logs the device-index
    # work its store writes imply. A serving process tails this log
    # (ingest/sync.py) to keep its HBM index coherent with the store —
    # the reference gets this for free because Postgres IS its index
    # (worker writes at reference ingest_fs.py:840-963 are instantly
    # visible to the API through the shared database).
    # Delete entries carry the dead row's lex_sig/lex_dl so the index
    # can shed the document's df/avgdl mass after the row is gone.
    (6, """
    CREATE TABLE index_mutations (
        seq INTEGER PRIMARY KEY AUTOINCREMENT,
        tbl TEXT NOT NULL,
        op TEXT NOT NULL,
        row_id INTEGER NOT NULL,
        lex_sig BLOB,
        lex_dl INTEGER
    );

    CREATE TABLE sync_consumers (
        consumer_id TEXT PRIMARY KEY,
        last_seq INTEGER NOT NULL,
        heartbeat_at REAL NOT NULL
    );

    CREATE TRIGGER chunks_mut_ins AFTER INSERT ON chunks BEGIN
        INSERT INTO index_mutations (tbl, op, row_id)
            VALUES ('chunks', 'insert', NEW.chunk_id);
    END;
    CREATE TRIGGER chunks_mut_upd AFTER UPDATE OF embedding, tech_tokens
    ON chunks BEGIN
        INSERT INTO index_mutations (tbl, op, row_id)
            VALUES ('chunks', 'update', NEW.chunk_id);
    END;
    CREATE TRIGGER chunks_mut_del AFTER DELETE ON chunks BEGIN
        INSERT INTO index_mutations (tbl, op, row_id, lex_sig, lex_dl)
            VALUES ('chunks', 'delete', OLD.chunk_id, OLD.lex_sig,
                    OLD.lex_dl);
    END;

    CREATE TRIGGER artifact_chunks_mut_ins AFTER INSERT ON artifact_chunks
    BEGIN
        INSERT INTO index_mutations (tbl, op, row_id)
            VALUES ('artifact_chunks', 'insert', NEW.artifact_chunk_id);
    END;
    CREATE TRIGGER artifact_chunks_mut_upd
    AFTER UPDATE OF embedding, tech_tokens ON artifact_chunks BEGIN
        INSERT INTO index_mutations (tbl, op, row_id)
            VALUES ('artifact_chunks', 'update', NEW.artifact_chunk_id);
    END;
    CREATE TRIGGER artifact_chunks_mut_del AFTER DELETE ON artifact_chunks
    BEGIN
        INSERT INTO index_mutations (tbl, op, row_id, lex_sig, lex_dl)
            VALUES ('artifact_chunks', 'delete', OLD.artifact_chunk_id,
                    OLD.lex_sig, OLD.lex_dl);
    END;
    """),
    # Lexical vocab head (ops/hashing.apply_vocab): the learned top-df
    # feature hashes that hold dedicated collision-free signature buckets.
    # One active vocab per store (highest version); `dim` is recorded so a
    # vocab built for a different LEXICAL_DIM is refused at activation
    # (core/vocab.py). Built + applied by scripts/build_lex_vocab.py.
    # `applied` flips to 1 only after the full-store re-featurize
    # completes; a crash mid-apply leaves an unapplied row that
    # activation refuses (mixed-layout blobs are undetectable per-row).
    (7, """
    CREATE TABLE lex_vocab (
        version INTEGER PRIMARY KEY,
        head INTEGER NOT NULL,
        dim INTEGER NOT NULL,
        created_at TEXT NOT NULL,
        applied INTEGER NOT NULL DEFAULT 0,
        hashes BLOB NOT NULL
    );
    """),
    # Vocab-layout provenance: every lex_sig blob records the vocab
    # version it was featurized under, so a row written by a process
    # whose vocab lagged an online rebuild (core/vocab.py auto-rebuild;
    # the race is one in-flight ingest job) is DETECTED and re-featurized
    # at rehydration (ingest.rehydrate_doc_rows) instead of silently
    # scoring garbage. lex_vocab.built_docs records corpus size at build
    # time — the growth input to the auto-rebuild trigger.
    (8, """
    ALTER TABLE chunks ADD COLUMN lex_vocab_version INTEGER NOT NULL DEFAULT 0;
    ALTER TABLE artifact_chunks ADD COLUMN lex_vocab_version INTEGER NOT NULL DEFAULT 0;
    ALTER TABLE lex_vocab ADD COLUMN built_docs INTEGER NOT NULL DEFAULT 0;
    -- pre-migration rows were written under the store's applied vocab
    -- (the offline-rebuild contract): stamp them so they are not
    -- re-featurized wholesale at the next rehydration
    UPDATE chunks SET lex_vocab_version =
        COALESCE((SELECT MAX(version) FROM lex_vocab WHERE applied=1), 0);
    UPDATE artifact_chunks SET lex_vocab_version =
        COALESCE((SELECT MAX(version) FROM lex_vocab WHERE applied=1), 0);
    """),
]


class Store:
    """One SQLite database; thread-safe via a connection lock."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(
            path, check_same_thread=False, isolation_level=None
        )
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA foreign_keys=ON")
        self._migrate()

    # -- migrations / version gate ------------------------------------
    def _migrate(self) -> None:
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS schema_migrations "
                "(version INTEGER PRIMARY KEY, applied_at TEXT NOT NULL)"
            )
            applied = {
                row[0]
                for row in self._conn.execute(
                    "SELECT version FROM schema_migrations"
                )
            }
            for version, ddl in MIGRATIONS:
                if version in applied:
                    continue
                # executescript() implicitly commits any open transaction,
                # so each migration is applied as its own script followed by
                # the version stamp (idempotent: a crash between the two
                # re-runs DDL guarded by IF NOT EXISTS semantics of a fresh
                # store, which is the only crash window that matters here).
                self._conn.executescript(ddl)
                if version == 5:
                    self._backfill_call_tags()
                self._conn.execute(
                    "INSERT INTO schema_migrations VALUES "
                    "(?, strftime('%Y-%m-%dT%H:%M:%fZ','now'))",
                    (version,),
                )

    def _backfill_call_tags(self) -> None:
        """Populate the migration-5 inverted tag map from pre-existing
        calls.tags JSON (one-time, runs inside the migration)."""
        rows = self._conn.execute(
            "SELECT call_seq, tags FROM calls WHERE tags IS NOT NULL"
        ).fetchall()
        for row in rows:
            for tag in set(json.loads(row["tags"]) or []):
                self._conn.execute(
                    "INSERT OR IGNORE INTO call_tags (tag, call_seq) "
                    "VALUES (?, ?)",
                    (str(tag), int(row["call_seq"])),
                )

    def fetch_info(self) -> Dict[str, Any]:
        """Store + runtime component versions (surfaced by /health and
        /diagnostics; reference: app/db.py:19-35): torch, its CUDA build,
        and the card torch sees (the CPU when it sees none)."""
        import torch

        with self._lock:
            version = self._conn.execute(
                "SELECT MAX(version) FROM schema_migrations"
            ).fetchone()[0]
        cuda = torch.cuda.is_available()
        return {
            "store": "sqlite",
            "sqlite_version": sqlite3.sqlite_version,
            "schema_version": int(version or 0),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_backend": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        }

    def validate_versions(self) -> Tuple[bool, str]:
        """Fail-fast startup gate (reference: app/db.py:38-63 pins
        Postgres/pg_search/pgvector; here we pin the schema version and
        require a device)."""
        info = self.fetch_info()
        if info["schema_version"] != SCHEMA_VERSION:
            return False, (
                f"schema version {info['schema_version']} != "
                f"expected {SCHEMA_VERSION}"
            )
        if info["device_count"] < 1:
            return False, "no devices available"
        return True, (
            f"ok: schema v{info['schema_version']}, "
            f"{info['device_count']} {info['device_backend']} device(s)"
        )

    # -- transactional access ------------------------------------------
    @contextmanager
    def tx(self) -> Iterator[sqlite3.Connection]:
        with self._lock:
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                yield self._conn
                self._conn.execute("COMMIT")
            except Exception:
                self._conn.execute("ROLLBACK")
                raise

    @contextmanager
    def read(self) -> Iterator[sqlite3.Connection]:
        with self._lock:
            yield self._conn

    def close(self) -> None:
        with self._lock:
            self._conn.close()


_store: Optional[Store] = None
_store_lock = threading.Lock()


def get_store() -> Store:
    global _store
    with _store_lock:
        if _store is None or _store.path != settings.store_path:
            if _store is not None:
                _store.close()
            _store = Store(settings.store_path)
        return _store


def reset_store() -> None:
    """Drop the singleton (tests bind a fresh store per tmp path)."""
    global _store
    with _store_lock:
        if _store is not None:
            _store.close()
        _store = None


def to_json(value: Any) -> Optional[str]:
    return None if value is None else json.dumps(value)


def from_json(raw: Optional[str]) -> Any:
    return None if raw is None else json.loads(raw)
