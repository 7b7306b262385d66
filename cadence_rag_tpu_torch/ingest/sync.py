"""Live store -> device-index synchronization.

Counterpart of ``cadence_rag_tpu/ingest/sync.py`` over the port's index,
cold tier and vocab adoption included.

The reference's worker/API topology is coherent for free: worker writes
land in the shared Postgres the API queries (reference
ingest_fs.py:840-963 + docker-compose.yml:22-102). Here the search index
is resident on the serving process's device, so writes by OTHER processes
(ingest worker daemon, embed/tech backfill CLIs) would be invisible
until a restart. This module closes that gap:

- every store write is logged by SQLite triggers into ``index_mutations``
  (store/db.py migration 6) — any writer, any code path;
- the serving process runs a :class:`StoreSyncer` that tails the log and
  applies the implied device work: insert missing rows (featurized state
  is rehydrated straight from the store — no re-featurization), scatter
  updated embeddings/tech slots, tombstone deleted rows (shedding df/
  avgdl mass recorded in the delete log entry);
- standalone writers run in *store-only* mode (ingest.set_store_only) so
  they never pay for device work their process would throw away.

Multiple serving processes may tail the same log (each registers in
``sync_consumers``); entries are pruned once every live consumer has
passed them. Local API ingests also hit the log — the syncer skips rows
its index already has, and CorpusIndex.insert dedupes by doc_id, so the
race between a local insert and the poll is harmless in either order.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from ..config import settings
from ..logging_utils import get_logger
from ..store.db import from_json, get_store
from . import featurize
from .ingest import (
    DOC_ROW_SELECT,
    INDEXED_TABLES,
    TEXT_COLUMNS,
    persist_lexical_meta,
    rehydrate_doc_rows,
)

logger = get_logger(__name__)

# prune once all live consumers passed an entry; a consumer silent for
# this long is considered dead and stops holding the log back
CONSUMER_STALE_S = 3600.0


def _emb_matrix(rows, dim: int, where: str):
    """(ids, (n, dim) f32) from store rows with an ``embedding`` blob,
    DROPPING wrong-length blobs with an error log: a writer running a
    different EMBEDDINGS_DIM (or a truncated write) must not raise out
    of the poll loop — that would wedge the watermark and silently stop
    ALL sync progress on one poison row."""
    ids: List[int] = []
    vecs = []
    bad = 0
    for r in rows:
        raw = r["embedding"]
        if not raw:
            continue
        if len(raw) == dim * 4:
            ids.append(int(r["doc_id"]))
            vecs.append(np.frombuffer(raw, np.float32))
        else:
            bad += 1
    if bad:
        logger.error(
            "sync.bad_embedding_blob where=%s rows=%s expected_dim=%s "
            "(skipped — check the writer's EMBEDDINGS_DIM)",
            where, bad, dim,
        )
    return ids, (np.stack(vecs) if vecs else np.zeros((0, dim), np.float32))


class StoreSyncer:
    """Tails ``index_mutations`` and applies them to this process's
    device index. One instance per serving process."""

    def __init__(self, index=None, store=None):
        self._index = index
        self._store = store
        self.consumer_id = f"sync-{uuid.uuid4().hex[:12]}"
        self.last_seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def index(self):
        if self._index is None:
            from ..core.index import get_index

            self._index = get_index()
        return self._index

    @property
    def store(self):
        return self._store or get_store()

    # -- watermark ---------------------------------------------------------
    def current_watermark(self) -> int:
        with self.store.read() as conn:
            row = conn.execute(
                "SELECT COALESCE(MAX(seq), 0) FROM index_mutations"
            ).fetchone()
        return int(row[0])

    def init_watermark(self) -> int:
        """Call BEFORE a full rebuild reads the store: anything the
        rebuild misses has seq > this watermark and the first poll picks
        it up (rows both rebuilt and logged are skipped by the
        already-present check). Registers this consumer immediately —
        a rebuild takes minutes, and an already-running consumer's
        heartbeat would otherwise prune ``index_mutations`` past this
        watermark before the first poll ever runs."""
        self.last_seq = self.current_watermark()
        self._heartbeat()
        return self.last_seq

    # -- polling -----------------------------------------------------------
    def poll_once(self) -> Dict[str, int]:
        """Apply all mutations past the watermark. Returns op counts."""
        with self._lock:
            return self._poll_locked()

    def _poll_locked(self) -> Dict[str, int]:
        # an EXTERNAL vocab rebuild (another process ran build_lex_vocab
        # against the shared store) must be noticed BEFORE applying
        # mutations, or new-layout rows would land in an old-layout
        # index and score wrong silently. One cheap SELECT.
        from ..core.vocab import adopt_store_layout

        adopt_store_layout(self.store, self.index)
        with self.store.read() as conn:
            muts = conn.execute(
                "SELECT seq, tbl, op, row_id, lex_sig, lex_dl "
                "FROM index_mutations WHERE seq > ? ORDER BY seq ASC",
                (self.last_seq,),
            ).fetchall()
        if not muts:
            self._heartbeat()
            return {}
        # Coalesce per row: AUTOINCREMENT ids never reuse, so a row_id is
        # inserted at most once and deleted at most once — a delete entry
        # is always the row's final state; otherwise the CURRENT store row
        # carries everything (including any embedding/tech updates logged
        # after the insert). Tracking inserts and updates separately lets
        # an insert the local process already applied be skipped without
        # re-scattering its embedding/tech state.
        deleted: Dict[str, Dict[int, tuple]] = {t: {} for t, _ in INDEXED_TABLES}
        inserted: Dict[str, set] = {t: set() for t, _ in INDEXED_TABLES}
        updated: Dict[str, set] = {t: set() for t, _ in INDEXED_TABLES}
        for m in muts:
            tbl = m["tbl"]
            rid = int(m["row_id"])
            if m["op"] == "delete":
                deleted[tbl][rid] = (m["lex_sig"], m["lex_dl"])
                inserted[tbl].discard(rid)
                updated[tbl].discard(rid)
            elif m["op"] == "insert":
                inserted[tbl].add(rid)
                deleted[tbl].pop(rid, None)
            else:
                updated[tbl].add(rid)
                deleted[tbl].pop(rid, None)

        counts = {"inserted": 0, "updated": 0, "deleted": 0}
        # new calls first: filter bitmaps size to call capacity
        with self.store.read() as conn:
            row = conn.execute(
                "SELECT COALESCE(MAX(call_seq), -1) FROM calls"
            ).fetchone()
        self.index.ensure_call_capacity(int(row[0]) + 1)

        lex_dim = int(settings.lexical_dim)
        for table, id_col in INDEXED_TABLES:
            corpus = self.index.corpus(table)
            ids = sorted(inserted[table] | updated[table])
            if ids:
                placeholders = ",".join("?" * len(ids))
                with self.store.read() as conn:
                    rows = conn.execute(
                        DOC_ROW_SELECT.format(
                            id_col=id_col, table=table,
                            text_col=TEXT_COLUMNS[table],
                        )
                        + f"WHERE t.{id_col} IN ({placeholders}) "
                        f"ORDER BY t.{id_col} ASC",
                        ids,
                    ).fetchall()
                present = {int(r["doc_id"]): r for r in rows}
                have = corpus.contains(list(present))
                # repairs stale-layout signatures (a writer that raced a
                # vocab rebuild) before they reach the device.
                # deleted_ids guard: a local delete tombstones the device
                # BEFORE its store commit — a poll in that window would
                # otherwise resurrect the rows (store-present, device-
                # absent, insert entries still unconsumed)
                to_insert = rehydrate_doc_rows(
                    self.store, table,
                    [r for ok, r in zip(have, present.values())
                     if not ok
                     and int(r["doc_id"]) not in corpus.deleted_ids],
                )
                # present rows with a logged UPDATE need a re-scatter;
                # present rows with only a logged insert were applied by
                # the local ingest path already — skip
                upd = [
                    r for ok, r in zip(have, present.values())
                    if ok and int(r["doc_id"]) in updated[table]
                ]
                if to_insert:
                    corpus.insert(to_insert)
                    counts["inserted"] += len(to_insert)
                if upd:
                    emb_ids, emb_mat = _emb_matrix(
                        upd, corpus.dim, f"poll:{table}"
                    )
                    if emb_ids:
                        corpus.set_embeddings(emb_ids, emb_mat)
                    def _slots(r):
                        try:
                            return featurize.tech_slots(
                                from_json(r["tech_tokens"]) or []
                            )
                        except Exception:
                            logger.error(
                                "sync.bad_tech_tokens table=%s doc_id=%s "
                                "(treated as no tokens)",
                                table, int(r["doc_id"]),
                            )
                            return featurize.tech_slots([])

                    corpus.set_tech(
                        [int(r["doc_id"]) for r in upd],
                        np.stack([_slots(r) for r in upd]),
                    )
                    counts["updated"] += len(upd)
                # a touched row missing from the store with no delete
                # entry yet: its delete mutation is later in the log than
                # our read — the next poll handles it
            dels = deleted[table]
            if dels:
                def _sig(raw):
                    if not raw:
                        return None
                    sig = np.frombuffer(raw, dtype=np.int8)
                    return sig if sig.shape[0] == lex_dim else None

                ids_d = list(dels)
                counts["deleted"] += corpus.delete_ids(
                    ids_d,
                    [_sig(dels[i][0]) for i in ids_d],
                    [int(dels[i][1] or 0) for i in ids_d],
                )
                # the delete's log entry is now behind our watermark: the
                # store row is gone and its insert entries are older than
                # the delete, so no future poll/reconcile can resurrect
                # it — safe to drop from the blacklist (which would
                # otherwise grow forever on churn-heavy corpora)
                corpus.deleted_ids.difference_update(
                    int(d) for d in ids_d
                )
            if ids or dels:
                persist_lexical_meta(self.store, corpus)

        self.last_seq = int(muts[-1]["seq"])
        self._heartbeat()
        if any(counts.values()):
            logger.info(
                "sync.applied inserted=%s updated=%s deleted=%s seq=%s",
                counts["inserted"], counts["updated"], counts["deleted"],
                self.last_seq,
            )
        return counts

    def _heartbeat(self) -> None:
        """Record progress and prune entries every live consumer passed."""
        now = time.time()
        with self.store.tx() as conn:
            conn.execute(
                "INSERT INTO sync_consumers (consumer_id, last_seq, "
                "heartbeat_at) VALUES (?,?,?) ON CONFLICT(consumer_id) "
                "DO UPDATE SET last_seq=excluded.last_seq, "
                "heartbeat_at=excluded.heartbeat_at",
                (self.consumer_id, self.last_seq, now),
            )
            conn.execute(
                "DELETE FROM sync_consumers WHERE heartbeat_at < ?",
                (now - CONSUMER_STALE_S,),
            )
            floor = conn.execute(
                "SELECT MIN(last_seq) FROM sync_consumers"
            ).fetchone()[0]
            if floor is not None:
                conn.execute(
                    "DELETE FROM index_mutations WHERE seq <= ?", (floor,)
                )

    # -- reconcile ---------------------------------------------------------
    def reconcile(self) -> Dict[str, int]:
        """Full store-vs-index diff, for startups where the index was
        restored from a checkpoint that may predate (or outlive) the
        store: inserts store rows missing on device, tombstones device
        rows gone from the store, scatters embeddings the store has but
        the index lacks. O(N) host work; device work only for the
        diff."""
        counts = {"inserted": 0, "updated": 0, "deleted": 0}
        with self._lock:
            self.last_seq = self.current_watermark()
            with self.store.read() as conn:
                row = conn.execute(
                    "SELECT COALESCE(MAX(call_seq), -1) FROM calls"
                ).fetchone()
            self.index.ensure_call_capacity(int(row[0]) + 1)
            for table, id_col in INDEXED_TABLES:
                corpus = self.index.corpus(table)
                with self.store.read() as conn:
                    store_rows = conn.execute(
                        f"SELECT {id_col} AS doc_id, "
                        f"embedding IS NOT NULL AS has_emb FROM {table}"
                    ).fetchall()
                store_ids = {int(r["doc_id"]) for r in store_rows}
                with corpus.lock:
                    n = corpus.count
                    live = corpus.h_started[:n] > np.iinfo(np.int32).min
                    index_ids = set(corpus.h_ids[:n][live].astype(int))
                    if corpus.cold is not None:
                        index_ids |= set(corpus.cold.live_ids().tolist())
                missing = sorted(
                    store_ids - index_ids - corpus.deleted_ids
                )
                extra = sorted(index_ids - store_ids)
                if missing:
                    placeholders = ",".join("?" * len(missing))
                    with self.store.read() as conn:
                        rows = conn.execute(
                            DOC_ROW_SELECT.format(
                                id_col=id_col, table=table,
                                text_col=TEXT_COLUMNS[table],
                            )
                            + f"WHERE t.{id_col} IN ({placeholders}) "
                            f"ORDER BY t.{id_col} ASC",
                            missing,
                        ).fetchall()
                    corpus.insert(rehydrate_doc_rows(self.store, table, rows))
                    counts["inserted"] += len(rows)
                if extra:
                    counts["deleted"] += corpus.delete_ids(extra)
                # embeddings present in store but absent on device
                # (backfill ran while this process was down)
                emb_ids = [
                    int(r["doc_id"]) for r in store_rows
                    if r["has_emb"] and int(r["doc_id"]) in index_ids
                ]
                if emb_ids:
                    pos = corpus.position_of(emb_ids)
                    need = [
                        i for i, p in zip(emb_ids, pos)
                        if p >= 0 and not corpus.h_has_emb[p]
                    ]
                    if corpus.cold is not None:
                        cpos = corpus.cold.positions(emb_ids)
                        need.extend(
                            i for i, p in zip(emb_ids, cpos)
                            if p >= 0 and not bool(corpus.cold.has_emb[p])
                        )
                    if need:
                        placeholders = ",".join("?" * len(need))
                        with self.store.read() as conn:
                            rows = conn.execute(
                                f"SELECT {id_col} AS doc_id, embedding "
                                f"FROM {table} WHERE {id_col} IN "
                                f"({placeholders})",
                                need,
                            ).fetchall()
                        emb_ids, emb_mat = _emb_matrix(
                            rows, corpus.dim, f"reconcile:{table}"
                        )
                        if emb_ids:
                            corpus.set_embeddings(emb_ids, emb_mat)
                        counts["updated"] += len(emb_ids)
                if missing or extra:
                    persist_lexical_meta(self.store, corpus)
            self._heartbeat()
        if any(counts.values()):
            logger.info(
                "sync.reconciled inserted=%s updated=%s deleted=%s",
                counts["inserted"], counts["updated"], counts["deleted"],
            )
        return counts

    # -- background loop ---------------------------------------------------
    def start(self, interval_s: float) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.poll_once()
                except Exception:  # never kill the loop; next tick retries
                    logger.exception("sync.poll_failed")
                try:
                    # drift-triggered vocab rebuild (opt-in; rate-limited
                    # inside, a no-op SELECT-free check when disabled)
                    from ..core.vocab import auto_rebuild_if_needed

                    auto_rebuild_if_needed(self.store, self.index)
                except Exception:
                    logger.exception("sync.auto_rebuild_failed")

        self._thread = threading.Thread(
            target=loop, daemon=True, name="store-syncer"
        )
        self._thread.start()
        logger.info(
            "sync.started consumer=%s interval_s=%s",
            self.consumer_id, interval_s,
        )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


_syncer: Optional[StoreSyncer] = None
_syncer_lock = threading.Lock()


def get_syncer() -> StoreSyncer:
    global _syncer
    with _syncer_lock:
        if _syncer is None:
            _syncer = StoreSyncer()
        return _syncer


def reset_syncer() -> None:
    global _syncer
    with _syncer_lock:
        if _syncer is not None:
            _syncer.stop()
        _syncer = None
