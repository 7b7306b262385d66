"""The store -> index syncer (``ingest/sync.py``), JAX package vs port, on
the CPU: the thirteen cases of ``tests/integration/test_store_sync.py``,
each run in both packages (store-only mode flipped in one process, exactly
what the worker daemon does) with their observations compared: the same op
counts from ``poll_once`` / ``reconcile``, the same ids retrieved, the same
index counters. Then the cross-process case of
``tests/integration/test_worker_api_coherence.py`` for the port alone: its
aiohttp server in one process (``--device cpu``,
``STORE_SYNC_INTERVAL_S=0.2``), the port's scanner and worker scripts in
others, none importing jax or the JAX package.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from torch_parity import (
    JAX,
    PORT,
    ingest_corpus,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)

REPO = Path(__file__).resolve().parent.parent
OPTS = dict(target_tokens=10, max_tokens=30, overlap_tokens=2)


def _ingest_one(pkg, external_id, text):
    s = pkg.schemas
    call_id, _, n_chunks = pkg.ingest.ingest_transcript(
        s.CallRef(external_id=external_id),
        [s.UtteranceIn(speaker="W", start_ts_ms=0, end_ts_ms=900, text=text)],
        s.ChunkingOptions(**OPTS))
    assert n_chunks >= 1
    return call_id


def _ids(pkg, query):
    return pkg.retrieve.retrieve_evidence(
        pkg.request({"query": query, "return_style": "ids_only"}))["retrieved_ids"]


def _chunk_ids(pkg, call_id):
    with pkg.db.get_store().read() as conn:
        return [int(r[0]) for r in conn.execute(
            "SELECT chunk_id FROM chunks WHERE call_id = ?", (call_id,))]


def _stats(pkg):
    index = pkg.index.get_index()
    return {name: (c.count, c.tombstones, c.emb_rows, int(c.doc_freq.sum()), c.dl_sum)
            for name, c in (("chunks", index.chunks), ("artifacts", index.artifacts))}


def _in_both(scenario):
    got, want = scenario(PORT), scenario(JAX)
    assert got == want
    return got


class TestStoreOnlyIngest:
    def test_store_only_skips_device_insert(self, port_store):
        def scenario(pkg):
            pkg.ingest.set_store_only(True)
            _ingest_one(pkg, "so-1", "kafka consumer lag after the rebalance")
            with pkg.db.get_store().read() as conn:
                n = conn.execute("SELECT COUNT(*) FROM chunks").fetchone()[0]
                muts = conn.execute(
                    "SELECT COUNT(*) FROM index_mutations WHERE op='insert'"
                ).fetchone()[0]
            return pkg.index.get_index().chunks.count, n, muts

        count, n, muts = _in_both(scenario)
        assert count == 0 and n >= 1 and muts >= n

    def test_poll_makes_worker_rows_retrievable(self, port_store):
        def scenario(pkg):
            s = pkg.schemas
            pkg.ingest.set_store_only(True)            # the "worker process" writes
            _ingest_one(pkg, "so-2", "the ECONNRESET fix landed in v2.3.1")
            pkg.ingest.ingest_analysis(
                s.CallRef(external_id="so-2"),
                [s.AnalysisArtifactIn(kind="summary",
                                      content="ECONNRESET fixed by rollback")])
            pkg.ingest.set_store_only(False)           # back in the serving process
            before = _ids(pkg, "ECONNRESET v2.3.1")
            counts = pkg.sync.get_syncer().poll_once()
            # a second poll is a no-op (the watermark advanced)
            return (before, counts, _ids(pkg, "ECONNRESET v2.3.1"),
                    pkg.sync.get_syncer().poll_once(), _stats(pkg))

        before, counts, ids, again, _stats_ = _in_both(scenario)
        assert before == [] and counts["inserted"] >= 2 and again == {}
        assert any(i.startswith("chunk:") for i in ids)
        assert any(i.startswith("artifact_chunk:") for i in ids)

    def test_poll_applies_external_embedding_backfill(self, port_store):
        def scenario(pkg):
            pkg.ingest.set_store_only(True)
            _ingest_one(pkg, "so-3", "object store tiering to SSD approved")
            pkg.pipeline.run_embedding_backfill(batch_size=8)   # blobs and log only
            pkg.ingest.set_store_only(False)
            counts = pkg.sync.get_syncer().poll_once()
            resp = pkg.retrieve.retrieve_evidence(
                pkg.request({"query": "tiering to SSD", "debug": True}))
            return (counts, _stats(pkg), resp["notes"]["retrieval"]["lanes"],
                    [q["chunk_id"] for q in resp["quotes"]])

        counts, stats, lanes, quotes = _in_both(scenario)
        # the embedding arrived with the insert (the row's current state)
        assert counts["inserted"] >= 1 and stats["chunks"][2] >= 1
        assert lanes["dense"] is True and quotes

    def test_backfill_after_insert_scatters(self, port_store):
        def scenario(pkg):
            # synced first without an embedding, then an external backfill
            # updates the row: the update mutation re-scatters it
            pkg.ingest.set_store_only(True)
            _ingest_one(pkg, "so-4", "certificate expiry caused the outage window")
            pkg.ingest.set_store_only(False)
            first = pkg.sync.get_syncer().poll_once()
            bare = _stats(pkg)
            pkg.ingest.set_store_only(True)
            pkg.pipeline.run_embedding_backfill(batch_size=8)
            pkg.ingest.set_store_only(False)
            return first, bare, pkg.sync.get_syncer().poll_once(), _stats(pkg)

        first, bare, second, full = _in_both(scenario)
        assert first["inserted"] >= 1 and bare["chunks"][2] == 0
        assert second["updated"] >= 1 and full["chunks"][2] >= 1

    def test_poll_applies_external_delete(self, port_store):
        def scenario(pkg):
            call_a = _ingest_one(pkg, "so-5", "quota exhaustion throttled the export")
            _ingest_one(pkg, "so-6", "postgres vacuum stalls on the ledger table")
            before = _stats(pkg)
            pkg.sync.get_syncer().poll_once()          # drain the local ingests' entries
            dead = {f"chunk:{i}" for i in _chunk_ids(pkg, call_a)}
            seen = _ids(pkg, "quota exhaustion export")
            assert dead & set(seen)
            pkg.ingest.set_store_only(True)            # a delete from a worker-like process
            pkg.ingest.delete_call(call_a)
            pkg.ingest.set_store_only(False)
            counts = pkg.sync.get_syncer().poll_once()
            after = _ids(pkg, "quota exhaustion export")
            assert not dead & set(after)               # invisible to every lane
            return before, seen, counts, after, _stats(pkg)

        before, _seen, counts, _after, stats = _in_both(scenario)
        assert counts["deleted"] >= 1
        # df mass shed through the lex_sig the delete trigger captured
        assert stats["chunks"][3] < before["chunks"][3]
        assert stats["chunks"][1] == counts["deleted"]

    def test_poll_mid_delete_does_not_resurrect(self, port_store):
        """``delete_call`` tombstones the device before its store commit; a
        poll in that window (insert entries unconsumed, store rows still
        there, device rows already tombstoned) must not re-insert the
        rows, and neither must a reconcile."""
        def scenario(pkg):
            call_a = _ingest_one(pkg, "mid-1", "kafka timeout incident on svc zero")
            index = pkg.index.get_index()
            ids = _chunk_ids(pkg, call_a)
            assert ids
            index.chunks.delete_ids(ids)               # the window opens
            n = index.chunks.count
            fresh = pkg.sync.StoreSyncer()
            polled = fresh.poll_once().get("inserted", 0)
            assert index.chunks.count == n and not index.chunks.contains(ids).any()
            reconciled = fresh.reconcile().get("inserted", 0)
            assert not index.chunks.contains(ids).any()
            return polled, reconciled, _stats(pkg), _ids(pkg, "kafka timeout incident")

        assert _in_both(scenario)[:2] == (0, 0)

    def test_local_ingest_not_reapplied(self, port_store):
        """The serving process's own writes hit the log too; the poll skips
        them (dedupe by doc id, no re-scatter for pure inserts)."""
        def scenario(pkg):
            _ingest_one(pkg, "so-7", "lenovo BOM finalized for the bake-off")
            before = _stats(pkg)
            counts = pkg.sync.get_syncer().poll_once()
            assert _stats(pkg) == before
            return counts, before

        counts, _ = _in_both(scenario)
        assert counts.get("inserted", 0) == 0 and counts.get("updated", 0) == 0

    def test_insert_dedupe_under_race_order(self, port_store):
        """The syncer inserts first, the local path second: the second
        ``corpus.insert`` is a no-op."""
        def scenario(pkg):
            _ingest_one(pkg, "so-8", "gateway upgrade caused the ECONNRESET storm")
            index = pkg.index.get_index()
            before = _stats(pkg)
            with pkg.db.get_store().read() as conn:
                rows = conn.execute(pkg.ingest.DOC_ROW_SELECT.format(
                    id_col="chunk_id", table="chunks", text_col="text")).fetchall()
            index.chunks.insert([pkg.ingest.doc_row_from_store_row(r) for r in rows])
            assert _stats(pkg) == before
            return before

        _in_both(scenario)


    def test_store_only_tech_backfill_rescatters(self, port_store):
        """A row whose stored tech tokens went stale (here: blanked) stops
        matching in the tech lane once synced; the store-only tech-token
        backfill recomputes them, and the next poll scatters the slots
        back (``set_tech``)."""
        import importlib

        def scenario(pkg):
            backfill = importlib.import_module(
                f"{pkg.root}.scripts.tech_tokens_backfill")
            call = _ingest_one(pkg, "tb-1", "rolled back to v2.3.1 on broker-7")
            chunk = _chunk_ids(pkg, call)[0]
            syncer = pkg.sync.get_syncer()
            syncer.poll_once()

            def tech_hits():
                resp = pkg.retrieve.retrieve_evidence(
                    pkg.request({"query": "v2.3.1 broker-7", "debug": True}))
                return [r["chunk_id"]
                        for r in resp["debug"]["lanes"]["chunks"]["tech_tokens"]]

            assert tech_hits() == [chunk]
            with pkg.db.get_store().tx() as conn:
                conn.execute("UPDATE chunks SET tech_tokens='[]' WHERE chunk_id=?",
                             (chunk,))
            blanked = syncer.poll_once()
            assert tech_hits() == []
            pkg.ingest.set_store_only(True)
            assert backfill.backfill_table("chunks", dry_run=True) == 1
            assert tech_hits() == []
            changed = backfill.backfill_table("chunks")
            pkg.ingest.set_store_only(False)
            assert tech_hits() == []                   # store-only: not yet on the device
            restored = syncer.poll_once()
            assert tech_hits() == [chunk]
            return blanked, changed, restored

        blanked, changed, restored = _in_both(scenario)
        assert blanked["updated"] == 1 and changed == 1 and restored["updated"] == 1


class TestReconcile:
    def test_reconcile_inserts_missing_and_deletes_extra(self, port_store):
        def scenario(pkg):
            call_a = _ingest_one(pkg, "rc-1", "kafka consumer lag after rebalance")
            syncer = pkg.sync.get_syncer()
            syncer.poll_once()
            dead = {f"chunk:{i}" for i in _chunk_ids(pkg, call_a)}
            # a stale restore: a row the store no longer has ...
            pkg.ingest.set_store_only(True)
            pkg.ingest.delete_call(call_a)
            # ... and a store row the index lacks
            _ingest_one(pkg, "rc-2", "object store tiering cut checkout latency")
            pkg.pipeline.run_embedding_backfill(batch_size=8)
            pkg.ingest.set_store_only(False)
            counts = syncer.reconcile()
            ids = _ids(pkg, "tiering checkout latency")
            gone = _ids(pkg, "kafka consumer lag")
            assert ids and not dead & set(gone)
            return counts, ids, gone, _stats(pkg)

        counts, _ids_, _gone, stats = _in_both(scenario)
        assert counts["inserted"] >= 1 and counts["deleted"] >= 1
        assert stats["chunks"][2] >= 1

    def test_prune_respects_slowest_consumer(self, port_store):
        def scenario(pkg):
            def remaining():
                with pkg.db.get_store().read() as conn:
                    return conn.execute(
                        "SELECT COUNT(*) FROM index_mutations").fetchone()[0]

            fast, slow = pkg.sync.get_syncer(), pkg.sync.StoreSyncer()
            slow._heartbeat()                          # registers at seq 0
            _ingest_one(pkg, "pr-1", "certificate expiry outage window")
            fast.poll_once()
            held = remaining()
            slow.poll_once()
            fast.poll_once()
            return held, remaining()

        held, left = _in_both(scenario)
        assert held > 0 and left == 0                  # the slow consumer held them


class TestBackgroundLoop:
    def test_background_thread_applies_within_interval(self, port_store):
        def scenario(pkg):
            syncer = pkg.sync.get_syncer()
            syncer.start(0.05)
            try:
                pkg.ingest.set_store_only(True)
                _ingest_one(pkg, "bg-1", "vacuum stalls on the ledger table")
                pkg.ingest.set_store_only(False)
                deadline = time.monotonic() + 10
                ids = []
                while time.monotonic() < deadline and not ids:
                    ids = _ids(pkg, "vacuum ledger table")
                    time.sleep(0.05)
                return ids
            finally:
                syncer.stop()

        assert _in_both(scenario)


class TestSyncRobustness:
    def test_poison_embedding_blob_does_not_wedge(self, port_store, caplog):
        """A wrong-length embedding blob logs an update whose vector cannot
        be applied: the syncer skips it and keeps advancing the watermark."""
        def scenario(pkg):
            caplog.clear()
            call_a = _ingest_one(pkg, "poison-1", "grpc deadline exceeded in auth")
            syncer = pkg.sync.get_syncer()
            syncer.poll_once()
            cid = _chunk_ids(pkg, call_a)[0]
            with pkg.db.get_store().tx() as conn:
                conn.execute("UPDATE chunks SET embedding=? WHERE chunk_id=?",
                             (np.ones(7, np.float32).tobytes(), cid))
            poisoned = syncer.poll_once()              # must not raise
            assert any("bad_embedding_blob" in r.message for r in caplog.records)
            # a later good mutation still applies
            _ingest_one(pkg, "poison-2", "redis eviction spike on cache nine")
            pkg.ingest.set_store_only(True)
            _ingest_one(pkg, "poison-3", "dns resolution flap in the edge pop")
            pkg.ingest.set_store_only(False)
            return poisoned, syncer.poll_once(), _stats(pkg)

        _poisoned, counts, _ = _in_both(scenario)
        assert counts.get("inserted", 0) >= 1

    def test_deleted_blacklist_pruned_after_log_consumed(self, port_store):
        """``deleted_ids`` closes the mid-delete window; once the delete's log
        entry is behind the watermark the id cannot come back, so it leaves
        the blacklist."""
        def scenario(pkg):
            call_a = _ingest_one(pkg, "prune-1", "s3 multipart upload checksum bug")
            index = pkg.index.get_index()
            syncer = pkg.sync.get_syncer()
            syncer.poll_once()
            pkg.ingest.delete_call(call_a)
            open_window = sorted(index.chunks.deleted_ids)
            syncer.poll_once()                         # consumes the delete entries
            return open_window, sorted(index.chunks.deleted_ids)

        open_window, after = _in_both(scenario)
        assert open_window and after == []


def test_syncer_refuses_a_store_with_a_vocab_head(port_store):
    """What the syncer's poll does about a store whose lexical vocab another
    process built (``core/vocab.adopt_store_layout``, which replaced the
    stand-in that refused every such store): an applied head is adopted —
    activated, and every live row's signature refreshed from the store's
    blobs — and only a head whose apply never finished is refused. The
    auto-rebuild does nothing while its setting is off."""
    from cadence_rag_tpu_torch.core import vocab
    from cadence_rag_tpu_torch.ingest import featurize

    ingest_corpus(PORT)
    index, store = PORT.index.get_index(), PORT.db.get_store()
    syncer = PORT.sync.get_syncer()
    syncer.init_watermark()
    assert syncer.poll_once() == {}
    assert vocab.auto_rebuild_if_needed(store, index) is None
    before = index.chunks.state_arrays()["lex"]
    # another process (its own index, its own featurizer registry) applies
    # a head to the shared store; this process's registry is put back
    other = PORT.index.DeviceIndexManager("cpu")
    vocab.build_and_apply(store, other, head=48)
    applied = featurize.active_vocab()[0].copy()
    featurize.set_active_vocab(None, 0)
    syncer.poll_once()
    assert featurize.active_vocab()[1] == 1
    np.testing.assert_array_equal(featurize.active_vocab()[0], applied)
    after = index.chunks.state_arrays()["lex"]
    assert not np.array_equal(after, before)
    with store.read() as conn:
        blobs = {r["chunk_id"]: np.frombuffer(r["lex_sig"], np.int8) for r in
                 conn.execute("SELECT chunk_id, lex_sig FROM chunks")}
    for pos, doc_id in enumerate(index.chunks.h_ids[: index.chunks.count]):
        np.testing.assert_array_equal(after[pos], blobs[int(doc_id)])
    # an interrupted build leaves an unapplied row: refused, layout kept
    vocab.save_vocab(store, np.arange(1, 9, dtype=np.uint64), 1024)
    featurize.set_active_vocab(None, 0)
    with pytest.raises(RuntimeError, match="never completed"):
        syncer.poll_once()


def test_startup_reconciles_a_populated_index_and_starts_the_syncer(port_store,
                                                                    monkeypatch):
    """``startup`` over an index that already holds rows: rows the store
    gained and lost meanwhile are applied, and with
    ``STORE_SYNC_INTERVAL_S > 0`` the syncer's thread runs."""
    from cadence_rag_tpu_torch.serve.api import startup

    kept = _ingest_one(PORT, "st-1", "the gateway upgrade went out on tuesday")
    lost = _ingest_one(PORT, "st-2", "kafka consumer lag after the rebalance")
    lost_ids = {f"chunk:{i}" for i in _chunk_ids(PORT, lost)}
    PORT.ingest.set_store_only(True)
    PORT.ingest.delete_call(lost)
    gained = {f"chunk:{i}" for i in _chunk_ids(PORT, _ingest_one(
        PORT, "st-3", "object store tiering to SSD approved"))}
    PORT.ingest.set_store_only(False)

    def served():
        return set(_ids(PORT, "kafka consumer lag tiering SSD certificate expiry"))

    assert lost_ids <= served() and not gained & served()
    monkeypatch.setattr(PORT.settings, "store_sync_interval_s", 0.05)
    startup("cpu")
    syncer = PORT.sync.get_syncer()
    try:
        assert syncer._thread is not None and syncer._thread.is_alive()
        assert gained <= served() and not lost_ids & served()
        assert {f"chunk:{i}" for i in _chunk_ids(PORT, kept)} <= served()
        PORT.ingest.set_store_only(True)
        late = {f"chunk:{i}" for i in _chunk_ids(PORT, _ingest_one(
            PORT, "st-4", "certificate expiry caused the outage window"))}
        PORT.ingest.set_store_only(False)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not late <= served():
            time.sleep(0.05)
        assert late <= served()
    finally:
        syncer.stop()


# -- across processes -------------------------------------------------------------
BLOCK_JAX = """
import sys
for name in ("jax", "jaxlib", "cadence_rag_tpu"):
    sys.modules[name] = None
"""
SERVER = BLOCK_JAX + """
sys.argv = ["serve", "--host", "127.0.0.1", "--port", sys.argv[1], "--device", "cpu"]
from cadence_rag_tpu_torch.serve.http import main
main()
"""
SCANNER = BLOCK_JAX + """
sys.argv = ["ingest_scanner", "--once"]
from cadence_rag_tpu_torch.scripts.ingest_scanner import main
main()
"""
WORKER = BLOCK_JAX + """
sys.argv = ["ingest_worker", "--once"]
from cadence_rag_tpu_torch.scripts.ingest_worker import main
main()
"""
TECH_BACKFILL = BLOCK_JAX + """
sys.argv = ["tech_tokens_backfill"]
from cadence_rag_tpu_torch.scripts.tech_tokens_backfill import main
main()
"""
EMBED_BACKFILL = BLOCK_JAX + """
sys.argv = ["embed_backfill"]
from cadence_rag_tpu_torch.scripts.embed_backfill import main
main()
"""


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def _send(port, path, payload=None, method="POST"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        None if payload is None else json.dumps(payload).encode(),
        {"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _env(tmp_path, **extra):
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": str(REPO),
        "STORE_PATH": str(tmp_path / "shared.db"),
        "INGEST_ROOT_DIR": str(tmp_path / "ingest"),
        "EMBEDDINGS_PROVIDER": "stub", "EMBEDDINGS_BASE_URL": "",
        "EMBEDDINGS_DIM": "64", "LEXICAL_DIM": "1024",
        "INDEX_INITIAL_CAPACITY": "64", "INGEST_SINGLE_FILE_MIN_AGE_S": "0",
        "STORE_SYNC_INTERVAL_S": "0.2", "LOG_LEVEL": "INFO",
    })
    env.update(extra)
    return env


def _run(code, env, tmp_path, name, timeout=120):
    log = tmp_path / f"{name}.log"
    with open(log, "w") as out:
        proc = subprocess.run([sys.executable, "-c", code], env=env, stdout=out,
                              stderr=subprocess.STDOUT, timeout=timeout)
    assert proc.returncode == 0, log.read_text()[-3000:]


def _wait(check, what, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = check()
        if got:
            return got
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


def test_drop_folder_bundle_visible_without_restart(tmp_path):
    """The port's server in one process, its scanner, worker and backfill
    scripts in others, sharing only the SQLite store: a dropped bundle
    becomes retrievable through the live server, a store-only tech-token
    backfill and a DELETE reach it too, and no process imports jax."""
    env = _env(tmp_path)
    inbox = tmp_path / "ingest" / "inbox"
    inbox.mkdir(parents=True)
    port = _free_port()
    log = open(tmp_path / "server.log", "w")
    server = subprocess.Popen([sys.executable, "-c", SERVER, str(port)], env=env,
                              stdout=log, stderr=subprocess.STDOUT)
    query = {"query": "ECONNRESET rollback v2.3.1", "return_style": "ids_only"}
    try:
        def healthy():
            if server.poll() is not None:
                raise AssertionError(
                    "server died: " + (tmp_path / "server.log").read_text()[-3000:])
            try:
                return _get(port, "/health")["status"] == "ok"
            except OSError:
                return False

        _wait(healthy, "the server", timeout=120)
        assert _send(port, "/retrieve", query)["retrieved_ids"] == []

        bundle = inbox / "coherence-bundle"
        bundle.mkdir()
        (bundle / "transcript.json").write_text(json.dumps([
            {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 900,
             "text": "the ECONNRESET fix landed in rollback v2.3.1"},
            {"speaker": "Raj", "start_ts_ms": 1000, "end_ts_ms": 1900,
             "text": "object store tiering to SSD approved"}]))
        (bundle / "_READY").touch()
        _run(SCANNER, env, tmp_path, "scanner")
        _run(WORKER, env, tmp_path, "worker")

        # the job's bookkeeping went through the shared store
        jobs = _get(port, "/ingest/jobs")["items"]
        assert jobs and jobs[0]["status"] == "succeeded"
        job = _get(port, f"/ingest/jobs/{jobs[0]['ingest_job_id']}")
        assert job["files"] and job["call_id"]

        # the live server picks the rows up through its syncer
        ids = _wait(lambda: _send(port, "/retrieve", query)["retrieved_ids"],
                    "the worker's rows")
        assert any(i.startswith("chunk:") for i in ids), ids
        # caught up: applied_seq at or past the log's newest entry (the log
        # is pruned behind the slowest consumer, so store_seq may read 0)
        stats = _wait(lambda: (lambda s: s if s["sync"]["applied_seq"]
                               >= s["sync"]["store_seq"] else None)(
            _get(port, "/index/stats")), "the syncer to catch up")
        assert stats["sync"]["applied_seq"] > 0
        assert stats["chunks"]["count"] >= 1 and stats["device"] == "cpu"

        # the worker's auto-embed ran store-only: the dense lane comes up
        resp = _wait(lambda: (lambda r: r if r["notes"]["retrieval"]["lanes"]["dense"]
                              else None)(
            _send(port, "/retrieve", {"query": "tiering to SSD approved"})),
            "the dense lane")
        assert resp["quotes"]
        body = _send(port, "/expand", {"evidence_id": resp["quotes"][0]["evidence_id"]})
        assert body["snippet"]

        # the backfill scripts run store-only beside the server and change
        # nothing here (tokens and embeddings are current); the server keeps
        # answering the same
        _run(TECH_BACKFILL, env, tmp_path, "tech_backfill")
        _run(EMBED_BACKFILL, env, tmp_path, "embed_backfill")
        assert _send(port, "/retrieve", query)["retrieved_ids"] == ids

        # DELETE over HTTP: gone from the answers, tombstones in the stats
        out = _send(port, f"/calls/{job['call_id']}", method="DELETE")
        assert out["chunks_deleted"] >= 1
        assert _send(port, "/retrieve", query)["retrieved_ids"] == []
        assert _get(port, "/index/stats")["chunks"]["tombstones"] >= 1
    finally:
        server.terminate()
        server.wait(timeout=30)
        log.close()


@pytest.mark.parametrize("script", ["ingest_worker", "tech_tokens_backfill",
                                    "embed_backfill"])
def test_device_index_scripts_need_the_card_they_ask_for(tmp_path, script):
    """``--device-index`` without ``--device`` means cuda: without a card the
    script raises and nothing carries on on the CPU; with ``--device cpu``
    it runs."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    env = _env(tmp_path)
    code = BLOCK_JAX + f"""
sys.argv = ["{script}", "--device-index"] + sys.argv[1:]
from cadence_rag_tpu_torch.scripts.{script} import main
main()
"""
    extra = ["--once"] if script == "ingest_worker" else []
    proc = subprocess.run([sys.executable, "-c", code, *extra], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "cuda" in proc.stderr.lower()
    proc = subprocess.run([sys.executable, "-c", code, *extra, "--device", "cpu"],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
