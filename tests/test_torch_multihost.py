"""Multi-process lockstep serving, the port on the CPU: the counterpart of
tests/integration/test_multiprocess.py and
tests/integration/test_multihost_serving.py.

Gangs of OS processes over ``torch.distributed``'s gloo backend, each
holding its shards of ``MESH_SHAPE`` on the CPU:

- ``evals/dist_check`` (two processes): the sharded lanes across the
  process boundary against a one-process oracle;
- the real serve startup (``serve/http.py`` -> ``api.startup`` ->
  ``oplog.install_leader`` / ``follower_main``) as a two-process gang,
  driven over HTTP (ingest past the 64-row capacity, an artifact, a
  delete, retrievals) against a one-process server: identical answers; a
  follower exits 0 after its leader's shutdown and nonzero when the leader
  is killed;
- the engine-level gang (``_torch_multihost_worker.py``): checkpoint
  restore, the cold-start fallback, the backfill, the packed path, delete
  and compaction, the IVF build and its overflow, in bf16 and int8, equal
  to the same scenario in one process; its v3 save restores in one process
  of the port and in the JAX package byte-equal to the one-process state,
  and both answer with the same ids;
- the op-log's own cases, as the JAX package's tests state them (follower
  loss, the unauthenticated peer), compiled against the port.

Every subprocess has its own timeout.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import JAX, PORT, mirror_tests, port_store, set_both  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).resolve().parent / "_torch_multihost_worker.py")

mirrored = mirror_tests(globals(), "multihost_serving",
                        "integration/test_multihost_serving.py", drop={
    # the gang itself runs below against the port's server and worker
    "TestMultihostServing": ["test_two_process_gang_matches_single_process",
                             "test_restore_backfill_and_fallback_ops"],
})
_free_port, _post, _wait_health, _drive = (
    mirrored._free_port, mirrored._post, mirrored._wait_health, mirrored._drive)


def test_the_mirrored_tests_ran_against_the_port():
    from cadence_rag_tpu_torch.parallel import oplog

    assert mirrored.__dict__["TestFollowerLoss"].__module__ == mirrored.__name__
    src = Path(mirrored.__file__).read_text()
    assert "from cadence_rag_tpu.parallel.oplog import" in src
    assert oplog.LeaderOpLog.__module__ == "cadence_rag_tpu_torch.parallel.oplog"


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def test_dist_check_two_processes():
    proc = subprocess.run(
        [sys.executable, "-m", "cadence_rag_tpu_torch.evals.dist_check",
         "--device", "cpu", "--processes", "2", "--devices-per-process", "2",
         "--port", str(_free_port())],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DIST CHECK PASSED" in proc.stdout
    assert proc.stdout.count("MATCH") == 2, proc.stdout


# -- the served gang -------------------------------------------------------------
def _spawn(tmp_path, name, port, extra_env):
    env = _env({
        "STORE_PATH": str(tmp_path / f"{name}.db"),
        "EMBEDDINGS_PROVIDER": "stub",
        "EMBEDDINGS_BASE_URL": "",
        "INDEX_INITIAL_CAPACITY": "64",
        "LOG_LEVEL": "INFO",
    })
    env.update(extra_env)
    log = open(tmp_path / f"{name}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "cadence_rag_tpu_torch.serve.http", "--host",
         "127.0.0.1", "--port", str(port), "--device", "cpu"],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)


def _gang(tmp_path, http_port, mesh_shape="data:2"):
    coord = _free_port()
    gang_env = {
        "DIST_COORDINATOR": f"127.0.0.1:{coord}",
        "DIST_NUM_PROCESSES": "2",
        "DIST_OPLOG_PORT": str(_free_port()),
        "MESH_SHAPE": mesh_shape,
    }
    follower = _spawn(tmp_path, "follower", _free_port(),
                      {**gang_env, "DIST_PROCESS_ID": "1"})
    leader = _spawn(tmp_path, "leader", http_port,
                    {**gang_env, "DIST_PROCESS_ID": "0"})
    return leader, follower


def _stop(proc, timeout=30):
    if proc.poll() is None:
        proc.terminate()
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(10)
        raise


@pytest.mark.parametrize("mesh_shape", ["data:2", "data:1,model:2"])
def test_two_process_gang_matches_single_process(tmp_path, mesh_shape):
    """The gang answers as one process. Under ``data:1,model:2`` both
    processes hold the one data shard (the model axis replicates rows):
    each computes it, and the gather keeps the leader's copy."""
    http_port = _free_port()
    leader, follower = _gang(tmp_path, http_port, mesh_shape)
    try:
        _wait_health(http_port, leader, timeout_s=120)
        gang = _drive(http_port)
        _stop(leader)
        # the leader's shutdown reaches the follower, which exits 0
        assert follower.wait(timeout=60) == 0, (tmp_path / "follower.log").read_text()
    finally:
        for proc in (leader, follower):
            if proc.poll() is None:
                proc.kill()
    logs = (tmp_path / "leader.log").read_text()
    assert "backend=gloo" in logs and "oplog.leader_ready" in logs
    assert gang["capacity"] > 64, "the scenario must grow the index"
    assert gang["counts"][0] > 64 and gang["counts"][1] >= 1

    oracle_port = _free_port()
    oracle = _spawn(tmp_path, "oracle", oracle_port, {})
    try:
        _wait_health(oracle_port, oracle, timeout_s=120)
        solo = _drive(oracle_port)
    finally:
        _stop(oracle)
    assert gang == solo


def test_follower_exits_nonzero_when_the_leader_is_lost(tmp_path):
    http_port = _free_port()
    leader, follower = _gang(tmp_path, http_port)
    try:
        _wait_health(http_port, leader, timeout_s=120)
        leader.send_signal(signal.SIGKILL)
        leader.wait(30)
        rc = follower.wait(timeout=60)
    finally:
        for proc in (leader, follower):
            if proc.poll() is None:
                proc.kill()
    assert rc != 0
    assert "went away without a shutdown" in (tmp_path / "follower.log").read_text()


# -- the engine-level gang -----------------------------------------------------------
WORDS = ["kafka", "timeout", "incident", "rollback", "billing", "cache",
         "deploy", "latency"]


def _seed_corpus():
    s = PORT.schemas
    for c in range(3):
        turns = [
            s.UtteranceIn(
                speaker="A", start_ts_ms=i * 5000, end_ts_ms=i * 5000 + 4500,
                text=" ".join(WORDS[(c + i + j) % len(WORDS)] for j in range(8))
                + f" s{c} step {i}")
            for i in range(20)
        ]
        PORT.ingest.ingest_transcript(
            s.CallRef(external_id=f"seed-{c}"), turns,
            s.ChunkingOptions(target_tokens=16, max_tokens=32, overlap_tokens=0))


def _oracle_scenario(ckpt):
    """The worker's scenario in this process, on one device: -> RESULT"""
    from datetime import datetime, timezone

    s = PORT.schemas
    index = PORT.index.get_index()

    def ids(query):
        return PORT.retrieve.retrieve_evidence_batch(
            [s.RetrieveRequest(query=query, return_style="ids_only")]
        )[0]["retrieved_ids"]

    out = {"counts": [index.chunks.count, index.artifacts.count]}
    out["restored"] = ids("kafka timeout incident")
    PORT.pipeline.run_embedding_backfill(batch_size=16)
    out["embedded"] = int(index.chunks.emb_rows)
    out["dense"] = ids("kafka timeout incident")
    PORT.ingest.ingest_analysis(
        s.CallRef(external_id="seed-0"),
        [s.AnalysisArtifactIn(kind="summary", content="kafka incident rollback summary")])
    out["packed"] = ids("kafka rollback")
    index.chunks.delete_ids(index.chunks.h_ids[: index.chunks.count][::3].tolist())
    index.chunks.compact()
    out["compacted_count"] = int(index.chunks.count)
    out["post_compact"] = ids("kafka timeout incident")
    state = index.chunks.build_ivf(n_clusters=8, seed=7)
    out["ivf_plan"] = [state.built_count, state.n_clusters, state.nprobe]
    out["ivf_usable"] = bool(index.chunks.ivf_usable())
    out["ivf_ids"] = ids("kafka timeout incident")
    PORT.ingest.ingest_transcript(
        s.CallRef(external_id="post-ivf",
                  started_at=datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)),
        [s.UtteranceIn(speaker="B", start_ts_ms=0, end_ts_ms=4000,
                       text="cache latency deploy rollback billing")],
        s.ChunkingOptions(target_tokens=16, max_tokens=32, overlap_tokens=0))
    out["ivf_overflow"] = int(index.chunks.ivf.overflow_count)
    out["post_overflow_ids"] = ids("kafka timeout incident")
    out["saved_format"] = 3
    out["saved_counts"] = [index.chunks.count, index.artifacts.count]
    return out


def _copy_db(src, dst):
    shutil.copyfile(src, dst)
    for suffix in ("-wal", "-shm"):
        if Path(str(src) + suffix).exists():
            shutil.copyfile(str(src) + suffix, str(dst) + suffix)


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_restore_backfill_and_fallback_ops(port_store, set_both, tmp_path, emb_dtype):
    set_both("index_embedding_dtype", emb_dtype)
    # 16-row capacities: every process's shards hold rows
    set_both("index_initial_capacity", 16)
    PORT.index.reset_index()
    PORT.index.get_index("cpu")
    _seed_corpus()
    ckpt = str(tmp_path / "ckpt")
    PORT.checkpoint.save_index(ckpt)
    _copy_db(port_store.store_path, tmp_path / "leader.db")
    set_both("dense_ivf_enabled", True)
    set_both("ivf_min_rows", 1)
    oracle = _oracle_scenario(ckpt)
    index = PORT.index.get_index()
    oracle_state = {c.name: c.state_arrays() for c in (index.chunks, index.artifacts)}

    coord = _free_port()
    env = _env({
        "MESH_SHAPE": "data:4", "LEXICAL_DIM": "1024", "EMBEDDINGS_DIM": "64",
        "INDEX_INITIAL_CAPACITY": "16", "INDEX_EMBEDDING_DTYPE": emb_dtype,
        "DENSE_IVF_ENABLED": "1", "IVF_MIN_ROWS": "1",
        "EMBEDDINGS_PROVIDER": "stub", "EMBEDDINGS_BASE_URL": "",
        "STORE_SYNC_INTERVAL_S": "0",
    })
    gang_ckpt = str(tmp_path / "gang_ckpt")
    oplog_port = _free_port()
    procs = []
    for pid, db in ((1, tmp_path / "follower.db"), (0, tmp_path / "leader.db")):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(pid), f"127.0.0.1:{coord}",
             str(oplog_port), ckpt, gang_ckpt],
            env={**env, "STORE_PATH": str(db)},
            stdout=open(tmp_path / f"p{pid}.log", "w"),
            stderr=subprocess.STDOUT, cwd=REPO))
    follower, leader = procs
    try:
        rc = leader.wait(timeout=240)
        frc = follower.wait(timeout=60)
    finally:
        for proc in (leader, follower):
            if proc.poll() is None:
                proc.kill()
    leader_out = (tmp_path / "p0.log").read_text()
    assert rc == 0 and frc == 0, leader_out + (tmp_path / "p1.log").read_text()
    result = [ln for ln in leader_out.splitlines() if ln.startswith("RESULT ")]
    assert result, leader_out
    assert json.loads(result[0][len("RESULT "):]) == oracle

    # the gang's v3 save, restored in one process of the port and in the
    # JAX package: byte-equal to the one-process state
    meta = json.loads((Path(gang_ckpt) / "meta.json").read_text())
    assert meta["format_version"] == 3
    # row blocks of both processes' shards (the follower holds the back half)
    assert meta["heavy_files"]["chunks"] == [
        f"chunks.g0000.r{8 * s:010d}.npz" for s in range(3)], meta["heavy_files"]
    PORT.index.reset_index()
    port_index = PORT.index.get_index("cpu")
    PORT.checkpoint.restore_index(gang_ckpt, port_index)
    JAX.index.reset_index()
    assert JAX.checkpoint.restore_index(gang_ckpt)["format_version"] == 3
    jax_index = JAX.index.get_index()
    for name in ("chunks", "artifact_chunks"):
        want = oracle_state[name]
        for got in (port_index.corpus(name).state_arrays(),
                    jax_index.corpus(name).state_arrays()):
            for key in want:
                np.testing.assert_array_equal(
                    np.asarray(got[key]).astype(want[key].dtype), want[key],
                    err_msg=f"{name} {key}")
    # and both packages answer a query of every lane with the same ids
    chunks = port_index.chunks
    rows = np.flatnonzero(chunks.h_has_emb[: chunks.count])[:4]
    q_emb = chunks.state_arrays()["emb"][rows].astype(np.float32)
    if emb_dtype == "int8":
        q_emb = q_emb / 127.0
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    lex = chunks.state_arrays()["lex"][rows].astype(np.float32)
    batch = len(rows)
    args = (q_emb, lex, np.zeros((batch, chunks.tech_slots), np.int32),
            np.ones((batch, port_index.call_capacity), bool),
            np.full(batch, np.iinfo(np.int32).min + 1, np.int32),
            np.full(batch, np.iinfo(np.int32).max, np.int32))
    ks = dict(k_dense=5, k_lex=5, k_tech=5, dense_mode="exact")
    got = port_index.chunks.query(*args, **ks)
    want = jax_index.chunks.query(*args, **ks)
    for lane in ("dense", "lex"):
        np.testing.assert_array_equal(got[lane][0], want[lane][0], err_msg=lane)
        np.testing.assert_array_equal(got[lane][0][:, 0], chunks.h_ids[rows])
