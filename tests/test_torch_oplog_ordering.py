"""The op-log's ordering rules in the port, on the CPU: the counterpart of
the non-soak cases of tests/integration/test_oplog_ordering.py.

- under a gang both corpora share ONE lock, so each emit -> enqueue window
  is leader-wide atomic; one process keeps one lock per corpus;
- the insert-triggered IVF rebuild stands down under a gang unless
  ``DENSE_IVF_AUTO_REBUILD_MULTIHOST`` opts in; one process still
  schedules it;
- a follower's "compact" (``apply_compact_device``, the one implementation
  the leader runs too) drops the position-derived IVF state;
- the lexical vocab's auto-rebuild stands down in a gang;
- the leader emits each op before its device work, and a replay of the
  log on a twin index leaves the twin equal to the leader (sharded both).
"""

import time

import numpy as np
import torch

from cadence_rag_tpu_torch.config import settings
from cadence_rag_tpu_torch.core import index as index_mod
from cadence_rag_tpu_torch.core.index import (
    CorpusIndex, DeviceIndexManager, DocRow, IvfState,
)
from cadence_rag_tpu_torch.parallel import oplog
from cadence_rag_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")


def _tiny_corpus(mesh=None) -> CorpusIndex:
    return CorpusIndex("chunks", dim=8, lex_dim=32, tech_slots=4, capacity=8,
                       device=CPU, mesh=mesh)


def _dummy_ivf(overflow_count: int = 100, built_count: int = 16) -> IvfState:
    return IvfState(
        centroids=torch.zeros((2, 8)), buckets=torch.zeros((2, 4), dtype=torch.int32),
        overflow=torch.full((8,), -1, dtype=torch.int32),
        overflow_count=overflow_count, built_count=built_count, n_clusters=2,
        nprobe=1)


def _wait_for(check):
    for _ in range(200):
        if check():
            return True
        time.sleep(0.01)
    return False


class TestSharedDispatchLock:
    def test_multiprocess_manager_shares_one_lock(self, monkeypatch):
        monkeypatch.setattr(index_mod, "_multiprocess", lambda: True)
        mgr = DeviceIndexManager("cpu")
        assert mgr.chunks.lock is mgr.artifacts.lock

    def test_single_process_keeps_separate_locks(self, monkeypatch):
        monkeypatch.setattr(index_mod, "_multiprocess", lambda: False)
        mgr = DeviceIndexManager("cpu")
        assert mgr.chunks.lock is not mgr.artifacts.lock


class TestAutoRebuildStanddown:
    def test_stands_down_under_multiprocess(self, monkeypatch):
        corpus = _tiny_corpus()
        corpus.ivf = _dummy_ivf()
        monkeypatch.setattr(index_mod, "_multiprocess", lambda: True)
        monkeypatch.setattr(settings, "dense_ivf_enabled", True)
        monkeypatch.setattr(settings, "dense_ivf_auto_rebuild_multihost", False)
        corpus._maybe_schedule_ivf_rebuild()
        assert corpus._ivf_rebuilding is False
        assert corpus._ivf_rebuild_warned is True

    def test_opt_in_allows_rebuild(self, monkeypatch):
        corpus = _tiny_corpus()
        corpus.ivf = _dummy_ivf()
        monkeypatch.setattr(index_mod, "_multiprocess", lambda: True)
        monkeypatch.setattr(settings, "dense_ivf_enabled", True)
        monkeypatch.setattr(settings, "dense_ivf_auto_rebuild_multihost", True)
        calls = []
        monkeypatch.setattr(corpus, "build_ivf", lambda **kw: calls.append(kw))
        corpus._maybe_schedule_ivf_rebuild()
        assert _wait_for(lambda: calls and not corpus._ivf_rebuilding), \
            "opt-in multihost auto-rebuild did not fire"

    def test_single_process_still_schedules(self, monkeypatch):
        corpus = _tiny_corpus()
        corpus.ivf = _dummy_ivf()
        monkeypatch.setattr(index_mod, "_multiprocess", lambda: False)
        monkeypatch.setattr(settings, "dense_ivf_enabled", True)
        calls = []
        monkeypatch.setattr(corpus, "build_ivf", lambda **kw: calls.append(kw))
        corpus._maybe_schedule_ivf_rebuild()
        assert _wait_for(lambda: bool(calls)), "single-process auto-rebuild did not fire"


class TestCompactInvalidatesIvf:
    def test_apply_compact_device_clears_ivf(self):
        corpus = _tiny_corpus()
        corpus.ivf = _dummy_ivf()
        corpus._ivf_overflow_host = np.array([1, 2, 3], dtype=np.int32)
        corpus.apply_compact_device(np.zeros(8, dtype=np.int32), 0, 8)
        assert corpus.ivf is None
        assert corpus._ivf_overflow_host.size == 0

    def test_sharded_follower_compact_clears_ivf(self):
        corpus = _tiny_corpus(make_mesh("data:2", ["cpu", "cpu"]))
        corpus.ivf = _dummy_ivf()
        corpus._ivf_overflow_host = np.array([1, 2, 3], dtype=np.int32)
        mgr = type("M", (), {"corpus": lambda self, name: corpus})()
        oplog._apply(mgr, "compact", {"corpus": "chunks", "out_rows": 0, "cap": 8},
                     {"live": np.zeros(0, dtype=np.int32)})
        assert corpus.ivf is None and corpus._ivf_overflow_host.size == 0


def test_vocab_auto_rebuild_stands_down_in_a_gang(monkeypatch):
    from cadence_rag_tpu_torch.core import vocab

    monkeypatch.setattr(settings, "lex_vocab_auto_rebuild", True)
    monkeypatch.setattr(settings, "dist_num_processes", 2)
    assert vocab.auto_rebuild_if_needed(None, None, force_check=True) is None


class _Log:
    """An op-log that replays each op on a follower's twin index at once,
    and records the order of emits and device writes."""

    def __init__(self, follower, events):
        self.follower, self.events = follower, events

    def emit(self, op, statics=None, arrays=None):
        self.events.append(("emit", op))
        arrays = {k: (v.clone() if isinstance(v, torch.Tensor) else np.array(v))
                  for k, v in (arrays or {}).items()}
        # a follower mirrors nothing itself
        index_mod._oplog = None
        try:
            oplog._apply(self.follower, op, statics or {}, arrays)
        finally:
            index_mod._oplog = self


def test_a_replayed_log_keeps_the_twin_equal(monkeypatch):
    """Every write of a sharded leader, replayed through ``oplog._apply`` on
    a twin index, leaves the twin's shards equal to the leader's: inserts
    past a growth, a backfill, tech and lexical scatters, deletes, a
    compaction and a restore's allocation and slabs."""
    mesh = make_mesh("data:4", ["cpu"] * 4)
    for name, value in (("index_initial_capacity", 16), ("embeddings_dim", 8),
                        ("lexical_dim", 32), ("tech_hash_slots", 4)):
        monkeypatch.setattr(settings, name, value)
    leader, twin = DeviceIndexManager("cpu", mesh), DeviceIndexManager("cpu", mesh)
    events = []
    original = index_mod.CorpusIndex._write
    monkeypatch.setattr(index_mod.CorpusIndex, "_write", lambda self, *a, **k: (
        events.append(("write", a[0])), original(self, *a, **k))[1])
    monkeypatch.setattr(index_mod, "_oplog", _Log(twin, events))
    rng = np.random.default_rng(3)

    def rows(first, n):
        return [DocRow(doc_id=first + i, call_seq=i % 3, started_sec=1000 + i,
                       lex_sig=rng.integers(-3, 4, 32).astype(np.int8), lex_dl=5,
                       lex_touched=np.array([1, 2]),
                       tech=rng.integers(0, 9, 4).astype(np.int32),
                       embedding=None) for i in range(n)]

    c = leader.chunks
    for first in (1, 11, 21):
        c.insert(rows(first, 10))
    assert c.capacity == 64    # pow2-padded slabs: 16 -> 32 -> 64
    vecs = rng.standard_normal((6, 8)).astype(np.float32)
    c.set_embeddings([2, 5, 22, 23, 29, 99], vecs / np.linalg.norm(vecs, axis=1,
                                                                    keepdims=True))
    c.set_tech([3, 24], rng.integers(0, 9, (2, 4)).astype(np.int32))
    c.set_lex([4, 25], rng.integers(-3, 4, (2, 32)).astype(np.int8))
    c.delete_ids(list(range(1, 30, 3)))
    c.compact()
    # every device write comes after the emit of its own op (the twin
    # replays inside the emit, so its write sits between the two)
    last_emit = None
    for kind, op in events:
        if kind == "emit":
            last_emit = op
        else:
            assert op == last_emit, (op, last_emit)
    state = c.state_arrays()
    twin.chunks.h_ids, twin.chunks.h_call = c.h_ids, c.h_call
    twin.chunks.h_started, twin.chunks.h_has_emb = c.h_started, c.h_has_emb
    twin.chunks.doc_freq, twin.chunks.dl_sum = c.doc_freq, c.dl_sum
    assert twin.chunks.count == c.count and twin.chunks.capacity == c.capacity
    for key, value in twin.chunks.state_arrays().items():
        np.testing.assert_array_equal(value, state[key], err_msg=key)
    # a restore's "alloc" and slab writes
    c.load_state(state)
    for key, value in twin.chunks.state_arrays().items():
        np.testing.assert_array_equal(value, state[key], err_msg=key)
    ops = [op for kind, op in events if kind == "emit"]
    for op in ("write_slabs", "grow", "scatter_emb", "scatter_tech", "scatter_lex",
               "tombstone", "compact", "alloc"):
        assert op in ops, op
