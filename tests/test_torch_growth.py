"""Capacity growth, its planner and the background migration, JAX package
vs port, on the CPU.

``tests/integration/test_capacity_growth.py`` and ``tests/integration/
test_growth_migration.py`` run against the port as they stand
(``torch_parity.mirror_tests``), with the corpus made on the CPU in bf16
(the port stores bf16 or int8, not f32) and embedding rows read back through
``.float()``. Then:

- ``plan_next_capacity`` against the JAX package's on the same inputs (a
  doubling, a fractional step of capacity/8, nothing fits), and the planner
  cases of ``tests/integration/test_prewarm.py`` in the port: the fractional
  step, growth landing on the planned capacity, no migration when the next
  capacity cannot fit; on the CPU the static budget applies;
- the trigger: a corpus that passes ``PREWARM_FILL_FRACTION`` of a capacity
  of at least ``PREWARM_MIN_CAPACITY`` starts one migration, the next growth
  is a swap, and ``GROWTH_MIGRATION_ENABLED=0`` keeps growth synchronous;
- both packages' corpora take the same writes across a migration and its
  swap: ``state_arrays`` bit-equal;
- a threads stress test: a writer keeps inserting, scattering and deleting
  while the migration copies and the swap lands, and the swapped corpus is
  bit-equal to a twin that grew synchronously; the same run with the replay
  taken out loses writes and must differ.
"""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from cadence_rag_tpu.core import prewarm as jax_prewarm
from cadence_rag_tpu.core.index import CorpusIndex as JaxCorpus
from cadence_rag_tpu.core.index import DocRow as JaxDocRow
from cadence_rag_tpu_torch.core import index as port_index_mod
from cadence_rag_tpu_torch.core import prewarm as port_prewarm
from cadence_rag_tpu_torch.core.index import (
    CorpusIndex,
    DeviceIndexManager,
    DocRow,
    GrowthMigration,
)
from cadence_rag_tpu_torch.utils import events
from torch_parity import (
    mirror_tests,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)

CPU = torch.device("cpu")
ON_CPU_BF16 = (
    (r'emb_dtype="float32",',
     'emb_dtype="bfloat16", device=__import__("torch").device("cpu"),'),
    (r"np\.asarray\((\w+)\.emb\[([^\]]*)\]\)", r"np.asarray(\1.emb[\2].float())"),
)


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_tests(globals(), "capacity_growth", "integration/test_capacity_growth.py",
             rewrites=ON_CPU_BF16)
mirror_tests(globals(), "growth_migration", "integration/test_growth_migration.py",
             rewrites=ON_CPU_BF16)
# The same migration cases under a one-process mesh of data:2, in both
# packages: the corpus row-sharded over two CPU devices, its arrays read
# back whole (the port's shards gathered in row order).
ON_DATA2_PORT = ON_CPU_BF16 + (
    (r'device=__import__\("torch"\)\.device\("cpu"\),',
     r'\g<0> mesh=__import__("cadence_rag_tpu_torch.parallel.mesh", '
     r'fromlist=["make_mesh"]).make_mesh("data:2", device="cpu"),'),
    (r"\b(\w+)\.(emb|lex|tech|call_idx|started|has_emb)\[",
     r'\1._gather_rows("\2", \1.count)['),
)
ON_DATA2_JAX = (
    (r'emb_dtype="float32",',
     r'\g<0> row_sharding=__import__("jax").sharding.NamedSharding('
     r'__import__("cadence_rag_tpu.parallel.mesh", fromlist=["make_mesh"])'
     r'.make_mesh("data:2", __import__("jax").devices()[:2]), '
     r'__import__("jax").sharding.PartitionSpec("data", None)),'),
)
mirror_tests(globals(), "growth_migration_data2",
             "integration/test_growth_migration.py", rewrites=ON_DATA2_PORT)
mirror_tests(globals(), "jax_growth_migration_data2",
             "integration/test_growth_migration.py", rewrites=ON_DATA2_JAX,
             port=False)


def test_the_mirrored_tests_ran_against_the_port():
    for stem in ("capacity_growth", "growth_migration", "growth_migration_data2"):
        assert sys.modules[f"{__name__}.{stem}"].CorpusIndex is CorpusIndex
    assert (sys.modules[f"{__name__}.jax_growth_migration_data2"].CorpusIndex
            is JaxCorpus)


def test_the_data2_cases_run_sharded(port_store):
    """The rewrites reach the corpus: both packages' data:2 corpora are
    row-sharded over two devices, and a migration runs under them."""
    port_c = sys.modules[f"{__name__}.growth_migration_data2"]._corpus()
    jax_c = sys.modules[f"{__name__}.jax_growth_migration_data2"]._corpus()
    assert port_c.mesh is not None and port_c.n_shards == 2
    assert len(port_c.local_shards()) == 2
    assert jax_c.row_sharding is not None
    assert len(jax_c.emb.sharding.device_set) == 2
    port_c.insert(_rows(1, 40, dim=16, lex_dim=64, slots=4))
    assert port_c.start_migration(128)
    assert port_c._migration.ready.wait(30)


# -- the planner ----------------------------------------------------------------------
def _fake(capacity=1_048_576, **kw):
    fields = dict(capacity=capacity, dim=1024, emb_dtype=np.dtype(np.float16),
                  lex_dim=4096, tech_slots=16, row_sharding=None, device=None)
    fields.update(kw)
    return types.SimpleNamespace(**fields)


@pytest.mark.parametrize("rows_that_fit", [100, 1_150_000, 1_350_000, 1_900_000,
                                           2_100_000, 5_000_000])
@pytest.mark.parametrize("need_extra", [1, 200_000, 1_500_000])
def test_plan_next_capacity_matches(rows_that_fit, need_extra):
    """The same corpus, need and free memory: the JAX planner's capacity."""
    fake = _fake()
    row = port_prewarm._corpus_row_bytes(fake)
    assert row == jax_prewarm._corpus_row_bytes(fake) == 1024 * 2 + 4096 + 64 + 16
    free = int(rows_that_fit * row / 0.85)
    need = fake.capacity + need_extra
    got = port_prewarm.plan_next_capacity(fake, need, free=free)
    assert got == jax_prewarm.plan_next_capacity(fake, need, free=free)
    assert got >= need


def test_fractional_growth_when_doubling_cannot_fit():
    fake = _fake()
    row = port_prewarm._corpus_row_bytes(fake)
    free = int(1_350_000 * row / 0.85)
    cap = port_prewarm.plan_next_capacity(fake, fake.capacity + 1, free=free)
    assert fake.capacity < cap < 2 * fake.capacity
    assert cap % (fake.capacity // 8) == 0
    # plenty of room: the doubling; nothing fits: the doubling all the same
    assert port_prewarm.plan_next_capacity(
        fake, fake.capacity + 1, free=int(64e9)) == 2 * fake.capacity
    assert port_prewarm.plan_next_capacity(
        fake, fake.capacity + 1, free=1024) == 2 * fake.capacity


def test_the_cpu_plans_with_the_static_budget(port_store, set_both):
    """No device memory to ask on the CPU: ``free_hbm_bytes`` is None and the
    planner falls back to ``PREWARM_HBM_BUDGET_GB``, as the JAX package does
    where its backend reports nothing."""
    assert port_prewarm.free_hbm_bytes(CPU) is None
    assert port_prewarm.free_hbm_bytes(None) is None
    corpus = CorpusIndex("chunks", dim=64, lex_dim=256, tech_slots=16,
                         capacity=1024, device=CPU)
    fake = _fake(capacity=1024, dim=64, lex_dim=256, emb_dtype=np.dtype(np.float16))
    row = port_prewarm._corpus_row_bytes(corpus)
    assert row == jax_prewarm._corpus_row_bytes(fake)
    for budget_rows in (100_000, 2700, 2300, 10):
        set_both("prewarm_hbm_budget_gb", budget_rows * row / (1 << 30))
        got = port_prewarm.plan_next_capacity(corpus, 1025, batch=1)
        assert got == jax_prewarm.plan_next_capacity(fake, 1025, batch=1)
    assert got == 2048                                   # nothing fits


def _rows(start, n, cls=DocRow, dim=64, lex_dim=1024, slots=16):
    rng = np.random.default_rng(start)
    out = []
    for i in range(start, start + n):
        emb = rng.standard_normal(dim).astype(np.float32)
        sig = rng.integers(-3, 4, size=lex_dim).astype(np.int8)
        out.append(cls(
            doc_id=i, call_seq=i % 7, started_sec=1_700_000_000 + i,
            lex_sig=sig, lex_dl=10,
            lex_touched=np.flatnonzero(sig)[:32].astype(np.int32),
            tech=rng.integers(1, 99, size=slots).astype(np.int32),
            embedding=emb / np.linalg.norm(emb) if i % 5 else None))
    return out


@pytest.fixture()
def trigger_env(port_store, monkeypatch):
    monkeypatch.setattr(port_store, "prewarm_growth_enabled", True)
    monkeypatch.setattr(port_store, "prewarm_min_capacity", 256)
    monkeypatch.setattr(port_store, "prewarm_fill_fraction", 0.75)
    return port_store


def _wait_ready(corpus, timeout=30.0):
    mig = corpus._migration
    assert mig is not None and mig.ready.wait(timeout), "migration never became ready"
    return mig


def test_growth_lands_on_planned_capacity(trigger_env):
    """The capacity growth allocates is the one the planner recorded; a
    need beyond a stale plan gets a fresh one."""
    index = DeviceIndexManager("cpu")
    index.chunks.insert(_rows(1, 100))
    index.prewarmer._planned[("chunks", 256)] = 384
    index.chunks.insert(_rows(101, 200))      # 200 -> a 256-row slab: need 356
    assert index.chunks.capacity == 384
    index.prewarmer._planned[("chunks", 384)] = 390
    index.chunks.insert(_rows(301, 100))      # need 428 > 390
    assert index.chunks.capacity == 768


def test_no_migration_when_the_next_capacity_cannot_fit(trigger_env, monkeypatch):
    index = DeviceIndexManager("cpu")
    monkeypatch.setattr(trigger_env, "prewarm_hbm_budget_gb", 1e-6)
    index.chunks.insert(_rows(1, 220))        # past 75% of 256
    index.artifacts.insert(_rows(1, 16))
    assert not index.prewarmer.maybe_prewarm()
    assert index.chunks._migration is None
    monkeypatch.setattr(trigger_env, "prewarm_hbm_budget_gb", 12.0)
    assert index.prewarmer.maybe_prewarm()
    assert _wait_ready(index.chunks).new_cap == 512
    monkeypatch.setattr(trigger_env, "prewarm_growth_enabled", False)
    index.chunks._cancel_migration_locked()
    assert not index.prewarmer.maybe_prewarm()


def test_the_trigger_starts_one_migration_and_growth_swaps(trigger_env):
    """Past the fill fraction the insert itself starts the migration; the
    next growth is ``index.growth_swap``, not ``index.grow``; two corpora
    near growth migrate one at a time, the fuller first."""
    index = DeviceIndexManager("cpu")
    index.chunks.insert(_rows(1, 100))
    assert index.chunks._migration is None            # 39% of 256
    index.artifacts.insert(_rows(1, 200))             # 78%
    index.chunks.insert(_rows(101, 120))              # 86%: both near growth
    assert index.artifacts._migration is not None     # it was there first
    assert index.chunks._migration is None            # one at a time
    assert _wait_ready(index.artifacts).new_cap == 512
    events.enable()
    try:
        index.artifacts.insert(_rows(201, 100))       # need 328: the swap
        index.chunks.insert(_rows(221, 1))            # now the chunks' turn
        _wait_ready(index.chunks)
        index.chunks.insert(_rows(222, 60))           # need 286: the swap
        tags = [e["tag"] for e in events.drain()]
    finally:
        events.disable()
    assert tags.count("index.growth_swap") == 2 and "index.grow" not in tags
    assert index.artifacts.capacity == 512 and index.chunks.capacity == 512
    assert index.artifacts.count == 300 and index.chunks.count == 281
    twin = CorpusIndex("chunks", dim=64, lex_dim=1024, tech_slots=16,
                       capacity=256, device=CPU)
    for lo, n in ((1, 100), (101, 120), (221, 1), (222, 60)):
        twin.insert(_rows(lo, n))
    for key, want in twin.state_arrays().items():
        np.testing.assert_array_equal(index.chunks.state_arrays()[key], want, key)


def test_migration_disabled_grows_synchronously(trigger_env, monkeypatch):
    monkeypatch.setattr(trigger_env, "growth_migration_enabled", False)
    index = DeviceIndexManager("cpu")
    index.chunks.insert(_rows(1, 220))
    assert index.chunks._migration is None
    assert not index.chunks.start_migration(512)
    events.enable()
    try:
        index.chunks.insert(_rows(221, 100))
        tags = [e["tag"] for e in events.drain()]
    finally:
        events.disable()
    assert "index.grow" in tags and "index.growth_swap" not in tags
    assert index.chunks.capacity == 512
    # a corpus with a cold tier caps its device rows: no migration either
    monkeypatch.setattr(trigger_env, "growth_migration_enabled", True)
    monkeypatch.setattr(trigger_env, "index_max_device_rows", 128)
    capped = CorpusIndex("chunks", dim=64, lex_dim=1024, tech_slots=16,
                         capacity=64, device=CPU)
    assert not capped.start_migration(256)


# -- both packages across a migration ---------------------------------------------------
def _mutate(corpus, rows_cls):
    corpus.insert(_rows(500, 3, rows_cls, dim=16, lex_dim=64, slots=4))
    corpus.set_embeddings([3, 5, 6], np.stack([np.full(16, 0.25, np.float32)] * 3))
    corpus.set_tech([10, 11], np.full((2, 4), 7, np.int32))
    corpus.set_lex([12], np.full((1, 64), 2, np.int8))
    corpus.set_lex_ids([13, 9999], np.full((2, 64), -3, np.int8))
    corpus.delete_ids([20, 21, 21])


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_migrated_state_matches_the_jax_package(port_store, emb_dtype):
    """Inserts, every kind of scatter and a delete while a migration is
    live, then the swap, in both packages: ``state_arrays`` bit-equal (bf16
    rows by their bits)."""
    kw = dict(dim=16, lex_dim=64, tech_slots=4, capacity=64, emb_dtype=emb_dtype)
    jax_c, port_c = JaxCorpus("chunks", **kw), CorpusIndex("chunks", device=CPU, **kw)
    for corpus, cls in ((jax_c, JaxDocRow), (port_c, DocRow)):
        corpus.insert(_rows(1, 60, cls, dim=16, lex_dim=64, slots=4))
        assert corpus.start_migration(128)
        _wait_ready(corpus)
        _mutate(corpus, cls)
        corpus.insert(_rows(600, 40, cls, dim=16, lex_dim=64, slots=4))  # the swap
        assert corpus.capacity == 128 and corpus._migration is None
    j, p = jax_c.state_arrays(), port_c.state_arrays()
    for key in j:
        if key == "emb" and emb_dtype == "bfloat16":
            np.testing.assert_array_equal(
                port_c.emb[: port_c.count].view(torch.int16).numpy(),
                np.asarray(j[key]).view(np.int16))
        else:
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    assert (port_c.count, port_c.tombstones, port_c.emb_rows) == \
        (jax_c.count, jax_c.tombstones, jax_c.emb_rows)
    # restore cancels a migration
    assert port_c.start_migration(256)
    port_c.load_state(j)
    assert port_c._migration is None


# -- writers beside the copy --------------------------------------------------------------
class NoReplay(GrowthMigration):
    """A migration whose journal is thrown away: the copy alone."""

    def journal_op(self, op, args, pos=None):
        pass


def _churn(replay: bool, monkeypatch, mesh=None):
    """Two corpora take the same writes from one writer thread; one grows
    through a migration whose copy is slowed so that writes land while it
    runs, the other synchronously. ``mesh`` shards both. -> (migrated,
    synchronous) state."""
    kw = dict(dim=16, lex_dim=64, tech_slots=4, capacity=256, device=CPU)
    mig_c = CorpusIndex("chunks", mesh=mesh, **kw)
    sync_c = CorpusIndex("chunks", mesh=mesh, **kw)
    if not replay:
        monkeypatch.setattr(port_index_mod, "GrowthMigration", NoReplay)
    first = _rows(1, 200, dim=16, lex_dim=64, slots=4)
    for c in (mig_c, sync_c):
        c.insert(first)
    real_alloc = mig_c._alloc_array

    def slow_alloc(attr, cap, fill_from=0, **kw):
        time.sleep(0.02)            # the writer gets in between the arrays
        return real_alloc(attr, cap, fill_from, **kw)

    monkeypatch.setattr(mig_c, "_alloc_array", slow_alloc)
    stop = threading.Event()
    errors = []

    def writer():
        rng = np.random.default_rng(9)
        step = 0
        try:
            while not stop.is_set():
                ids = [int(i) for i in rng.integers(1, 201, size=6)]
                vecs = rng.standard_normal((6, 16)).astype(np.float32)
                tech = rng.integers(1, 99, (6, 4)).astype(np.int32)
                lex = rng.integers(-3, 4, (6, 64)).astype(np.int8)
                for c in (mig_c, sync_c):
                    c.set_embeddings(ids, vecs)
                    c.set_tech(ids, tech)
                    c.set_lex(ids, lex)
                    if step % 40 == 0:
                        c.delete_ids(ids[:1])
                    if step % 50 == 0 and c.count + 8 <= 256:
                        c.insert(_rows(1000 + step, 1, dim=16, lex_dim=64, slots=4))
                step += 1
        except BaseException as exc:  # noqa: BLE001 - reported by the main thread
            errors.append(exc)

    thread = threading.Thread(target=writer)
    thread.start()
    try:
        time.sleep(0.01)
        assert mig_c.start_migration(512)
        _wait_ready(mig_c)
        time.sleep(0.05)           # the writer goes on after the copy
    finally:
        stop.set()
        thread.join(60)
    assert not errors, errors[0]
    # and writes that certainly land after the copy, before the swap, once
    # the writer has stopped: written beside it, the two corpora could take
    # one row's writes in two orders
    for c in (mig_c, sync_c):
        c.set_tech([1, 2, 3], np.full((3, 4), 77, np.int32))
        c.set_lex([4], np.full((1, 64), 5, np.int8))
        c.set_embeddings([5], np.full((1, 16), 0.25, np.float32))
        c.delete_ids([6])
    late = _rows(5000, 100, dim=16, lex_dim=64, slots=4)
    for c in (mig_c, sync_c):
        c.insert(late)             # past 256 rows: the swap, or the growth
    assert mig_c.capacity == sync_c.capacity == 512 and mig_c._migration is None
    return mig_c.state_arrays(), sync_c.state_arrays()


def test_writers_beside_a_migration_lose_nothing(port_store, monkeypatch):
    got, want = _churn(True, monkeypatch)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_a_migration_without_the_replay_loses_writes(port_store, monkeypatch):
    """The mutation check of the design: with the journal taken out, rows
    written after the copy read them are missing after the swap."""
    got, want = _churn(False, monkeypatch)
    assert any(not np.array_equal(got[key], want[key])
               for key in ("emb", "lex", "tech", "started"))


def _data2():
    from cadence_rag_tpu_torch.parallel.mesh import make_mesh

    return make_mesh("data:2", device="cpu")


def test_writers_beside_a_sharded_migration_lose_nothing(port_store, monkeypatch):
    """The writer beside a migration under data:2: a doubling moves rows
    [128, 256) of shard 0 to shard 1, and the journal replays each write by
    global row onto its new owner shard."""
    got, want = _churn(True, monkeypatch, mesh=_data2())
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_a_sharded_migration_without_the_replay_loses_writes(port_store, monkeypatch):
    got, want = _churn(False, monkeypatch, mesh=_data2())
    assert any(not np.array_equal(got[key], want[key])
               for key in ("emb", "lex", "tech", "started"))


def test_reset_index_ends_a_ready_migration(port_store):
    """A migration that stands ready holds its corpus and both buffer sets
    on its thread until a swap or a cancel: dropping the process-wide index
    cancels it, and the thread ends (a harness that builds one index after
    another would otherwise keep every one of them on the device)."""
    index = port_index_mod.get_index()
    corpus = index.chunks
    corpus.insert(_rows(1, 200, dim=corpus.dim, lex_dim=corpus.lex_dim,
                        slots=corpus.tech_slots))
    assert corpus.start_migration(2 * corpus.capacity)
    mig = corpus._migration
    assert mig.ready.wait(30)
    port_index_mod.reset_index()
    mig._thread.join(10)
    assert mig.cancelled and not mig._thread.is_alive()
    assert corpus._migration is None
