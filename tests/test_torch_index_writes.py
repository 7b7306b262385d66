"""The index's write side, JAX package vs port, on the CPU.

The same operations on the same seeded rows run through both packages'
``CorpusIndex`` (inserts, ``delete_ids`` with the store's signatures,
``set_tech``, ``set_embeddings``, ``set_lex``, ``replace_doc_freq``,
``maybe_compact``, inserts after the compaction): ``state_arrays()`` must
agree array by array (bf16 rows through their int16 view) with ``doc_freq``,
``dl_sum``, ``count``, ``capacity``, ``tombstones`` and ``emb_rows`` equal,
and a state carried either way with ``load_state`` must restore the same
index. Then the port's own guarantees: a dispatch made before a compaction
and collected after it maps its positions through the rows it was made on; a
deleted row is returned by no dense mode (exact, ann, ivf); and the engines
of both packages answer the same after ``delete_call`` and a compaction
(ids identical, debug lane scores within 1e-5, fused scores within 1e-6).
"""

import numpy as np
import pytest
import torch

from cadence_rag_tpu.core.index import CorpusIndex as JaxCorpus
from cadence_rag_tpu.core.index import DocRow as JaxDocRow
from cadence_rag_tpu.ingest import featurize
from cadence_rag_tpu_torch.core.index import CorpusIndex as PortCorpus
from cadence_rag_tpu_torch.core.index import DeviceIndexManager
from cadence_rag_tpu_torch.core.index import DocRow as PortDocRow
from cadence_rag_tpu_torch.evals.synth import insert_text_rows, plan_text_queries
from torch_parity import (
    BOTH,
    JAX,
    PORT,
    assert_same_merged,
    assert_same_response,
    ingest_corpus,
    port_store,  # noqa: F401  (fixture)
    request_bodies,
    set_both,  # noqa: F401  (fixture)
)

INT32_MIN = np.iinfo(np.int32).min
DIM, LEX_DIM, SLOTS = 64, 256, 16
WORDS = ["gateway", "latency", "rollback", "kafka", "consumer", "lag", "tiering",
         "cluster", "retry", "budget", "azure", "lenovo", "storage", "object",
         "upgrade", "partition", "rebalance", "certificate", "pipeline", "broker"]
TECH = [f"srv-{i}" for i in range(30)] + [f"v2.{i}.1" for i in range(12)]


@pytest.fixture()
def sized(port_store, set_both):
    """Both packages at the write tests' widths: 64-d embeddings, 256-wide
    signatures, initial capacity 64."""
    set_both("lexical_dim", LEX_DIM)
    set_both("embeddings_dim", DIM)
    set_both("index_initial_capacity", 64)


def _records(seed, n, first_id):
    """n seeded rows as plain dicts (the fields of a DocRow)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = list(rng.choice(TECH, size=int(rng.integers(0, 3)), replace=False))
        text = " ".join(list(rng.choice(WORDS, size=int(rng.integers(4, 10)))) + toks)
        sig, touched, dl = featurize.lexical_signature(text, 8.0)
        vec = rng.standard_normal(DIM).astype(np.float32)
        out.append(dict(
            doc_id=first_id + i, call_seq=int(rng.integers(0, 12)),
            started_sec=int(rng.integers(1_600_000_000, 1_700_000_000)),
            lex_sig=sig, lex_dl=dl, lex_touched=touched,
            tech=featurize.tech_slots(toks),
            embedding=None if rng.random() < 0.2 else vec / np.linalg.norm(vec)))
    return out


def _pair(emb_dtype):
    kw = dict(dim=DIM, lex_dim=LEX_DIM, tech_slots=SLOTS, capacity=64)
    return (JaxCorpus("chunks", emb_dtype=emb_dtype, **kw),
            PortCorpus("chunks", emb_dtype=emb_dtype, device=torch.device("cpu"), **kw))


def _both(pair, op, *args):
    """Run one operation on both corpora; their results must be equal."""
    jax_out, port_out = getattr(pair[0], op)(*args), getattr(pair[1], op)(*args)
    if isinstance(jax_out, np.ndarray):
        np.testing.assert_array_equal(port_out, jax_out)
    else:
        assert port_out == jax_out, op
    return port_out


def _insert(pair, records):
    pair[0].insert([JaxDocRow(**r) for r in records])
    pair[1].insert([PortDocRow(**r) for r in records])


def assert_same_state(jax_corpus, port_corpus):
    j, p = jax_corpus.state_arrays(), port_corpus.state_arrays()
    assert j.keys() == p.keys()
    n = port_corpus.count
    for key in j:
        if key == "emb" and j[key].dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                port_corpus.emb[:n].view(torch.int16).numpy(), j[key].view(np.int16))
            # what the port hands out (f32) rounds back to the same bf16 bits
            np.testing.assert_array_equal(
                torch.from_numpy(p[key]).to(torch.bfloat16).view(torch.int16).numpy(),
                j[key].view(np.int16))
        else:
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    for attr in ("count", "capacity", "tombstones", "emb_rows", "dl_sum", "live_count"):
        assert getattr(port_corpus, attr) == getattr(jax_corpus, attr), attr
    np.testing.assert_array_equal(port_corpus.doc_freq, jax_corpus.doc_freq)
    assert port_corpus.deleted_ids == jax_corpus.deleted_ids
    assert port_corpus._id_to_pos == jax_corpus._id_to_pos


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_state_arrays_agree_after_the_same_writes(sized, emb_dtype):
    pair = _pair(emb_dtype)
    first = _records(0, 300, 1)
    _insert(pair, first[:180])
    _insert(pair, first[180:])
    assert_same_state(*pair)
    by_id = {r["doc_id"]: r for r in first}

    def delete(ids, with_stats=True):
        known = [by_id.get(i) for i in ids]
        sigs = [r["lex_sig"] if r else None for r in known] if with_stats else None
        dls = [r["lex_dl"] if r else 0 for r in known] if with_stats else None
        return _both(pair, "delete_ids", ids, sigs, dls)

    rng = np.random.default_rng(1)
    # unknown ids and a repeated id count once
    assert delete([5, 17, 17, 9999, 60, 61]) == 4
    assert delete([5]) == 0
    assert _both(pair, "maybe_compact") is False
    assert_same_state(*pair)
    ids = [int(i) for i in rng.choice(np.arange(1, 301), size=40, replace=False)] + [777]
    tech = rng.integers(0, 2**31 - 1, size=(41, SLOTS)).astype(np.int32)
    _both(pair, "set_tech", ids, tech)
    vecs = rng.standard_normal((41, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    _both(pair, "set_embeddings", ids, vecs)
    lex = rng.integers(-5, 6, size=(41, LEX_DIM)).astype(np.int8)
    _both(pair, "set_lex", ids, lex)
    _both(pair, "set_lex_ids", ids[:7], lex[:7] + 1)
    assert_same_state(*pair)
    np.testing.assert_array_equal(_both(pair, "contains", [1, 5, 9999]),
                                  [True, False, False])

    # past a quarter of the rows (and 64): maybe_compact compacts
    assert delete(list(range(100, 190)), with_stats=False) > 60
    assert pair[1].tombstones >= 64
    assert _both(pair, "maybe_compact") is True
    assert pair[1].tombstones == 0 and pair[1].count == pair[1].live_count
    assert pair[1].count not in (0, pair[1].capacity)
    assert_same_state(*pair)
    # a deleted id never re-enters; new rows land after the compacted ones
    _insert(pair, [by_id[5], by_id[120]] + _records(2, 50, 1000))
    assert not pair[1].contains([5, 120]).any()
    _both(pair, "replace_doc_freq", rng.integers(0, 50, size=LEX_DIM))
    assert_same_state(*pair)
    # compact() with nothing to reclaim, then all but three rows deleted:
    # the capacity never drops under index_initial_capacity
    _both(pair, "compact")
    survivors = sorted(pair[1]._id_to_pos)[:3]
    delete([i for i in pair[1]._id_to_pos if i not in survivors])
    _both(pair, "compact")
    assert pair[1].capacity == 64 and pair[1].count == 3
    assert_same_state(*pair)


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_state_with_tombstones_carries_both_ways(sized, emb_dtype):
    """``load_state`` of a state that holds tombstones, JAX -> port and
    port -> JAX: the tombstoned rows stay invisible and the next compaction
    gives the same rows in both."""
    pair = _pair(emb_dtype)
    _insert(pair, _records(3, 200, 1))
    _both(pair, "delete_ids", list(range(20, 110)), None, None)
    carried = _pair(emb_dtype)
    carried[1].load_state(pair[0].state_arrays())      # JAX -> port
    carried[0].load_state(pair[1].state_arrays())      # port -> JAX
    for corpus in carried:
        assert corpus.tombstones == 90 and corpus.count == 200
        assert not corpus.contains([20, 109]).any() and corpus.contains([19, 110]).all()
    # deleted_ids is this process's memory, not part of the state
    for corpus in carried:
        corpus.deleted_ids = set(pair[0].deleted_ids)
    assert_same_state(*carried)
    assert _both(carried, "maybe_compact") is True
    _both(pair, "compact")
    assert_same_state(*carried)
    assert_same_state(carried[0], pair[1])


# -- the port's index under dispatches -------------------------------------------
KNOWN = ["incident {i}: kafka consumer lag on broker-{i} after the gateway upgrade "
         "to v3.{i}.7".format(i=i) for i in range(12)]
KNOWN_TOKENS = [[f"broker-{i}", f"v3.{i}.7"] for i in range(12)]
KNOWN_ID0 = 5000
KS = dict(chunk_ks=(10, 10, 10), artifact_ks=(5, 5, 5))


@pytest.fixture()
def served_index(sized):
    """A port index: 400 filler chunks and 60 artifacts, then 12 known
    chunk rows (ids 5000..5011), all embedded."""
    index = DeviceIndexManager("cpu")
    index.ensure_call_capacity(16)
    rng = np.random.default_rng(7)
    filler = [" ".join(rng.choice(WORDS, size=8)) for _ in range(400)]
    insert_text_rows(index.chunks, filler, [[] for _ in filler], doc_id0=1,
                     call_seq=1, started0=1_650_000_000)
    insert_text_rows(index.artifacts, filler[:60], [[] for _ in range(60)],
                     doc_id0=9000, call_seq=2, started0=1_650_000_000)
    insert_text_rows(index.chunks, KNOWN, KNOWN_TOKENS, doc_id0=KNOWN_ID0,
                     call_seq=3, started0=1_700_000_000)
    return index


def _dispatch(index, mode, fuse_rrf=False):
    allowed = np.ones((len(KNOWN), index.call_capacity), dtype=bool)
    args, _modes = plan_text_queries(index, KNOWN, KNOWN_TOKENS, allowed, scoped=False)
    return index.query_both_packed_async(
        *args, chunk_mode=mode, artifact_mode="exact", recall_target=0.95,
        fuse_rrf=fuse_rrf, **KS)


def _lane_ids(out):
    """{lane: per-query list of returned chunk ids}"""
    return {lane: [ids[b, :counts[b]].tolist() for b in range(ids.shape[0])]
            for lane, (ids, _scores, counts) in out[0].items()}


def test_dispatch_in_flight_across_a_compaction(served_index):
    """Dispatch, delete a third of the rows and compact, then collect: the
    answer is the one the rows at dispatch time give, by the ids of the old
    positions."""
    index = served_index
    want = index.collect_packed(_dispatch(index, "exact"))
    want_fused = index.collect_packed(_dispatch(index, "exact", fuse_rrf=True))
    disp = _dispatch(index, "exact")
    disp_fused = _dispatch(index, "exact", fuse_rrf=True)
    old_ids = index.chunks.h_ids
    index.chunks.delete_ids(list(range(1, 150)))
    index.chunks.compact()
    assert index.chunks.h_ids is not old_ids and index.chunks.count == 412 - 149
    got = index.collect_packed(disp)
    for corpus in (0, 1):
        for lane in want[corpus]:
            for g, w in zip(got[corpus][lane], want[corpus][lane]):
                np.testing.assert_array_equal(g, w)
    for g, w in zip(index.collect_packed(disp_fused)[0]["__rrf__"],
                    want_fused[0]["__rrf__"]):
        np.testing.assert_array_equal(g, w)
    # and a dispatch made now sees the compacted rows: no deleted id
    after = _lane_ids(index.collect_packed(_dispatch(index, "exact")))
    assert all(i >= 150 for ids in after.values() for row in ids for i in row)
    assert [row[0] for row in after["dense"]] == list(range(KNOWN_ID0, KNOWN_ID0 + 12))


@pytest.mark.parametrize("mode", ["exact", "ann", "ivf"])
def test_a_deleted_row_is_returned_in_no_mode(served_index, mode):
    """Each known row comes first in every lane until it is deleted; then no
    lane returns it, in this dense mode, tombstoned or compacted away. An
    IVF index built before the delete keeps the row in its bucket: the
    lane's mask must drop it."""
    index = served_index
    if mode == "ivf":
        index.chunks.build_ivf(n_clusters=8, nprobe=8)
    known = list(range(KNOWN_ID0, KNOWN_ID0 + 12))
    disp = _dispatch(index, mode)
    assert disp.served_chunk_mode == mode
    before = _lane_ids(index.collect_packed(disp))
    for lane in ("dense", "lex", "tech"):
        assert [row[0] for row in before[lane]] == known, lane
    gone = known[::2]
    assert index.chunks.delete_ids(gone) == 6
    assert index.chunks.tombstones == 6
    disp = _dispatch(index, mode)
    assert disp.served_chunk_mode == mode        # the IVF index survives a delete
    after = _lane_ids(index.collect_packed(disp))
    for lane, rows in after.items():
        assert not set(gone) & {i for row in rows for i in row}, lane
        assert [row[0] for row in rows[1::2]] == known[1::2], lane
    index.chunks.compact()
    assert index.chunks.ivf is None              # row positions moved
    disp = _dispatch(index, mode)
    assert disp.served_chunk_mode == ("ann" if mode == "ivf" else mode)
    final = _lane_ids(index.collect_packed(disp))
    for lane, rows in final.items():
        assert not set(gone) & {i for row in rows for i in row}, lane
        assert [row[0] for row in rows[1::2]] == known[1::2], lane


def test_readers_and_a_writer_share_the_index(served_index):
    """Three threads dispatch and collect and one plans a scoped request
    while another inserts, deletes, backfills and compacts, with the
    interpreter switching threads often.
    No thread may raise; every id returned was inserted at some time; each
    known row (never deleted) stays its query's only tech match; and no id
    whose delete had returned before a dispatch began is in that
    dispatch's answer, compactions in between or not."""
    import sys
    import threading
    import time

    index = served_index
    filler = list(range(1, 401))
    known = list(range(KNOWN_ID0, KNOWN_ID0 + 12))
    deleted_done, ever = set(), set(filler) | set(known)
    errors, answers = [], []
    stop = threading.Event()
    deadline = time.monotonic() + 3.0

    def reader():
        try:
            while time.monotonic() < deadline and not stop.is_set():
                gone = set(deleted_done)
                disp = _dispatch(index, "exact")
                time.sleep(0.002)          # leave the writer room before the collect
                lanes = _lane_ids(index.collect_packed(disp))
                ids = {i for rows in lanes.values() for row in rows for i in row}
                answers.append(len(ids))
                # each known row alone holds its tokens: a position mapped
                # through rows renumbered since the dispatch would miss it
                if [row[:1] for row in lanes["tech"]] != [[i] for i in known]:
                    raise AssertionError(f"tech lane: {lanes['tech']}")
                if ids & gone:
                    raise AssertionError(f"deleted ids served: {sorted(ids & gone)[:5]}")
                if not ids <= ever:
                    raise AssertionError(f"unknown ids served: {sorted(ids - ever)[:5]}")
        except BaseException as exc:
            errors.append(exc)
            stop.set()

    def planner():
        try:
            allowed = np.ones(index.call_capacity, dtype=bool)
            allowed[4] = False             # the writer's call: only the seed rows count
            while time.monotonic() < deadline and not stop.is_set():
                est = index.chunks.estimate_candidates(
                    allowed, 1_650_000_000, 1_700_000_100)
                if not len(known) <= est <= len(filler) + len(known):
                    raise AssertionError(f"scoped estimate: {est}")
        except BaseException as exc:
            errors.append(exc)
            stop.set()

    def writer():
        try:
            rng = np.random.default_rng(3)
            next_id = 20_000
            while time.monotonic() < deadline and not stop.is_set():
                texts = [" ".join(rng.choice(WORDS, size=6)) for _ in range(16)]
                ever.update(range(next_id, next_id + 16))
                insert_text_rows(index.chunks, texts, [[] for _ in texts],
                                 doc_id0=next_id, call_seq=4, started0=1_660_000_000)
                next_id += 16
                live = [i for i in index.chunks._id_to_pos if i < KNOWN_ID0 or i >= 20_000]
                # fewer than were inserted: the corpus grows, so idf (df
                # mass is not shed without the store's signatures) stays sane
                victims = [int(i) for i in rng.choice(live, size=12, replace=False)]
                index.chunks.delete_ids(victims)
                deleted_done.update(victims)
                index.chunks.set_embeddings(
                    live[:4], np.eye(DIM, dtype=np.float32)[:4])
                if rng.random() < 0.5:
                    index.chunks.compact()
                else:
                    index.chunks.maybe_compact()
        except BaseException as exc:
            errors.append(exc)
            stop.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader) for _ in range(3)]
    threads.append(threading.Thread(target=planner))
    threads.append(threading.Thread(target=writer))
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        stop.set()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(answers) >= 3 and deleted_done
    # the known rows were never deleted: still first, and the counters add up
    after = _lane_ids(index.collect_packed(_dispatch(index, "exact")))
    for lane in ("lex", "tech", "dense"):
        assert [row[0] for row in after[lane]] == list(range(KNOWN_ID0, KNOWN_ID0 + 12))
    chunks = index.chunks
    assert chunks.live_count == len(chunks._id_to_pos) == len(ever - deleted_done)
    assert chunks.tombstones == int(
        (chunks.h_started[: chunks.count] == INT32_MIN).sum())


# -- the engines after a delete and a compaction ---------------------------------
NAMES = [n for n in request_bodies({"ext-B": "x"}) if n not in ("call_ids", "ids_only_scoped")]


@pytest.mark.parametrize("compacted", [False, True])
def test_engines_agree_after_delete_and_compaction(port_store, compacted):
    """``delete_call`` of one call in both packages (then a compaction of
    both corpora): every request shape gets the same response, ids and
    evidence identical, debug lane scores within 1e-5; the fused lists
    agree within 1e-6."""
    calls = {pkg.root: ingest_corpus(pkg) for pkg in BOTH}
    plans = {}
    for pkg in BOTH:
        out = pkg.ingest.delete_call(calls[pkg.root]["ext-B"])
        assert out["chunks_deleted"] >= 1 and out["compacted"] is False
        index = pkg.index.get_index()
        assert index.chunks.tombstones == out["chunks_deleted"]
        if compacted:
            index.chunks.compact()
            index.artifacts.compact()
            assert index.chunks.tombstones == 0
    assert_same_state_of_indexes()
    bodies = {pkg.root: request_bodies(calls[pkg.root]) for pkg in BOTH}
    for name in NAMES:
        got, want = (pkg.retrieve.retrieve_evidence(pkg.request(bodies[pkg.root][name]))
                     for pkg in (PORT, JAX))
        assert_same_response(got, want)
    for pkg in BOTH:
        ps = pkg.retrieve._prepare_plans(
            [pkg.request(bodies[pkg.root][n]) for n in NAMES])
        pkg.retrieve._collect_plans(pkg.retrieve._dispatch_plans(ps))
        plans[pkg.root] = ps
    for p, j in zip(plans[PORT.root], plans[JAX.root]):
        if not j.empty:
            assert_same_merged(p, j)
    # nothing of the deleted call is served
    resp = PORT.retrieve.retrieve_evidence(
        PORT.request({"query": "quarterly pipeline review supermicro pricing"}))
    gone = calls[PORT.root]["ext-B"]
    assert all(q["call_id"] != gone for q in resp["quotes"])


def assert_same_state_of_indexes():
    for name in ("chunks", "artifact_chunks"):
        assert_same_state(JAX.index.get_index().corpus(name),
                          PORT.index.get_index().corpus(name))


def test_planner_reads_across_a_compaction_that_halves_the_capacity(
        served_index, monkeypatch):
    """A scoped plan (``estimate_candidates`` with a call filter and a date
    range) runs beside a writer whose every round grows the corpus past its
    capacity, deletes the new rows and compacts back to half: the planner
    never sees the count of one side with mirrors of the other. The
    compaction is slowed between its mirror swaps, so a reader that does
    not wait for it lands there."""
    import threading
    import time

    zeros = np.zeros
    compacting = threading.Event()

    def slow_zeros(*args, **kwargs):       # compact() allocates each new mirror
        if compacting.is_set():
            time.sleep(0.002)
        return zeros(*args, **kwargs)

    monkeypatch.setattr(np, "zeros", slow_zeros)
    chunks = served_index.chunks
    allowed = np.ones(served_index.call_capacity, dtype=bool)
    allowed[4] = False                     # the writer's call
    seed_rows = chunks.count
    errors, estimates, capacities = [], [], set()
    stop = threading.Event()

    def planner():
        try:
            while not stop.is_set():
                estimates.append(chunks.estimate_candidates(
                    allowed, 1_650_000_000, 1_700_000_100))
        except BaseException as exc:
            errors.append(exc)
            stop.set()

    def writer():
        try:
            rng = np.random.default_rng(5)
            for next_id in range(30_000, 30_000 + 6 * 150, 150):
                if stop.is_set():
                    break
                texts = [" ".join(rng.choice(WORDS, size=6)) for _ in range(150)]
                insert_text_rows(chunks, texts, [[] for _ in texts], doc_id0=next_id,
                                 call_seq=4, started0=1_660_000_000)
                capacities.add(chunks.capacity)
                chunks.delete_ids(list(range(next_id, next_id + 150)))
                compacting.set()
                assert chunks.maybe_compact()
                compacting.clear()
                capacities.add(chunks.capacity)
        except BaseException as exc:
            errors.append(exc)
        finally:
            stop.set()

    threads = [threading.Thread(target=planner), threading.Thread(target=planner),
               threading.Thread(target=writer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert capacities == {512, 1024}
    # the writer's rows are out of scope, so every plan counts the seed rows
    assert estimates and set(estimates) == {seed_rows}
