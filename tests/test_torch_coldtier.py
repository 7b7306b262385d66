"""The host cold tier, JAX package vs port, on the CPU.

``tests/integration/test_cold_tier.py`` runs against the port as it stands
(``torch_parity.mirror_tests``) but for two tests that are rewritten below
under the port's API (the mesh refusal, which must raise where the index is
made, and the synthetic installer, which reads a bf16 row through numpy and
calls the blocking ``query_both_packed``). Then:

- both packages, capped alike, take the same seeded rows in the same
  batches: the same rows land hot and cold (the intake shrink at the cap),
  hot ``state_arrays`` and the cold arrays bit-equal, the planner's
  estimates and the hot-only checkpoint's lexical stats equal, and after the
  same deletes, backfills and compactions again;
- the engines of both answer the same under a cap (ids and packs
  identical; lane scores within 1e-3 relative of the JAX package's, whose
  cold blocks take an f32 query where its hot program takes f16 values, and
  within 1e-5 of the port's own uncapped answers);
- the port's capped index answers with the uncapped index's ids, in
  ``exact`` and in ``ann``, when the cap and the block size are multiples of
  1024 (lane scores within 1e-5; two ids may trade places only where their
  scores agree within that), tail block ragged;
- a dispatch made before cold-tier writes and collected after them answers
  from the rows it was made on, and readers beside a writer that grows,
  rewrites, tombstones and compacts the cold tier always find the rows the
  writer leaves alone.
"""

import threading

import numpy as np
import pytest
import torch

from cadence_rag_tpu.core.index import DeviceIndexManager as JaxManager
from cadence_rag_tpu.core.index import DocRow as JaxDocRow
from cadence_rag_tpu.ingest import featurize
from cadence_rag_tpu_torch.core.coldtier import ColdTier, merge_rect_lanes
from cadence_rag_tpu_torch.core.index import DeviceIndexManager, DocRow
from cadence_rag_tpu_torch.evals.synth import (
    install_capped_copy,
    install_synthetic_cold,
    install_synthetic_corpus,
    insert_text_rows,
    plan_text_queries,
)
from torch_parity import (
    BOTH,
    JAX,
    ON_CPU,
    PORT,
    assert_same_response,
    ingest_corpus,
    mirror_tests,
    normalize,
    port_store,  # noqa: F401  (fixture)
    request_bodies,
    set_both,  # noqa: F401  (fixture)
)

SCORE_ATOL = 1e-5
DIM, LEX_DIM, SLOTS = 64, 256, 16
INT32_MIN = np.iinfo(np.int32).min


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_tests(globals(), "cold_tier", "integration/test_cold_tier.py", drop={
    "TestColdTierOracle": ["test_mesh_combination_refused"],
    "TestSyntheticColdInstaller": ["test_bulk_cold_rows_are_retrievable"],
}, rewrites=ON_CPU)


def test_mesh_combination_refused(port_store, monkeypatch):
    monkeypatch.setattr(port_store, "index_max_device_rows", 4)
    monkeypatch.setattr(port_store, "mesh_shape", "data:8")
    PORT.index.reset_index()
    with pytest.raises(RuntimeError, match="mutually exclusive"):
        PORT.index.get_index("cpu")


def _collect(index, args, modes, ks=((5, 5, 5), (2, 2, 5))):
    return index.collect_packed(index.query_both_packed_async(
        *args, chunk_ks=ks[0], artifact_ks=ks[1], chunk_mode=modes[0],
        artifact_mode=modes[1], recall_target=0.95))


def test_bulk_cold_rows_are_retrievable(port_store, monkeypatch):
    """``evals/synth.install_synthetic_cold`` wires ids and counters like
    the DocRow path: a dense probe equal to a cold row's embedding retrieves
    that doc id first through the full dispatch; ``/index/stats`` shows the
    tier."""
    monkeypatch.setattr(port_store, "index_max_device_rows", 64)
    monkeypatch.setattr(port_store, "cold_block_rows", 128)
    PORT.index.reset_index()
    index = PORT.index.get_index("cpu")
    index.ensure_call_capacity(16)
    install_synthetic_corpus(index.chunks, 64, 16, seed=0)
    install_synthetic_corpus(index.artifacts, 16, 16, seed=1)
    install_synthetic_cold(index.chunks, 300, 16, seed=2)
    tier = index.chunks.cold
    assert tier.count == 300 and tier.emb_rows == 300
    assert index.chunks.live_count == 364
    pick = 137
    emb = tier.emb[pick].float().numpy()
    feats = [(np.zeros(0, np.int64), np.zeros(0, np.float32), np.zeros(0, np.float32))]
    args = (emb[None], feats, np.zeros((1, SLOTS * 4), np.int32),
            np.ones((1, index.call_capacity), bool),
            np.full(1, -2147483647, np.int32), np.full(1, 2**31 - 1, np.int32))
    for mode in ("exact", "ann"):
        chunks_out, _ = _collect(index, args, (mode, mode))
        ids, _scores, counts = chunks_out["dense"]
        assert counts[0] >= 1 and int(ids[0][0]) == int(tier.ids[pick])
    stats = PORT.api.index_stats_endpoint(None)[1]["chunks"]["cold_tier"]
    assert stats == {"count": 300, "live": 300, "embedded": 300, "tombstones": 0,
                     "max_device_rows": 64}


# -- both packages, capped alike, on the same rows -----------------------------------
WORDS = ["gateway", "latency", "rollback", "kafka", "consumer", "lag", "tiering",
         "cluster", "retry", "budget", "azure", "lenovo", "storage", "object"]


def _records(seed, n, first_id):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        text = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 10))))
        sig, touched, dl = featurize.lexical_signature(text, 8.0)
        vec = rng.standard_normal(DIM).astype(np.float32)
        out.append(dict(
            doc_id=first_id + i, call_seq=int(rng.integers(0, 12)),
            started_sec=int(rng.integers(1_600_000_000, 1_700_000_000)),
            lex_sig=sig, lex_dl=dl, lex_touched=touched,
            tech=rng.integers(1, 500, size=SLOTS).astype(np.int32),
            embedding=None if rng.random() < 0.2 else vec / np.linalg.norm(vec)))
    return out


def _bits(t):
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    t = np.asarray(t)
    return t.view(np.int16) if t.dtype.itemsize == 2 and t.dtype.kind != "i" else t


def assert_same_tiers(jax_corpus, port_corpus):
    j, p = jax_corpus.state_arrays(), port_corpus.state_arrays()
    for key in j:
        if key == "emb":
            np.testing.assert_array_equal(
                _bits(port_corpus.emb[: port_corpus.count]), _bits(j[key]))
        else:
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    for attr in ("count", "capacity", "tombstones", "emb_rows", "dl_sum",
                 "live_count", "max_device_rows"):
        assert getattr(port_corpus, attr) == getattr(jax_corpus, attr), attr
    np.testing.assert_array_equal(port_corpus.doc_freq, jax_corpus.doc_freq)
    jc, pc = jax_corpus.cold, port_corpus.cold
    assert (jc is None) == (pc is None)
    if jc is None:
        return
    n = jc.count
    for attr in ("count", "capacity", "tombstones", "emb_rows", "dl_sum", "live_count"):
        assert getattr(pc, attr) == getattr(jc, attr), attr
    for attr in ("emb", "lex", "tech", "call_idx", "started", "has_emb"):
        np.testing.assert_array_equal(
            _bits(getattr(pc, attr)[:n]), _bits(getattr(jc, attr)[:n]), attr)
    np.testing.assert_array_equal(pc.ids[:n], jc.ids[:n])
    np.testing.assert_array_equal(pc.df, jc.df)
    assert pc._id_to_pos == jc._id_to_pos
    assert isinstance(pc, ColdTier) and pc.emb.dtype == port_corpus.emb_dtype


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_capped_indexes_agree_after_the_same_writes(port_store, set_both, emb_dtype):
    set_both("lexical_dim", LEX_DIM)
    set_both("embeddings_dim", DIM)
    set_both("index_initial_capacity", 64)
    set_both("index_embedding_dtype", emb_dtype)
    set_both("index_max_device_rows", 128)
    set_both("cold_block_rows", 64)
    jax_index, port_index = JaxManager(), DeviceIndexManager("cpu")
    pair = (jax_index.chunks, port_index.chunks)
    records = _records(0, 400, 1)
    by_id = {r["doc_id"]: r for r in records}
    # batches that straddle the cap: the padded slab must not grow the
    # device arrays past it, so the intake shrinks and the rest goes cold
    for lo, hi in ((0, 100), (100, 121), (121, 131), (131, 260), (260, 400)):
        pair[0].insert([JaxDocRow(**r) for r in records[lo:hi]])
        pair[1].insert([DocRow(**r) for r in records[lo:hi]])
        assert_same_tiers(*pair)
    assert pair[1].capacity == 128 and 100 < pair[1].count <= 128
    assert pair[1].cold.count == 400 - pair[1].count
    cold_ids = [int(i) for i in pair[1].cold.ids[: pair[1].cold.count]]
    hot_ids = [int(i) for i in pair[1].h_ids[: pair[1].count]]

    def both(op, *args):
        out = [getattr(c, op)(*args) for c in pair]
        if isinstance(out[0], np.ndarray):
            np.testing.assert_array_equal(out[1], out[0])
        else:
            assert out[1] == out[0], op
        return out[1]

    np.testing.assert_array_equal(
        both("contains", [hot_ids[0], cold_ids[0], 9999]), [True, True, False])
    rng = np.random.default_rng(1)
    ids = cold_ids[5:25] + hot_ids[5:15] + [7777]
    vecs = rng.standard_normal((len(ids), DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    assert both("set_embeddings", ids, vecs) == 30
    assert both("set_tech", ids, rng.integers(1, 99, (len(ids), SLOTS)).astype(np.int32)) == 30
    lex = rng.integers(-5, 6, size=(len(ids), LEX_DIM)).astype(np.int8)
    assert both("set_lex_ids", ids, lex).sum() == 30
    assert_same_tiers(*pair)
    # deletes with the store's signatures, a repeated cold id counted once
    gone = cold_ids[30:140] + [cold_ids[30]] + hot_ids[20:30] + [8888]
    sigs = [by_id[i]["lex_sig"] if i in by_id else None for i in gone]
    dls = [by_id[i]["lex_dl"] if i in by_id else 0 for i in gone]
    assert both("delete_ids", gone, sigs, dls) == 120
    assert_same_tiers(*pair)
    allowed = np.zeros(256, bool)
    allowed[:6] = True
    for args in ((None, INT32_MIN + 1, 2**31 - 1, True, True),
                 (None, INT32_MIN + 1, 2**31 - 1, False, True),
                 (allowed, 1_620_000_000, 1_690_000_000, True, False),
                 (allowed, 1_620_000_000, 1_690_000_000, False, False)):
        assert both("estimate_candidates", *args) > 0
    # the cold tier passes its threshold (110 of 272 rows): compacted there
    assert pair[1].cold.tombstones == 110
    assert both("maybe_compact") is True
    assert pair[1].cold.tombstones == 0 and pair[1].tombstones == 10
    assert_same_tiers(*pair)
    pair[0].insert([JaxDocRow(**r) for r in _records(2, 40, 1000)])
    pair[1].insert([DocRow(**r) for r in _records(2, 40, 1000)])
    assert_same_tiers(*pair)
    # the hot-only checkpoint: the cold tier's share of the stats taken out
    j, p = pair[0].state_arrays(), pair[1].state_arrays()
    np.testing.assert_array_equal(p["doc_freq"], j["doc_freq"])
    assert int(p["dl_sum"][0]) == int(j["dl_sum"][0]) < pair[1].dl_sum
    snap = pair[1].checkpoint_arrays()
    np.testing.assert_array_equal(snap["doc_freq"], j["doc_freq"])
    # a restored state drops the cold tier in both
    carried = (JaxManager().chunks, DeviceIndexManager("cpu").chunks)
    carried[0].load_state(p)
    carried[1].load_state(j)
    assert_same_tiers(*carried)
    assert carried[1].cold is None and carried[1].count == pair[1].count


COLD_SCORE_RTOL = 1e-3


def assert_same_but_cold_scores(port_resp, jax_resp):
    """The port's response is the JAX package's; debug lane scores within
    COLD_SCORE_RTOL (relative): the JAX package scores a cold block with the
    f32 query where its hot program unpacks f16 values, while the port gives
    the cold blocks the hot program's own unpacked queries, so its cold
    scores are its uncapped index's."""
    p, p_lanes = normalize(port_resp, PORT.call_ext())
    j, j_lanes = normalize(jax_resp, JAX.call_ext())
    assert p == j
    assert (p_lanes is None) == (j_lanes is None)
    for corpus in j_lanes or ():
        assert p_lanes[corpus].keys() == j_lanes[corpus].keys()
        for lane, rows in j_lanes[corpus].items():
            mine = p_lanes[corpus][lane]
            assert [{k: v for k, v in r.items() if k != "score"} for r in mine] == \
                [{k: v for k, v in r.items() if k != "score"} for r in rows], lane
            for g, w in zip(mine, rows):
                if w["score"] is not None:
                    assert abs(g["score"] - w["score"]) <= COLD_SCORE_RTOL * max(
                        1.0, abs(w["score"])), (corpus, lane)


def test_engines_agree_under_a_cap(port_store, set_both):
    """The parity corpus rebuilt under a cap of 4 device rows in both
    packages: every request shape answers as the JAX package does (ids and
    packs identical, lane scores within COLD_SCORE_RTOL) and exactly as the
    port's own uncapped index did (lane scores within 1e-5)."""
    calls = {pkg.root: ingest_corpus(pkg) for pkg in BOTH}
    for pkg in BOTH:       # the uncapped index, rebuilt from the same store
        pkg.index.reset_index()
    PORT.index.get_index("cpu")
    for pkg in BOTH:
        pkg.ingest.rebuild_index_from_store()
    uncapped = {name: PORT.retrieve.retrieve_evidence(PORT.request(body))
                for name, body in request_bodies(calls[PORT.root]).items()}
    set_both("index_max_device_rows", 4)
    set_both("cold_block_rows", 8)
    for pkg in BOTH:
        pkg.index.reset_index()
    PORT.index.get_index("cpu")
    for pkg in BOTH:
        pkg.ingest.rebuild_index_from_store()
    index = PORT.index.get_index()
    assert index.chunks.count == 4 and index.chunks.cold.count > 4
    for name, body in request_bodies(calls[JAX.root]).items():
        port_body = request_bodies(calls[PORT.root])[name]
        got = PORT.retrieve.retrieve_evidence(PORT.request(port_body))
        assert_same_but_cold_scores(
            got, JAX.retrieve.retrieve_evidence(JAX.request(body)))
        assert_same_response(got, uncapped[name], want_pkg=PORT)
    # a delete and a backfill that land in the cold tier, in both
    for pkg in BOTH:
        pkg.ingest.delete_call(calls[pkg.root]["ext-D"])
    body = {"query": "kafka consumer lag rebalance", "debug": True}
    got = PORT.retrieve.retrieve_evidence(PORT.request(body))
    assert_same_but_cold_scores(got, JAX.retrieve.retrieve_evidence(JAX.request(body)))
    assert index.chunks.cold.tombstones >= 1


# -- the port: capped against uncapped, at kernel K1's block alignment ----------------
KNOWN = ["incident {i}: kafka consumer lag on broker-{i} after the gateway upgrade "
         "to v3.{i}.7".format(i=i) for i in range(8)]
KNOWN_TOKENS = [[f"broker-{i}", f"v3.{i}.7"] for i in range(8)]


def _sized(set_both, **extra):
    for name, value in dict(lexical_dim=LEX_DIM, embeddings_dim=DIM,
                            index_initial_capacity=64, **extra).items():
        set_both(name, value)


def _uncapped(n_chunks, n_artifacts):
    index = DeviceIndexManager("cpu")
    index.ensure_call_capacity(16)
    install_synthetic_corpus(index.chunks, n_chunks, 16, seed=0)
    install_synthetic_corpus(index.artifacts, n_artifacts, 16, seed=1)
    insert_text_rows(index.chunks, KNOWN, KNOWN_TOKENS, doc_id0=10**6,
                     call_seq=3, started0=1_700_000_000)
    insert_text_rows(index.artifacts, KNOWN[:4], KNOWN_TOKENS[:4], doc_id0=2 * 10**6,
                     call_seq=3, started0=1_700_000_000)
    return index


def _capped_copy(src, monkeypatch, cap_rows, block_rows):
    monkeypatch.setattr(PORT.settings, "index_max_device_rows", cap_rows)
    monkeypatch.setattr(PORT.settings, "cold_block_rows", block_rows)
    dst = DeviceIndexManager("cpu")
    dst.ensure_call_capacity(16)
    install_capped_copy(src.chunks, dst.chunks)
    monkeypatch.setattr(PORT.settings, "index_max_device_rows", 0)
    for new, old in ((dst.artifacts, src.artifacts),):
        new.load_state(old.state_arrays())
    return dst


def _same_lanes(got, want):
    """Counts equal, scores within SCORE_ATOL, ids equal position by
    position; where two ids trade places their scores must agree within
    SCORE_ATOL (the CPU's f32 matmul sums a block of another shape in
    another order, so a near-tie may resolve the other way; the card's
    kernel sums each row on its own)."""
    for g_corpus, w_corpus in zip(got, want):
        assert g_corpus.keys() == w_corpus.keys()
        for lane, (ids, scores, counts) in w_corpus.items():
            g_ids, g_scores, g_counts = g_corpus[lane]
            np.testing.assert_array_equal(g_counts, counts, lane)
            for b, m in enumerate(counts):
                np.testing.assert_allclose(g_scores[b, :m], scores[b, :m], rtol=0,
                                           atol=SCORE_ATOL, err_msg=lane)
                for pos in np.flatnonzero(g_ids[b, :m] != ids[b, :m]):
                    there = np.flatnonzero(g_ids[b, :m] == ids[b, pos])
                    other = (scores[b, there[0]] if there.size else scores[b, m - 1])
                    assert abs(other - scores[b, pos]) <= SCORE_ATOL, (lane, b, pos)


@pytest.mark.parametrize("modes", [("exact", "exact"), ("ann", "ann")])
def test_capped_equals_uncapped(port_store, set_both, monkeypatch, modes):
    """Cap 2048 and blocks of 1024 rows, 5,008 chunks (two full cold blocks
    and a ragged tail of 912): every lane of the capped index carries the
    uncapped index's ids, the approximate lanes included, since every cold
    row keeps its 1024-row block and its strided group; every known row
    first, those in the cold tier too."""
    _sized(set_both)
    full = _uncapped(5000, 300)
    capped = _capped_copy(full, monkeypatch, 2048, 1024)
    assert capped.chunks.count == 2048 and capped.chunks.cold.count == 2960
    assert capped.chunks.live_count == full.chunks.live_count == 5008
    allowed = np.ones((8, 256), bool)
    args, _planned = plan_text_queries(full, KNOWN, KNOWN_TOKENS, allowed, scoped=False)
    ks = ((50, 50, 50), (10, 10, 50))
    want = _collect(full, args, modes, ks)
    got = _collect(capped, args, modes, ks)
    _same_lanes(got, want)
    for lane in ("dense", "lex", "tech"):
        assert [int(r[0]) for r in got[0][lane][0]] == [10**6 + i for i in range(8)]
    assert all(capped.chunks.cold.contains(10**6 + i) for i in range(8))
    # a scoped batch (one call allowed) as well
    scoped = np.zeros((8, 256), bool)
    scoped[:, 3] = True
    args, _ = plan_text_queries(full, KNOWN, KNOWN_TOKENS, scoped, scoped=True)
    _same_lanes(_collect(capped, args, modes, ks), _collect(full, args, modes, ks))
    # device RRF stands down while the cold tier holds rows
    disp = capped.query_both_packed_async(
        *args, chunk_ks=ks[0], artifact_ks=ks[1], chunk_mode=modes[0],
        artifact_mode=modes[1], recall_target=0.95, fuse_rrf=True)
    assert disp.sig.fuse_rrf is False and len(disp.cold_chunks) == 3
    assert [blk.rows for blk in disp.cold_chunks] == [1024, 1024, 912]


def test_merge_rect_lanes_matches(port_store):
    """``merge_rect_lanes`` against the JAX package's on seeded blocks with
    ties and short rows."""
    from cadence_rag_tpu.core.coldtier import merge_rect_lanes as jax_merge

    rng = np.random.default_rng(4)

    def block(width):
        scores = -np.sort(-rng.choice([0.5, 1.0, 2.0, 3.5], size=(6, width)), axis=1)
        counts = rng.integers(0, width + 1, size=6).astype(np.int32)
        return (rng.integers(1, 10**6, size=(6, width)), scores.astype(np.float32), counts)

    base = {"lex": block(5), "tech": block(3)}
    extras = [{"lex": block(5), "tech": block(3)}, {"lex": block(2), "tech": block(3)}]
    ks = {"lex": 5, "tech": 4, "dense": 9}
    got, want = merge_rect_lanes(base, extras, ks), jax_merge(base, extras, ks)
    assert got.keys() == want.keys()
    for lane in want:
        for g, w in zip(got[lane], want[lane]):
            np.testing.assert_array_equal(g, w)
    assert merge_rect_lanes(base, [], ks) is base


def test_the_cold_tier_regrows_off_the_corpus_lock(port_store, set_both, monkeypatch):
    """An insert that makes the cold tier outgrow its arrays allocates the
    larger ones before it takes the corpus lock (on the card that is pinned
    memory, slow to get, and every dispatch waits for that lock)."""
    _sized(set_both, index_max_device_rows=64, cold_block_rows=64)
    index = DeviceIndexManager("cpu")
    index.chunks.insert([DocRow(**r) for r in _records(0, 600, 1)])
    tier = index.chunks.cold
    assert tier.count == 536 and tier.capacity == 1024
    free_during_alloc = []
    real = ColdTier._new_arrays

    def watched(self, cap):
        def probe():
            got = index.chunks.lock.acquire(timeout=5)
            free_during_alloc.append(got)
            if got:
                index.chunks.lock.release()

        other = threading.Thread(target=probe)
        other.start()
        other.join()
        return real(self, cap)

    monkeypatch.setattr(ColdTier, "_new_arrays", watched)
    index.chunks.insert([DocRow(**r) for r in _records(1, 600, 1000)])
    assert free_during_alloc == [True]
    assert tier.capacity == 2048 and tier.count == 1136
    index.chunks.insert([DocRow(**r) for r in _records(2, 100, 2000)])   # has room
    assert free_during_alloc == [True] and tier.count == 1236
    assert index.chunks.contains([1, 1000, 1599, 2099]).all()


# -- dispatches beside cold-tier writers ------------------------------------------------
def test_a_dispatch_in_flight_across_cold_writes(port_store, set_both, monkeypatch):
    """A dispatch made before the cold tier is rewritten, tombstoned,
    compacted and regrown, collected after: it answers from the rows it was
    made on (its blocks carry their own id snapshot)."""
    _sized(set_both)
    capped = _capped_copy(_uncapped(3000, 100), monkeypatch, 1024, 1024)
    tier = capped.chunks.cold
    allowed = np.ones((8, 256), bool)
    args, _ = plan_text_queries(capped, KNOWN, KNOWN_TOKENS, allowed, scoped=False)
    before = _collect(capped, args, ("ann", "ann"))
    disp = capped.query_both_packed_async(
        *args, chunk_ks=(5, 5, 5), artifact_ks=(2, 2, 5), chunk_mode="ann",
        artifact_mode="ann", recall_target=0.95)
    cold_ids = [int(i) for i in tier.ids[: tier.count]]
    capped.chunks.set_tech(cold_ids[:50], np.full((50, SLOTS), 9, np.int32))
    capped.chunks.delete_ids(cold_ids[:900] + [10**6, 10**6 + 1])
    assert capped.chunks.maybe_compact() is True       # rows move to the front
    monkeypatch.setattr(capped.chunks, "max_device_rows", 1024)
    capped.chunks.insert([DocRow(**r) for r in _records(5, 2500, 5 * 10**6)])
    assert tier.capacity >= 4096                        # the arrays were regrown
    _same_lanes(capped.collect_packed(disp), before)
    after = _collect(capped, args, ("ann", "ann"))
    firsts = [int(r[0]) for r in after[0]["tech"][0]]
    assert firsts[2:] == [10**6 + i for i in range(2, 8)]
    assert 10**6 not in firsts and 10**6 + 1 not in firsts


def test_readers_beside_a_cold_tier_writer(port_store, set_both, monkeypatch):
    """Three dispatching threads beside a writer that appends (growing the
    arrays), rewrites, tombstones and compacts cold rows: every answer
    carries each untouched known row first, and no deleted id."""
    _sized(set_both)
    capped = _capped_copy(_uncapped(1500, 100), monkeypatch, 1024, 1024)
    monkeypatch.setattr(capped.chunks, "max_device_rows", 1024)
    allowed = np.ones((8, 256), bool)
    args, _ = plan_text_queries(capped, KNOWN, KNOWN_TOKENS, allowed, scoped=False)
    stop, errors, rounds = threading.Event(), [], [0, 0, 0]
    deleted = set()
    lock = threading.Lock()

    def reader(slot):
        try:
            while not stop.is_set():
                with lock:
                    gone = set(deleted)
                chunks, _arts = _collect(capped, args, ("ann", "ann"))
                for lane in ("dense", "lex", "tech"):
                    ids, _scores, counts = chunks[lane]
                    assert [int(r[0]) for r in ids] == [10**6 + i for i in range(8)], lane
                    seen = {int(i) for b, m in enumerate(counts) for i in ids[b, :m]}
                    assert not (seen & gone), lane
                rounds[slot] += 1
        except BaseException as exc:  # noqa: BLE001 - reported by the main thread
            errors.append(exc)
            stop.set()

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    rng = np.random.default_rng(6)
    next_id = 7 * 10**6
    try:
        for step in range(12):
            rows = _records(100 + step, 300, next_id)
            capped.chunks.insert([DocRow(**r) for r in rows])
            ids = [r["doc_id"] for r in rows]
            next_id += 300
            capped.chunks.set_tech(ids[:40], rng.integers(1, 99, (40, SLOTS)).astype(np.int32))
            capped.chunks.set_lex_ids(ids[40:60], rng.integers(-3, 4, (20, LEX_DIM)).astype(np.int8))
            with lock:
                deleted.update(ids[:250])
            capped.chunks.delete_ids(ids[:250])
            capped.chunks.maybe_compact()
            if stop.is_set():
                break
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not errors, errors[0]
    assert all(r > 0 for r in rounds)
    assert capped.chunks.cold.capacity >= 1024
