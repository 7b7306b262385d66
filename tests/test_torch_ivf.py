"""The port's IVF (``ops/ivf.py``) and the index's IVF dense mode against
the JAX package, on CPU.

Tolerances: k-means assignments and bucket packing identical, centroids
within 1e-5; probed top-k ids identical and scores within 1e-5 (f32 sums
in another order); the index's IVF dense lane gives the JAX index's ids.
The mode tests mirror tests/integration/test_ivf_mode.py.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cadence_rag_tpu_torch.core.index as tindex
from cadence_rag_tpu.config import settings
from cadence_rag_tpu.core.index import DocRow as JaxDocRow
from cadence_rag_tpu.core.index import get_index as jax_get_index
from cadence_rag_tpu.embed import embed_texts
from cadence_rag_tpu.ingest import featurize
from cadence_rag_tpu.ops import ivf as jivf
from cadence_rag_tpu_torch.config import settings as port_settings
from cadence_rag_tpu_torch.core.index import DeviceIndexManager
from cadence_rag_tpu_torch.engine.planner import choose_dense_mode
from cadence_rag_tpu_torch.ops import ivf as tivf
from cadence_rag_tpu_torch.ops.topk import topk_lowest_index_first

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max
KS = (10, 10, 10)
TOPICS = [
    "object store ECONNRESET retries on the gateway",
    "lenovo BOM pricing for the bake-off",
    "azure migration cutover runbook details",
    "SSD tiering latency improvements",
    "kafka consumer lag after the broker upgrade",
]


@pytest.fixture
def tmp_store(tmp_store, monkeypatch):
    """conftest's store, with the port's settings (an object of its own)
    given the values the JAX package's settings have there."""
    for field in dataclasses.fields(port_settings):
        monkeypatch.setattr(port_settings, field.name,
                            getattr(tmp_store, field.name))
    return tmp_store


@pytest.fixture
def set_both(monkeypatch):
    """Set one setting in both packages, so that they compare the same
    configuration."""
    def put(name, value):
        monkeypatch.setattr(settings, name, value)
        monkeypatch.setattr(port_settings, name, value)
    return put


def _t(x):
    """numpy (or a jax array) -> a CPU tensor on its own copy."""
    return torch.from_numpy(np.array(x))


def _clustered(rng, n_clusters, per, dim, noise):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    docs = np.repeat(centers, per, axis=0)
    docs += noise * rng.standard_normal(docs.shape).astype(np.float32)
    return docs / np.linalg.norm(docs, axis=1, keepdims=True)


# -- ops/ivf.py ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kmeans_with_jax_init_matches(dtype):
    """bf16 rows (bf16-rounded centroids, f32 sums) and f32 rows (the
    dequantized int8 build) on well-separated clusters."""
    rng = np.random.default_rng(0)
    docs = _clustered(rng, 8, 64, 32, 0.05)
    n = docs.shape[0]
    key = jax.random.PRNGKey(3)
    j_docs = jnp.asarray(docs, dtype=getattr(jnp, dtype))
    j_cent, j_assign = jivf.kmeans(j_docs, key, n_clusters=8, iters=10)
    init = np.asarray(jax.random.choice(key, n, shape=(8,), replace=False))
    t_docs = _t(np.asarray(j_docs, dtype=np.float32)).to(getattr(torch, dtype))
    t_cent, t_assign = tivf.kmeans(t_docs, n_clusters=8, iters=10,
                                   init_idx=_t(init.astype(np.int64)))
    assert t_assign.dtype == torch.int32 and t_cent.dtype == torch.float32
    np.testing.assert_array_equal(t_assign.numpy(), np.asarray(j_assign))
    np.testing.assert_allclose(t_cent.numpy(), np.asarray(j_cent), atol=1e-5)


def test_kmeans_with_generator_recovers_clusters():
    rng = np.random.default_rng(1)
    docs = _clustered(rng, 8, 64, 32, 0.15)
    gen = torch.Generator()
    gen.manual_seed(0)
    centroids, assign = tivf.kmeans(_t(docs).to(torch.bfloat16), n_clusters=8,
                                    iters=15, generator=gen)
    assign = assign.numpy()
    agree = sum(np.bincount(assign[g * 64:(g + 1) * 64], minlength=8).max()
                for g in range(8))
    assert agree / docs.shape[0] > 0.85
    np.testing.assert_allclose(np.linalg.norm(centroids.numpy(), axis=1), 1.0,
                               atol=1e-4)


@pytest.mark.parametrize("n,n_clusters,cap", [
    (1000, 7, 100), (1000, 7, 200), (6, 3, 2), (500, 9, 8),
])
def test_build_buckets_identical(n, n_clusters, cap):
    rng = np.random.default_rng(n + cap)
    # skewed sizes, and cluster n_clusters-1 left empty
    assign = np.minimum(rng.geometric(0.3, size=n) - 1,
                        n_clusters - 2).astype(np.int32)
    j_b, j_o = jivf.build_buckets(assign, n_clusters, cap)
    t_b, t_o = tivf.build_buckets(assign, n_clusters, cap)
    assert t_b.dtype == j_b.dtype and t_o.dtype == j_o.dtype
    np.testing.assert_array_equal(t_b, j_b)
    np.testing.assert_array_equal(t_o, j_o)


def _ivf_inputs(rng, dtype, n_clusters, per, cap, dim=32):
    docs = _clustered(rng, n_clusters, per, dim, 0.15)
    n = docs.shape[0]
    if dtype == "int8":
        stored = np.clip(np.rint(docs * 127.0), -127, 127).astype(np.int8)
        j_emb, t_emb = jnp.asarray(stored), _t(stored)
        deq = stored.astype(np.float32) / 127.0
    else:
        j_emb = jnp.asarray(docs, dtype=jnp.bfloat16)
        t_emb = _t(docs).to(torch.bfloat16)
        deq = np.asarray(j_emb, dtype=np.float32)
    cent, assign = jivf.kmeans(jnp.asarray(deq), jax.random.PRNGKey(5),
                               n_clusters=n_clusters, iters=8)
    buckets, overflow = jivf.build_buckets(np.asarray(assign), n_clusters, cap)
    overflow = np.concatenate([overflow, np.full(8 - len(overflow) % 8, -1,
                                                 dtype=np.int32)])
    q = docs[rng.choice(n, size=6, replace=False)] + 0.05 * rng.standard_normal(
        (6, dim)).astype(np.float32)
    mask = rng.random((6, n)) < 0.6
    return (j_emb, t_emb, np.asarray(cent), buckets, overflow,
            q.astype(np.float32), mask)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("n_clusters,per,cap,nprobe,k", [
    (16, 64, 96, 4, 10),    # some buckets overflow into the tail
    (2, 8, 4, 1, 50),       # k larger than the probed candidate set
    (8, 32, 64, 16, 20),    # nprobe above the cluster count
])
def test_ivf_topk_matches_jax(dtype, n_clusters, per, cap, nprobe, k):
    rng = np.random.default_rng(n_clusters + k)
    j_emb, t_emb, cent, buckets, overflow, q, mask = _ivf_inputs(
        rng, dtype, n_clusters, per, cap)
    j_s, j_p = jivf.ivf_topk(jnp.asarray(q), j_emb, jnp.asarray(cent),
                             jnp.asarray(buckets), jnp.asarray(overflow),
                             jnp.asarray(mask), k=k, nprobe=nprobe)
    t_s, t_p = tivf.ivf_topk(_t(q), t_emb, _t(cent), _t(buckets), _t(overflow),
                             _t(mask), k=k, nprobe=nprobe)
    j_s, j_p = np.asarray(j_s), np.asarray(j_p)
    assert t_s.shape == (6, k) and t_p.dtype == torch.int64
    np.testing.assert_array_equal(t_p.numpy(), j_p)
    np.testing.assert_array_equal(np.isfinite(t_s.numpy()), np.isfinite(j_s))
    fin = np.isfinite(j_s)
    np.testing.assert_allclose(t_s.numpy()[fin], j_s[fin], rtol=1e-5, atol=1e-5)
    assert (t_p.numpy()[~fin] == -1).all()
    if k == 50:
        assert (~fin).any(), "the padding case must pad"


def test_ivf_topk_gather_groups_give_the_same_result(monkeypatch):
    """The per-query gather is grouped to GATHER_BYTES; small groups (with a
    ragged last one) give the whole-batch result."""
    rng = np.random.default_rng(9)
    _j, t_emb, cent, buckets, overflow, q, mask = _ivf_inputs(
        rng, "bfloat16", 16, 64, 96)
    args = (_t(q), t_emb, _t(cent), _t(buckets), _t(overflow), _t(mask))
    whole = tivf.ivf_topk(*args, k=10, nprobe=4)
    per_query = (4 * 96 + overflow.shape[0]) * 32 * 2
    monkeypatch.setattr(tivf, "GATHER_BYTES", 4 * per_query)
    grouped = tivf.ivf_topk(*args, k=10, nprobe=4)
    for a, b in zip(whole, grouped):
        assert torch.equal(a, b)


# -- the index's IVF dense mode ------------------------------------------------
def _rows(rng, n, first_id):
    texts = []
    for i in range(n):
        topic = TOPICS[i % len(TOPICS)]
        texts.append(f"{topic} variation {first_id + i} "
                     + " ".join(rng.choice(["alpha", "beta", "gamma", "delta"], 3)))
    sigs = featurize.lexical_signatures_batch(texts, avgdl=10.0)
    vecs = embed_texts(texts).vectors
    calls = np.sort(rng.integers(0, 12, size=n))
    return [JaxDocRow(
        doc_id=first_id + i, call_seq=int(calls[i]),
        started_sec=1_650_000_000 + int(calls[i]), lex_sig=sigs[i][0],
        lex_dl=sigs[i][2], lex_touched=sigs[i][1], tech=featurize.tech_slots([]),
        embedding=vecs[i]) for i in range(n)], texts


def _batch(texts):
    b = len(texts)
    q_emb = np.stack(embed_texts(texts).vectors).astype(np.float32)
    feats = featurize.query_lexical_features_batch(texts)
    q_tech = np.zeros((b, int(settings.tech_hash_slots)), dtype=np.int32)
    allowed = np.ones((b, 256), dtype=bool)
    return (q_emb, feats, q_tech, allowed, np.full(b, INT32_MIN + 1, np.int32),
            np.full(b, INT32_MAX, np.int32))


def _serve(idx, args, chunk_mode, fuse=True):
    disp = idx.query_both_packed_async(
        *args, chunk_ks=KS, artifact_ks=KS, chunk_mode=chunk_mode,
        artifact_mode="exact", recall_target=0.95, fuse_rrf=fuse)
    return disp, idx.collect_packed(disp)


def _port_index(rng, n_chunks=200):
    idx = DeviceIndexManager("cpu")
    rows, texts = _rows(rng, n_chunks, 1)
    idx.chunks.insert(rows)
    idx.artifacts.insert(_rows(rng, 30, 10_000)[0])
    return idx, texts


def _dense_ids(out):
    ids, _scores, counts = out[0]["dense"]
    return [ids[b, : counts[b]].tolist() for b in range(len(counts))]


def test_ivf_state_from_jax_serves_the_jax_dense_ids(tmp_store):
    rng = np.random.default_rng(0)
    jidx = jax_get_index()
    rows, texts = _rows(rng, 200, 1)
    jidx.chunks.insert(rows)
    jidx.artifacts.insert(_rows(rng, 30, 10_000)[0])
    state = jidx.chunks.build_ivf(n_clusters=4, nprobe=2)
    tidx = DeviceIndexManager("cpu")
    for name in ("chunks", "artifact_chunks"):
        tidx.corpus(name).load_state(jidx.corpus(name).state_arrays())
    tidx.chunks.load_ivf_state(state)
    assert tidx.chunks.ivf_usable() and tidx.chunks.ivf.nprobe == 2
    args = _batch([texts[i] + " gateway" for i in rng.integers(0, 200, size=6)])
    t_disp, t_out = _serve(tidx, args, "ivf")
    j_disp, j_out = _serve(jidx, args, "ivf")
    # the dense lane ran in its own dispatch, so device RRF was turned off
    assert t_disp.served_chunk_mode == j_disp.served_chunk_mode == "ivf"
    assert "__rrf__" not in t_out[0] and "__rrf__" not in j_out[0]
    assert _dense_ids(t_out) == _dense_ids(j_out)
    np.testing.assert_allclose(t_out[0]["dense"][1], j_out[0]["dense"][1],
                               rtol=1e-5, atol=1e-5)
    for lane in ("lex", "tech"):
        assert t_out[0][lane][0].shape == j_out[0][lane][0].shape


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_all_clusters_probed_equals_the_exact_scan(tmp_store, set_both, emb_dtype):
    """nprobe == n_clusters scans every bucket: the IVF lane is the exact
    top-k of the f32 query against every row (int8 rows on the cosine
    scale)."""
    set_both("index_embedding_dtype", emb_dtype)
    rng = np.random.default_rng(1)
    idx, texts = _port_index(rng)
    state = idx.chunks.build_ivf(n_clusters=4, nprobe=4)
    assert state.built_count == idx.chunks.count == 200
    args = _batch([texts[i] for i in rng.integers(0, 200, size=5)])
    _disp, out = _serve(idx, args, "ivf", fuse=False)
    n = idx.chunks.count
    emb = idx.chunks.emb[:n].float()
    if emb_dtype == "int8":
        emb = emb / 127.0
    want_vals, want_pos = topk_lowest_index_first(_t(args[0]) @ emb.T, KS[0])
    ids, scores, counts = out[0]["dense"]
    assert (counts == KS[0]).all()
    np.testing.assert_array_equal(ids, idx.chunks.h_ids[want_pos.numpy()])
    np.testing.assert_allclose(scores, want_vals.numpy(), rtol=1e-5, atol=1e-5)


def test_overflow_tail_keeps_new_rows_visible(tmp_store):
    rng = np.random.default_rng(2)
    idx, _texts = _port_index(rng)
    idx.chunks.build_ivf(n_clusters=4, nprobe=1)
    text = "freshly ingested zeppelin maintenance log"
    row = _rows(rng, 1, 5_000)[0][0]
    vec = embed_texts([text]).vectors[0]
    idx.chunks.insert([JaxDocRow(**{**row.__dict__, "embedding": vec})])
    assert idx.chunks.ivf.overflow_count == 1
    assert int(idx.chunks.ivf.overflow[0]) == idx.chunks.count - 1
    disp, out = _serve(idx, _batch([text]), "ivf")
    assert disp.served_chunk_mode == "ivf"
    assert _dense_ids(out)[0][0] == 5_000


def test_stale_ivf_falls_back_to_ann(tmp_store, set_both):
    set_both("dense_ivf_enabled", True)
    set_both("ivf_min_rows", 8)
    rng = np.random.default_rng(3)
    idx, texts = _port_index(rng, n_chunks=20)
    idx.chunks.build_ivf(n_clusters=4, nprobe=2)
    assert choose_dense_mode(idx.chunks.count, False,
                             ivf_available=idx.chunks.ivf_usable()) == "ivf"
    # suppress the background rebuild so staleness can accumulate
    idx.chunks._ivf_rebuilding = True
    idx.chunks.insert(_rows(rng, 24, 1_000)[0])
    assert not idx.chunks.ivf_usable()
    assert choose_dense_mode(idx.chunks.count, False,
                             ivf_available=idx.chunks.ivf_usable()) == "ann"
    # planned ivf, index dropped before dispatch: ann serves and says so
    idx.chunks.ivf = None
    disp, out = _serve(idx, _batch(texts[:3]), "ivf")
    assert disp.served_chunk_mode == "ann"
    assert "__rrf__" in out[0]


def test_cold_start_serves_an_ivf_plan_as_ann(tmp_store):
    rng = np.random.default_rng(4)
    idx = DeviceIndexManager("cpu")
    rows, texts = _rows(rng, 40, 1)
    idx.chunks.insert(rows)
    disp, out = _serve(idx, _batch(texts[:2]), "ivf", fuse=False)
    assert disp.served_chunk_mode == "ann"
    assert out[0]["dense"][0].shape[0] == 2


def test_planner_mode_table_with_ivf(set_both):
    set_both("dense_ivf_enabled", True)
    set_both("ivf_min_rows", 1000)
    assert choose_dense_mode(5000, scoped=False) == "ann"
    assert choose_dense_mode(500, scoped=True) == "exact"
    assert choose_dense_mode(0, scoped=False, ivf_available=True) == "exact"
    assert choose_dense_mode(5000, scoped=False, ivf_available=True) == "ivf"
    assert choose_dense_mode(500, scoped=False, ivf_available=True) == "ann"
    set_both("dense_ivf_enabled", False)
    assert choose_dense_mode(5000, scoped=False, ivf_available=True) == "ann"


def test_build_aborts_when_rows_are_renumbered(tmp_store, monkeypatch):
    rng = np.random.default_rng(5)
    idx, _texts = _port_index(rng, n_chunks=40)
    corpus = idx.chunks
    real_kmeans = tindex.kmeans

    def racing_kmeans(*args, **kwargs):
        corpus._pos_gen += 1  # a renumbering landed mid-clustering
        return real_kmeans(*args, **kwargs)

    monkeypatch.setattr(tindex, "kmeans", racing_kmeans)
    with pytest.raises(RuntimeError, match="row positions changed"):
        corpus.build_ivf(n_clusters=4, nprobe=4)
    assert corpus.ivf is None


def test_load_state_drops_the_ivf(tmp_store):
    rng = np.random.default_rng(6)
    idx, _texts = _port_index(rng, n_chunks=40)
    idx.chunks.build_ivf(n_clusters=4, nprobe=4)
    gen = idx.chunks._pos_gen
    idx.chunks.load_state(idx.chunks.state_arrays())
    assert idx.chunks.ivf is None and idx.chunks._pos_gen == gen + 1


def test_rows_inserted_during_the_build_join_the_tail(tmp_store, monkeypatch):
    rng = np.random.default_rng(7)
    idx, _texts = _port_index(rng, n_chunks=40)
    corpus = idx.chunks
    real_kmeans = tindex.kmeans
    late = _rows(rng, 3, 7_000)[0]

    def inserting_kmeans(*args, **kwargs):
        corpus.insert(late)  # an insert lands while k-means runs
        return real_kmeans(*args, **kwargs)

    monkeypatch.setattr(tindex, "kmeans", inserting_kmeans)
    state = corpus.build_ivf(n_clusters=4, nprobe=4)
    assert state.built_count == 40 and corpus.count == 43
    assert corpus._ivf_overflow_host.tolist()[-3:] == [40, 41, 42]
    assert state.overflow_count == len(corpus._ivf_overflow_host)


def test_background_rebuild_refreshes_the_index(tmp_store, set_both):
    set_both("dense_ivf_enabled", True)
    rng = np.random.default_rng(8)
    idx, texts = _port_index(rng, n_chunks=20)
    idx.chunks.build_ivf(n_clusters=4, nprobe=4)
    # overflow past max(built/2, 8) -> a background rebuild
    idx.chunks.insert(_rows(rng, 12, 2_000)[0])
    deadline = time.time() + 60
    while time.time() < deadline:
        state = idx.chunks.ivf
        if state.built_count > 20 and not idx.chunks._ivf_rebuilding:
            break
        time.sleep(0.05)
    assert idx.chunks.ivf.built_count == 32
    disp, out = _serve(idx, _batch(texts[:2]), "ivf")
    assert disp.served_chunk_mode == "ivf" and all(_dense_ids(out))
