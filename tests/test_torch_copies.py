"""The port's copies of the JAX package's host modules give the package's
results: settings, feature hashing, featurization, the stub embedder and the
native RRF merge and HNSW graph, on seeded inputs, bit for bit.

This module also builds the JAX package's HNSW library once before
``tests/unit`` is collected (it is collected first: files are collected in
name order). ``tests/unit/test_hnsw.py`` asks ``hnsw.available()`` while it
is collected, and test workers that start together would each run g++ into
the same file, so one could load it half written and skip that file's
tests. Here the first worker builds it under a file lock and the others
wait, then load the finished library.
"""

import dataclasses
import fcntl
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

from cadence_rag_tpu import config as jconfig
from cadence_rag_tpu.embed.stub import HashEmbeddingProvider as JaxStub
from cadence_rag_tpu.ingest import featurize as jfeaturize
from cadence_rag_tpu.native import hnsw as jhnsw
from cadence_rag_tpu.native import rrf as jrrf
from cadence_rag_tpu.ops import hashing as jhashing
from cadence_rag_tpu_torch import config as tconfig
from cadence_rag_tpu_torch.embed.stub import HashEmbeddingProvider as PortStub
from cadence_rag_tpu_torch.ingest import featurize as tfeaturize
from cadence_rag_tpu_torch.native import hnsw as thnsw
from cadence_rag_tpu_torch.native import rrf as trrf
from cadence_rag_tpu_torch.ops import hashing as thashing

LOCK_TIMEOUT_S = 300.0


def _build_jax_hnsw_once() -> None:
    """``jhnsw.available()`` under an exclusive lock shared by every process
    of this test run, so one process builds the library and the rest load
    it. After LOCK_TIMEOUT_S without the lock, go on without it."""
    path = Path(tempfile.gettempdir()) / "cadence_rag_tpu_hnsw_build.lock"
    with open(path, "w") as lock:
        deadline = time.monotonic() + LOCK_TIMEOUT_S
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    return
                time.sleep(0.05)
        try:
            jhnsw.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_build_jax_hnsw_once()

WORDS = ["gateway", "latency", "rollback", "kafka", "consumer", "lag",
         "tiering", "cluster", "retry", "budget", "azure", "ECONNRESET",
         "broker-7", "v3.2.1", "object_store", "p99", "bake-off", "SSD"]
TOKENS = [f"srv-{i}" for i in range(40)] + [f"v2.{i}.1" for i in range(20)]


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 14))))
             for _ in range(n)]
    return texts + ["", "   ", "Ünïcode tëxt — with dashes"]


def _token_lists(seed, n):
    rng = np.random.default_rng(seed)
    return [list(rng.choice(TOKENS, size=int(rng.integers(0, 12)), replace=False))
            + (["SRV-1", " srv-1 "] if i % 7 == 0 else []) for i in range(n)]


# -- settings -------------------------------------------------------------------
def test_settings_same_fields_and_defaults():
    port = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfig.Settings)]
    jax = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.Settings)]
    assert port == jax


def test_settings_same_environment_variables(monkeypatch, tmp_path):
    monkeypatch.setenv("LEXICAL_DIM", "512")
    monkeypatch.setenv("DENSE_IVF_ENABLED", "yes")
    monkeypatch.setenv("ANN_RECALL_TARGET", "0.9")
    env_file = tmp_path / "settings.env"
    env_file.write_text("TECH_HASH_SLOTS=8\n# a comment\nINDEX_EMBEDDING_DTYPE='int8'\n")
    monkeypatch.setenv("CADENCE_ENV_FILE", str(env_file))
    port, jax = tconfig.Settings(), jconfig.Settings()
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    assert (port.lexical_dim, port.dense_ivf_enabled, port.tech_hash_slots,
            port.index_embedding_dtype) == (512, True, 8, "int8")


def test_port_settings_are_their_own_object():
    assert tconfig.settings is not jconfig.settings


# -- ops/hashing.py ---------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_lexical_features_and_raw_arrays(seed):
    for text in _texts(seed, 40):
        assert thashing.lexical_features(text) == jhashing.lexical_features(text)
        for a, b in zip(thashing.raw_feature_arrays(text),
                        jhashing.raw_feature_arrays(text)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize("dim,avgdl", [(4096, 10.0), (1024, 0.0), (512, 37.5)])
def test_doc_signatures(dim, avgdl):
    for text in _texts(dim, 40):
        raw = jhashing.raw_feature_arrays(text)
        got = thashing.doc_signature_from_raw(*raw, dim, avgdl)
        want = jhashing.doc_signature_from_raw(*raw, dim, avgdl, None)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim", [4096, 1000])
def test_query_features_and_vector(dim):
    rng = np.random.default_rng(dim)
    doc_freq = rng.integers(0, 500, size=dim)
    for text in _texts(dim + 1, 40):
        got = thashing.query_feature_arrays(text, dim)
        want = jhashing.query_feature_arrays(text, dim)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            thashing.query_vector_from_features(*got, dim, doc_freq, 1000),
            jhashing.query_vector_from_features(*want, dim, doc_freq, 1000))
    assert thashing.LEX_QUANT_SCALE == jhashing.LEX_QUANT_SCALE


@pytest.mark.parametrize("slots,capacity,max_capacity", [(16, 1, 8), (16, 2, 8), (8, 1, 0)])
def test_tech_hashes_and_structures(slots, capacity, max_capacity):
    for tokens in _token_lists(slots + capacity, 60):
        np.testing.assert_array_equal(thashing.tech_token_hashes(tokens, slots),
                                      jhashing.tech_token_hashes(tokens, slots))
        got = thashing.tech_query_structure(tokens, slots, capacity, max_capacity)
        want = jhashing.tech_query_structure(tokens, slots, capacity, max_capacity)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# -- ingest/featurize.py (JAX: its native featurizer when built) ------------------
def test_featurize_batches_match():
    texts = _texts(3, 60)
    for a, b in zip(tfeaturize.lexical_signatures_batch(texts, 12.0),
                    jfeaturize.lexical_signatures_batch(texts, 12.0)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(tfeaturize.query_lexical_features_batch(texts),
                    jfeaturize.query_lexical_features_batch(texts)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    tokens = _token_lists(4, 60)
    for a, b in zip(tfeaturize.query_tech_structures_batch(tokens),
                    jfeaturize.query_tech_structures_batch(tokens)):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    for toks in tokens:
        np.testing.assert_array_equal(tfeaturize.tech_slots(toks),
                                      jfeaturize.tech_slots(toks))


def test_featurize_follows_each_packages_settings(monkeypatch):
    """Each package reads its own settings; set alike, they agree."""
    texts = _texts(5, 10)
    for s in (tconfig.settings, jconfig.settings):
        monkeypatch.setattr(s, "lexical_dim", 256)
        monkeypatch.setattr(s, "tech_hash_slots", 8)
        monkeypatch.setattr(s, "tech_slot_capacity", 2)
    sig = tfeaturize.lexical_signatures_batch(texts, 5.0)
    assert sig[0][0].shape == (256,)
    for a, b in zip(sig, jfeaturize.lexical_signatures_batch(texts, 5.0)):
        np.testing.assert_array_equal(a[0], b[0])
    tokens = _token_lists(6, 10)
    for a, b in zip(tfeaturize.query_tech_structures_batch(tokens),
                    jfeaturize.query_tech_structures_batch(tokens)):
        assert a[0].shape[0] % 8 == 0 and a[0].shape[0] >= 16
        np.testing.assert_array_equal(a[0], b[0])


# -- embed/stub.py ----------------------------------------------------------------
@pytest.mark.parametrize("dim", [1024, 64])
def test_stub_embedder_vectors(monkeypatch, dim):
    for s in (tconfig.settings, jconfig.settings):
        monkeypatch.setattr(s, "embeddings_dim", dim)
    texts = _texts(dim, 30)
    got = PortStub().embed(texts)
    want = JaxStub().embed(texts)
    np.testing.assert_array_equal(np.asarray(got.vectors), np.asarray(want.vectors))
    assert got.model == want.model
    # a second call hits the direction bank: the same vectors
    np.testing.assert_array_equal(np.asarray(PortStub().embed(texts).vectors),
                                  np.asarray(got.vectors))


# -- native/rrf.py and native/hnsw.py -----------------------------------------------
def test_native_rrf_merges_match():
    rng = np.random.default_rng(8)
    n, n_plans = 3000, 40
    plan = rng.integers(0, n_plans, size=n).astype(np.int32)
    doc = rng.integers(0, 300, size=n).astype(np.int64)
    contrib = 1.0 / (60 + rng.integers(1, 50, size=n).astype(np.float64))
    bits = (1 << rng.integers(0, 3, size=n)).astype(np.uint8)
    got = trrf.merge_groups(plan, doc, contrib, bits, n_plans)
    want = jrrf.merge_groups(plan, doc, contrib, bits, n_plans)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    lanes = [(rng.integers(0, 200, size=(n_plans, w)).astype(np.int64),
              rng.integers(0, w + 1, size=n_plans).astype(np.int32))
             for w in (50, 10, 50)]
    for a, b in zip(trrf.merge_rect_groups(lanes, n_plans, 60),
                    jrrf.merge_rect_groups(lanes, n_plans, 60)):
        np.testing.assert_array_equal(a, b)


def test_native_hnsw_search_matches():
    assert thnsw.available() and jhnsw.available()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((600, 32)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, 600, size=12)] + 0.05 * rng.standard_normal((12, 32)).astype(np.float32)
    port = thnsw.HnswIndex(x, m=8, ef_construction=32, seed=3)
    jax = jhnsw.HnswIndex(x, m=8, ef_construction=32, seed=3)
    for a, b in zip(port.search(q, k=10, ef_search=40), jax.search(q, k=10, ef_search=40)):
        np.testing.assert_array_equal(a, b)


def test_native_libraries_build_into_the_build_dir():
    from cadence_rag_tpu_torch.native.build import NATIVE_DIR, library_path

    assert trrf.available()
    lib = library_path(Path(trrf.__file__).with_name("rrf.cpp"), ("-O3",))
    assert lib.parent == NATIVE_DIR and lib.is_file()
    assert "build" in NATIVE_DIR.parts


# -- the request path's host modules ------------------------------------------------
VERBATIM = [
    "schemas/__init__.py", "schemas/common.py", "schemas/calls.py",
    "schemas/ingest.py", "schemas/retrieve.py", "schemas/responses.py",
    "utils/timeutil.py", "utils/errors.py", "utils/locks.py", "logging_utils.py",
    "evals/metrics.py", "evals/fixtures.py", "serve/metrics.py",
]
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copies(path):
    """Modules the port copies unchanged: the same text."""
    port = (REPO / "cadence_rag_tpu_torch" / path).read_text()
    assert port == (REPO / "cadence_rag_tpu" / path).read_text()


def test_chunking_matches():
    from cadence_rag_tpu.ingest import chunking as jchunk
    from cadence_rag_tpu.schemas import ChunkingOptions as JOpts, UtteranceIn as JUtt
    from cadence_rag_tpu_torch.ingest import chunking as tchunk
    from cadence_rag_tpu_torch.schemas import ChunkingOptions as TOpts, UtteranceIn as TUtt

    texts = _texts(11, 50) + [
        "see https://x.io/a and 10.2.0.15, OPS-1842, EPIPE, HTTP 503, ORA-00600",
        "v2.3.1 deadbeefcafe /runbooks/cloud bill of materials vs dell azure aws",
        "- item one\n- item two\n\n1. first\n2) second\n\nplain paragraph"]
    for t in texts:
        assert tchunk.extract_tech_tokens(t) == jchunk.extract_tech_tokens(t)
        assert tchunk.count_tokens(t) == jchunk.count_tokens(t)
        for kind in ("action_items", "summary"):
            assert ([dataclasses.asdict(c) for c in tchunk.build_artifact_chunks(kind, t)]
                    == [dataclasses.asdict(c) for c in jchunk.build_artifact_chunks(kind, t)])
    rng = np.random.default_rng(12)
    for opts in ((30, 60, 5), (8, 20, 0), (25, 50, 4)):
        rows = [dict(speaker=["A", "B", None][i % 3], start_ts_ms=i * 1000,
                     end_ts_ms=i * 1000 + 900, text=texts[int(rng.integers(len(texts)))])
                for i in range(20)]
        utts = [jchunk.Utterance(utterance_id=i + 1, speaker=r["speaker"], speaker_id=None,
                                 start_ts_ms=r["start_ts_ms"], end_ts_ms=r["end_ts_ms"],
                                 confidence=None, text=r["text"],
                                 token_count=jchunk.count_tokens(r["text"]))
                for i, r in enumerate(rows)]
        tutts = [tchunk.Utterance(**dataclasses.asdict(u)) for u in utts]
        jo, to = JOpts(**dict(zip(("target_tokens", "max_tokens", "overlap_tokens"), opts))), \
            TOpts(**dict(zip(("target_tokens", "max_tokens", "overlap_tokens"), opts)))
        assert ([dataclasses.asdict(c) for c in tchunk.build_chunks(tutts, to)]
                == [dataclasses.asdict(c) for c in jchunk.build_chunks(utts, jo)])
        assert (tchunk.transcript_hash([TUtt(**r) for r in rows], to)
                == jchunk.transcript_hash([JUtt(**r) for r in rows], jo))
    assert tchunk.PIPELINE_VERSION == jchunk.PIPELINE_VERSION


def test_native_ids_only_format_matches():
    rng = np.random.default_rng(13)
    n_plans = 30

    def groups(n, kinds):
        plan = np.sort(rng.integers(0, n_plans, size=n)).astype(np.int32)
        doc = rng.integers(1, 10**12, size=n).astype(np.int64)
        score = rng.choice([1 / 61, 1 / 62, 2 / 61, 1 / 61 + 1 / 70], size=n)
        return plan, doc, score

    a, c = groups(400, 0), groups(2000, 1)
    got = trrf.ids_only_format(*a, *c, n_plans)
    want = jrrf.ids_only_format(*a, *c, n_plans)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) == 2400
    # not plan-major: both refuse
    bad = (a[0][::-1].copy(),) + a[1:]
    assert trrf.ids_only_format(*bad, *c, n_plans) is None
    assert jrrf.ids_only_format(*bad, *c, n_plans) is None


def test_featurize_single_text_api_matches():
    for text in _texts(14, 30):
        for a, b in zip(tfeaturize.lexical_signature(text, 11.0),
                        jfeaturize.lexical_signature(text, 11.0)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tfeaturize.query_lexical_features(text),
                        jfeaturize.query_lexical_features(text)):
            np.testing.assert_array_equal(a, b)
    for toks in _token_lists(15, 30):
        a, b = tfeaturize.query_tech_structure(toks), jfeaturize.query_tech_structure(toks)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    assert tfeaturize.active_vocab() == (None, 0) == jfeaturize.active_vocab()
    tfeaturize.set_active_vocab(None, 0)
    with pytest.raises(NotImplementedError, match="vocab"):
        tfeaturize.set_active_vocab(np.arange(1, 5, dtype=np.uint64), 1)


@pytest.mark.parametrize("cache", [0, 64])
def test_embed_facade_matches(monkeypatch, cache):
    from cadence_rag_tpu.embed import provider as jprov
    from cadence_rag_tpu.embed.pipeline import infer_batch_size_limit as jlimit
    from cadence_rag_tpu_torch.embed import provider as tprov
    from cadence_rag_tpu_torch.embed.pipeline import infer_batch_size_limit as tlimit

    for s in (tconfig.settings, jconfig.settings):
        monkeypatch.setattr(s, "embeddings_dim", 64)
        monkeypatch.setattr(s, "embeddings_provider", "stub")
        monkeypatch.setattr(s, "embed_cache_size", cache)
    tprov.reset_embed_cache()
    jprov.reset_embed_cache()
    texts = [t for t in _texts(16, 40) if t.strip()]
    for _ in range(2):
        got, want = tprov.embed_texts(texts), jprov.embed_texts(texts)
        np.testing.assert_array_equal(got.vectors, want.vectors)
        assert got.model == want.model
    np.testing.assert_array_equal(tprov.embed_texts_batched(texts, 7).vectors,
                                  jprov.embed_texts_batched(texts, 7).vectors)
    with pytest.raises(tprov.EmbeddingError):
        tprov.embed_texts(["  "])
    for msg in ("max batch size <= 8", "Maximum batch size is 16", "nope", ""):
        assert tlimit(msg) == jlimit(msg)
    for kind in tprov.NOT_PORTED_PROVIDERS:
        monkeypatch.setattr(tconfig.settings, "embeddings_provider", kind)
        with pytest.raises(RuntimeError, match="not ported"):
            tprov.get_provider()
    tprov.reset_embed_cache()
    jprov.reset_embed_cache()


def test_a_store_file_opens_in_both(tmp_path):
    """The same migrations: a store the JAX package wrote opens in the
    port, and the port's rows read back in the JAX package."""
    from cadence_rag_tpu.store.db import MIGRATIONS as JMIG, SCHEMA_VERSION as JVER
    from cadence_rag_tpu.store.db import Store as JStore
    from cadence_rag_tpu_torch.evals.synth import bulk_store_rows
    from cadence_rag_tpu_torch.store.db import MIGRATIONS, SCHEMA_VERSION, Store

    assert MIGRATIONS == JMIG and SCHEMA_VERSION == JVER
    path = str(tmp_path / "shared.db")
    JStore(path).close()
    store = Store(path)
    assert store.validate_versions()[0]
    info = store.fetch_info()
    assert info["schema_version"] == SCHEMA_VERSION and "torch_version" in info
    bulk_store_rows(store, 50, 7, 4)
    store.close()
    jstore = JStore(path)
    with jstore.read() as conn:
        counts = [conn.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                  for t in ("calls", "chunks", "artifact_chunks")]
    jstore.close()
    assert counts == [4, 50, 7]


def test_bulk_store_rows_match(tmp_path):
    from cadence_rag_tpu.evals.synth import bulk_store_rows as jbulk
    from cadence_rag_tpu.store.db import Store as JStore
    from cadence_rag_tpu_torch.evals.synth import bulk_store_rows as tbulk
    from cadence_rag_tpu_torch.store.db import Store

    dumps = []
    for bulk, store_cls, name in ((tbulk, Store, "p.db"), (jbulk, JStore, "j.db")):
        store = store_cls(str(tmp_path / name))
        ids = bulk(store, 120, 30, 9)
        with store.read() as conn:
            # every column but the insert time
            dumps.append((ids, [
                [{k: r[k] for k in r.keys() if k != "call_started_at"}
                 for r in conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()]
                for t in ("chunks", "artifact_chunks")]))
        store.close()
    assert dumps[0] == dumps[1]
