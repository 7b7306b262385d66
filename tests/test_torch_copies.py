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
