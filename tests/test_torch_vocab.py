"""The learned lexical vocab head, JAX package vs port, on the CPU.

``tests/integration/test_lex_vocab.py`` and ``tests/integration/
test_vocab_auto.py`` run against the port as they stand
(``torch_parity.mirror_tests``), once with the native featurizer and once
with the pure-Python one (the ``port_tmp_store`` fixture is parametrised):
with a vocab active both must give the same bits, since the native library
then supplies raw features only and numpy places them; the op-log replay of
a re-featurize runs through the port's ``parallel/oplog._apply``. One of
their tests does not apply: the legacy ``hashing.doc_signature`` (the port
keeps only the ``*_from_raw`` functions); ``test_placement_matches`` holds
it against the JAX package's.

Then both packages on the same seeded inputs: ``apply_vocab`` and the two
``*_from_raw`` functions bit-equal with a vocab, the registry taking the
JAX package's sorted uint64 array as it is, ``build_vocab_from_store`` equal,
and ``build_and_apply`` leaving the same ``lex`` rows, ``doc_freq`` and
store blobs (state arrays bit-equal) and the same answers (ids identical,
lane scores within 1e-5).
"""

import sys

import numpy as np
import pytest

from cadence_rag_tpu_torch.native import lexhash as port_lexhash
from torch_parity import (
    BOTH,
    JAX,
    ON_CPU,
    PORT,
    assert_same_response,
    ingest_corpus,
    mirror_tests,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)


@pytest.fixture(params=["native", "python"])
def port_tmp_store(port_store, request, monkeypatch):
    """The mirrored tests' store, under each of the port's featurizers."""
    if request.param == "python":
        monkeypatch.setattr(port_lexhash, "available", lambda: False)
    assert PORT.featurize.native_available() == (request.param == "native")
    return port_store


mirror_tests(globals(), "lex_vocab", "integration/test_lex_vocab.py", drop={
    "TestApplyVocabPlacement": ["test_doc_signature_from_raw_matches_legacy"],
}, rewrites=ON_CPU)
mirror_tests(globals(), "vocab_auto", "integration/test_vocab_auto.py",
             rewrites=ON_CPU)


def test_the_mirrored_tests_ran_against_the_port():
    from cadence_rag_tpu_torch.core import vocab
    from cadence_rag_tpu_torch.ingest import featurize

    for stem in ("lex_vocab", "vocab_auto"):
        mod = sys.modules[f"{__name__}.{stem}"]
        assert mod.vocab_mod is vocab and mod.featurize is featurize


# -- both packages on the same inputs ----------------------------------------------
TEXTS = [
    "the ECONNRESET fix landed in v2.3.1 after a long rollback debate",
    "object store tiering to SSD approved by the platform team",
    "retry storms caused the ECONNRESET cascade in the gateway",
    "", "   ", "Ünïcode tëxt — with dashes",
]


def _vocab(seed, head, texts=TEXTS):
    """A seeded head: half real feature hashes of ``texts``, half random."""
    rng = np.random.default_rng(seed)
    real = np.concatenate([JAX.hashing.raw_feature_arrays(t)[0] for t in texts])
    take = rng.choice(real, size=min(head // 2, real.size), replace=False)
    rand = rng.integers(0, 2**63, size=head - take.size, dtype=np.uint64)
    return np.unique(np.concatenate([take, rand]))


@pytest.mark.parametrize("dim,head", [(64, 8), (1024, 256), (4096, 2048)])
def test_placement_matches(dim, head):
    """``apply_vocab`` and the ``*_from_raw`` functions, with and without a
    vocab: the JAX package's arrays bit for bit (and its legacy
    ``doc_signature`` without one)."""
    vocab = _vocab(dim, head)
    rng = np.random.default_rng(dim)
    hashes = np.concatenate(
        [vocab[:: max(1, vocab.size // 16)],
         rng.integers(0, 2**63, size=200, dtype=np.uint64)])
    for v in (None, vocab, np.zeros(0, np.uint64)):
        for got, want in zip(PORT.hashing.apply_vocab(hashes, dim, v),
                             JAX.hashing.apply_vocab(hashes, dim, v)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        for text in TEXTS:
            raw = JAX.hashing.raw_feature_arrays(text)
            for got, want in zip(
                    PORT.hashing.doc_signature_from_raw(*raw, dim, 11.0, v),
                    JAX.hashing.doc_signature_from_raw(*raw, dim, 11.0, v)):
                np.testing.assert_array_equal(got, want)
            for got, want in zip(
                    PORT.hashing.query_feature_arrays_from_raw(*raw, dim, v),
                    JAX.hashing.query_feature_arrays_from_raw(*raw, dim, v)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    for text in TEXTS:
        for got, want in zip(
                PORT.hashing.doc_signature_from_raw(
                    *PORT.hashing.raw_feature_arrays(text), dim, 40.0),
                JAX.hashing.doc_signature(text, dim, 40.0)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        PORT.hashing.apply_vocab(hashes, head, np.arange(head, dtype=np.uint64))
    assert PORT.hashing.TECH_LAYOUT_VERSION == JAX.hashing.TECH_LAYOUT_VERSION


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_featurize_with_a_vocab_matches(port_store, monkeypatch, native):
    """The registry takes the JAX package's vocab array as it is; with it
    active every entry point gives the JAX package's bits, whichever
    featurizer the port runs."""
    if not native:
        monkeypatch.setattr(port_lexhash, "available", lambda: False)
    vocab = _vocab(3, 256)
    JAX.featurize.set_active_vocab(vocab, 7)
    PORT.featurize.set_active_vocab(JAX.featurize.active_vocab()[0], 7)
    try:
        got_v, got_n = PORT.featurize.active_vocab()
        np.testing.assert_array_equal(got_v, JAX.featurize.active_vocab()[0])
        assert got_n == 7 and got_v.dtype == np.uint64
        texts = TEXTS + [f"incident {i} on broker-{i} v3.{i}.7" for i in range(20)]
        for got, want in zip(PORT.featurize.lexical_signatures_batch(texts, 9.0),
                             JAX.featurize.lexical_signatures_batch(texts, 9.0)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for got, want in zip(PORT.featurize.query_lexical_features_batch(texts),
                             JAX.featurize.query_lexical_features_batch(texts)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        for text in texts[:8]:
            for g, w in zip(PORT.featurize.lexical_signature(text, 9.0),
                            JAX.featurize.lexical_signature(text, 9.0)):
                np.testing.assert_array_equal(g, w)
            for g, w in zip(PORT.featurize.query_lexical_features(text),
                            JAX.featurize.query_lexical_features(text)):
                np.testing.assert_array_equal(g, w)
        # unsorted input with a repeat is sorted and deduplicated, a head as
        # wide as the signature is refused, None clears
        PORT.featurize.set_active_vocab(np.array([9, 3, 3, 5], np.uint64), 2)
        np.testing.assert_array_equal(PORT.featurize.active_vocab()[0], [3, 5, 9])
        with pytest.raises(ValueError, match="smaller than"):
            PORT.featurize.set_active_vocab(np.arange(1024, dtype=np.uint64), 3)
        PORT.featurize.set_active_vocab(None, 5)
        assert PORT.featurize.active_vocab() == (None, 0)
    finally:
        for pkg in BOTH:
            pkg.featurize.set_active_vocab(None, 0)


def _lex_state(pkg):
    index = pkg.index.get_index()
    out = {}
    for name in ("chunks", "artifact_chunks"):
        corpus = index.corpus(name)
        arrays = corpus.state_arrays()
        out[name] = (arrays["lex"], arrays["doc_freq"], arrays["dl_sum"],
                     arrays["ids"])
    with pkg.db.get_store().read() as conn:
        out["blobs"] = [
            (r["chunk_id"], bytes(r["lex_sig"]), r["lex_dl"], r["lex_vocab_version"])
            for r in conn.execute(
                "SELECT chunk_id, lex_sig, lex_dl, lex_vocab_version "
                "FROM chunks ORDER BY chunk_id")]
    return out


def _assert_same_lex_state(got, want):
    for name in ("chunks", "artifact_chunks"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)
    assert got["blobs"] == want["blobs"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_build_and_apply_matches(port_store, monkeypatch, native):
    """Learn and apply a head over the same corpus in both packages: the
    same hashes, summary, re-scattered ``lex`` rows, df tables and store
    blobs; the same answers afterwards; and a restart that activates the
    store's vocab rebuilds the same rows."""
    if not native:
        monkeypatch.setattr(port_lexhash, "available", lambda: False)
    for pkg in BOTH:
        ingest_corpus(pkg)
    learned = [pkg.vocab.build_vocab_from_store(pkg.db.get_store(), 64)
               for pkg in BOTH]
    np.testing.assert_array_equal(learned[1], learned[0])
    assert learned[1].dtype == np.uint64 and learned[1].size == 64
    before = _lex_state(PORT)
    summaries = [pkg.vocab.build_and_apply(
        pkg.db.get_store(), pkg.index.get_index(), head=64) for pkg in BOTH]
    assert summaries[1] == summaries[0]
    assert summaries[1]["version"] == 1 and summaries[1]["head"] == 64
    np.testing.assert_array_equal(PORT.featurize.active_vocab()[0],
                                  JAX.featurize.active_vocab()[0])
    after = _lex_state(PORT)
    _assert_same_lex_state(after, _lex_state(JAX))
    assert not np.array_equal(after["chunks"][0], before["chunks"][0])
    for body in ({"query": "ECONNRESET object store errors", "debug": True},
                 {"query": "kafka consumer lag rebalance", "return_style": "ids_only"}):
        assert_same_response(
            PORT.retrieve.retrieve_evidence(PORT.request(body)),
            JAX.retrieve.retrieve_evidence(JAX.request(body)))
    stats = [pkg.vocab.drift_stats(pkg.index.get_index().chunks,
                                   pkg.featurize.active_vocab()[0]) for pkg in BOTH]
    assert stats[1] == stats[0]
    assert (PORT.vocab.vocab_digest(learned[1])
            == JAX.vocab.vocab_digest(learned[0]) != "")
    # a restart: startup activates the store's vocab before it rebuilds
    PORT.index.reset_index()
    assert PORT.featurize.active_vocab() == (None, 0)
    PORT.api.startup("cpu")
    assert PORT.featurize.active_vocab()[1] == 1
    _assert_same_lex_state(_lex_state(PORT), after)
    stats = PORT.api.index_stats_endpoint(None)[1]["chunks"]["lex_vocab"]
    assert stats["version"] == 1 and stats["head"] == 64


def test_a_store_the_jax_package_applied_opens_in_the_port(port_store, tmp_path):
    """A store file whose vocab the JAX package's ``build_and_apply`` built
    is served by the port: startup activates it and the rows rebuilt from
    its blobs are the JAX index's."""
    import shutil

    ingest_corpus(JAX)
    JAX.vocab.build_and_apply(JAX.db.get_store(), JAX.index.get_index(), head=48)
    want = _lex_state(JAX)
    JAX.db.get_store().close()
    shutil.copy(JAX.settings.store_path, port_store.store_path)
    PORT.db.reset_store()
    PORT.index.reset_index()
    PORT.api.startup("cpu")
    np.testing.assert_array_equal(PORT.featurize.active_vocab()[0],
                                  JAX.featurize.active_vocab()[0])
    _assert_same_lex_state(_lex_state(PORT), want)
    # the worker activates it too, and a dangling unapplied row is refused
    assert PORT.vocab.activate_from_store(PORT.db.get_store()) == 1
    PORT.vocab.save_vocab(PORT.db.get_store(), np.arange(1, 9, dtype=np.uint64), 1024)
    with pytest.raises(RuntimeError, match="never completed"):
        PORT.vocab.load_vocab(PORT.db.get_store())
