"""Index checkpoints, JAX package vs port, on the CPU.

``tests/integration/test_checkpoint.py`` runs against the port as it stands
(``torch_parity.mirror_tests``, the index on the CPU) but for one test that
reads the restored rows through ``np.asarray(..., dtype=float32)``, which a
bf16 tensor does not offer; ``test_int8_checkpoint_restores_under_bf16``
holds the same thing. Then the format, both ways, on the same ingested
corpus: a directory the JAX package saved restores in the port and one the
port saved restores in the JAX package, bf16 and int8 rows, with and
without a lexical vocab, state arrays bit-equal and the answers identical;
a v1 directory and a hand-made v3 (multi-host) directory restore in both;
the port's v3 writer (a gang's save, here over a one-process mesh of four
shards) writes a directory both packages restore to the saved state; the
snapshot CLI round-trips on
``--device cpu``; and startup's digest check of a restored index against
the store passes or raises as the JAX package's does.
"""

import json
import sys

import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.utils import events
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


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_tests(globals(), "checkpoint", "integration/test_checkpoint.py", drop={
    "TestCheckpoint": ["test_int8_checkpoint_restores_under_float_dtype"],
}, rewrites=ON_CPU)


def test_the_mirrored_tests_ran_against_the_port():
    from cadence_rag_tpu_torch.core import checkpoint

    mod = sys.modules[f"{__name__}.checkpoint"]
    assert mod.save_index is checkpoint.save_index


def _bits(emb):
    """Embedding rows as comparable integers: bf16 through its 16 bits."""
    if isinstance(emb, torch.Tensor):
        emb = emb.view(torch.int16).numpy() if emb.dtype == torch.bfloat16 else emb.numpy()
    if emb.dtype.itemsize == 2:
        return emb.view(np.int16)
    return emb


def assert_same_index(port_index, jax_index):
    """Both corpora: rows bit-equal (bf16 by its bits), mirrors, stats and
    counters equal."""
    for name in ("chunks", "artifact_chunks"):
        p, j = port_index.corpus(name), jax_index.corpus(name)
        n = j.count
        assert p.count == n and p.tombstones == j.tombstones
        assert p.emb_rows == j.emb_rows and p.dl_sum == j.dl_sum
        np.testing.assert_array_equal(_bits(p.emb[:n]), _bits(np.asarray(j.emb[:n])))
        for attr in ("lex", "tech", "call_idx", "started", "has_emb"):
            np.testing.assert_array_equal(
                getattr(p, attr)[:n].numpy(), np.asarray(getattr(j, attr)[:n]), attr)
        for attr in ("h_ids", "h_call", "h_started", "h_has_emb"):
            np.testing.assert_array_equal(getattr(p, attr)[:n], getattr(j, attr)[:n])
        np.testing.assert_array_equal(p.doc_freq, j.doc_freq)
        assert p._id_to_pos == j._id_to_pos
    assert port_index.call_capacity == jax_index.call_capacity


BODIES = ({"query": "ECONNRESET object store errors", "debug": True},
          {"query": "kafka consumer lag rebalance", "return_style": "ids_only"})


def _populate(set_both, emb_dtype, vocab):
    """The parity corpus in both packages, a few rows deleted, optionally
    under a learned vocab head."""
    set_both("index_embedding_dtype", emb_dtype)
    for pkg in BOTH:
        pkg.index.reset_index()
    PORT.index.get_index("cpu")
    calls = {pkg.root: ingest_corpus(pkg) for pkg in BOTH}
    if vocab:
        for pkg in BOTH:
            pkg.vocab.build_and_apply(pkg.db.get_store(), pkg.index.get_index(), head=48)
    for pkg in BOTH:
        pkg.ingest.delete_call(calls[pkg.root]["manytok"])
    assert_same_index(PORT.index.get_index(), JAX.index.get_index())


@pytest.mark.parametrize("vocab", [False, True], ids=["plain", "vocab"])
@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_a_directory_either_package_saved_restores_in_the_other(
        port_store, set_both, tmp_path, saver, emb_dtype, vocab):
    _populate(set_both, emb_dtype, vocab)
    src, dst = (JAX, PORT) if saver == "jax" else (PORT, JAX)
    path = str(tmp_path / "ckpt")
    meta = src.checkpoint.save_index(path, src.index.get_index())
    assert meta["format_version"] == 2 and meta["emb_storage_dtype"] == emb_dtype
    assert meta["lex_vocab_version"] == (1 if vocab else 0)
    with np.load(f"{path}/chunks.g0000.0000.npz") as shard:
        assert str(shard["_kind"][0]) == ("bf16" if emb_dtype == "bfloat16" else "i8")
        assert shard["emb"].dtype == (np.uint16 if emb_dtype == "bfloat16" else np.int8)
    want = [src.retrieve.retrieve_evidence(src.request(b)) for b in BODIES]
    # the restoring package starts from nothing: index and vocab cleared
    dst.index.reset_index()
    fresh = dst.index.get_index("cpu") if dst is PORT else dst.index.get_index()
    got_meta = dst.checkpoint.restore_index(path, fresh)
    assert got_meta == json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert_same_index(PORT.index.get_index(), JAX.index.get_index())
    assert dst.featurize.active_vocab()[1] == (1 if vocab else 0)
    if vocab:
        np.testing.assert_array_equal(dst.featurize.active_vocab()[0],
                                      src.featurize.active_vocab()[0])
    for body, w in zip(BODIES, want):
        got = dst.retrieve.retrieve_evidence(dst.request(body))
        assert_same_response(*((got, w) if dst is PORT else (w, got)))
    # the restored index goes on: both take the same insert and save again
    for pkg in BOTH:
        pkg.ingest.ingest_transcript(
            pkg.schemas.CallRef(external_id="after"),
            [pkg.schemas.UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                                     text="restored index takes the ECONNRESET row")],
            pkg.schemas.ChunkingOptions(target_tokens=10, max_tokens=30,
                                        overlap_tokens=0))
    assert_same_index(PORT.index.get_index(), JAX.index.get_index())
    assert dst.checkpoint.save_index(path, dst.index.get_index())["generation"] == 1


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_v1_and_v3_directories_restore_in_both(port_store, set_both, tmp_path, emb_dtype):
    """A v1 directory (one f32 npz a corpus) and a v3 directory (the
    multi-host layout: heavy row blocks by start row, scalars beside them),
    written by hand from the JAX index's state: both packages restore the
    same index from each."""
    _populate(set_both, emb_dtype, vocab=False)
    jax_index = JAX.index.get_index()
    states = {c.name: c.state_arrays() for c in (jax_index.chunks, jax_index.artifacts)}
    base = {"tech_layout": JAX.hashing.TECH_LAYOUT_VERSION, "embeddings_dim": 64,
            "lexical_dim": 1024, "tech_hash_slots": 16, "call_capacity": 256,
            "counts": {k: int(v["ids"].shape[0]) for k, v in states.items()}}
    v1 = tmp_path / "v1"
    v1.mkdir()
    for name, st in states.items():
        arrays = dict(st)
        if emb_dtype == "bfloat16":
            arrays["emb"] = np.asarray(arrays["emb"], dtype=np.float32)
        np.savez(v1 / f"{name}.npz", **arrays)
    (v1 / "meta.json").write_text(json.dumps({"format_version": 1, **base}))
    v3 = tmp_path / "v3"
    v3.mkdir()
    heavy = {}
    for name, st in states.items():
        n = st["ids"].shape[0]
        cuts = [0, n // 3, n]
        heavy[name] = []
        for lo, hi in zip(cuts, cuts[1:]):
            payload = {"lex": st["lex"][lo:hi], "tech": st["tech"][lo:hi],
                       "start": np.array([lo], dtype=np.int64)}
            payload.update(JAX.checkpoint._encode_emb(st["emb"][lo:hi]))
            fname = f"{name}.g0002.r{lo:010d}.npz"
            np.savez(v3 / fname, **payload)
            heavy[name].append(fname)
        np.savez(v3 / f"{name}.g0002.scalars.npz",
                 **{k: st[k] for k in ("ids", "call", "started", "has_emb")})
        np.savez(v3 / f"{name}.g0002.stats.npz", doc_freq=st["doc_freq"],
                 dl_sum=st["dl_sum"])
    (v3 / "meta.json").write_text(json.dumps({
        "format_version": 3, "generation": 2, "heavy_files": heavy,
        "lex_vocab_version": 0, **base}))
    for path in (v1, v3):
        for pkg in BOTH:
            pkg.index.reset_index()
        PORT.checkpoint.restore_index(str(path), PORT.index.get_index("cpu"))
        JAX.checkpoint.restore_index(str(path), JAX.index.get_index())
        assert_same_index(PORT.index.get_index(), JAX.index.get_index())
        assert PORT.index.get_index().chunks.count == base["counts"]["chunks"] > 0
    # a v3 file out of row order is refused
    bad = json.loads((v3 / "meta.json").read_text())
    bad["heavy_files"]["chunks"] = bad["heavy_files"]["chunks"][1:]
    (v3 / "meta.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="not contiguous"):
        PORT.checkpoint.restore_index(str(v3), PORT.index.get_index())


def test_saving_v3_raises_naming_its_item(port_store, set_both, tmp_path, monkeypatch):
    """Saving format v3 no longer raises: the gang's writer, over a mesh of
    four shards in one process, writes a row block a shard that holds rows,
    its layout the shards' own, and ``_save_index_multihost`` writes a
    directory both packages restore to the state the port saved."""
    _populate(set_both, "bfloat16", vocab=False)
    monkeypatch.setattr(PORT.settings, "mesh_shape", "data:4")
    PORT.index.reset_index()
    index = PORT.index.get_index("cpu")
    PORT.ingest.rebuild_index_from_store()
    chunks = index.chunks
    rows = chunks.shard_rows
    layout = PORT.checkpoint._heavy_layout(chunks)
    assert layout == [(s * rows, min(rows, chunks.count - s * rows))
                      for s in range(-(-chunks.count // rows))]
    names = PORT.checkpoint.write_local_heavy_shards(
        chunks, str(tmp_path / "blocks"), 0, chunks.count)
    assert names == [f"chunks.g0000.r{start:010d}.npz" for start, _ in layout]
    meta = PORT.checkpoint._save_index_multihost(str(tmp_path / "v3"), index)
    assert meta["format_version"] == 3
    assert meta["heavy_files"]["chunks"] == names
    want = {c.name: c.state_arrays() for c in (index.chunks, index.artifacts)}
    PORT.index.reset_index()
    JAX.index.reset_index()
    monkeypatch.setattr(PORT.settings, "mesh_shape", "")
    restored = [PORT.index.get_index("cpu"), JAX.index.get_index()]
    PORT.checkpoint.restore_index(str(tmp_path / "v3"), restored[0])
    JAX.checkpoint.restore_index(str(tmp_path / "v3"), restored[1])
    assert_same_index(*restored)
    for name, state in want.items():
        got = restored[0].corpus(name).state_arrays()
        for key, value in state.items():
            np.testing.assert_array_equal(got[key], value, err_msg=f"{name} {key}")


def test_int8_checkpoint_restores_under_bf16(port_store, set_both, tmp_path):
    """int8 rows restored under a bf16 index are dequantized (x/127), not
    cast; bf16 rows restored under int8 are quantized: in both packages."""
    _populate(set_both, "int8", vocab=False)
    path = str(tmp_path / "i8")
    PORT.checkpoint.save_index(path, PORT.index.get_index())
    set_both("index_embedding_dtype", "bfloat16")
    for pkg in BOTH:
        pkg.index.reset_index()
    PORT.checkpoint.restore_index(path, PORT.index.get_index("cpu"))
    JAX.checkpoint.restore_index(path, JAX.index.get_index())
    assert_same_index(PORT.index.get_index(), JAX.index.get_index())
    chunks = PORT.index.get_index().chunks
    assert chunks.emb.dtype == torch.bfloat16
    norms = chunks.emb[: chunks.count][chunks.has_emb[: chunks.count]].float().norm(dim=1)
    assert float(norms.min()) > 0.9 and float(norms.max()) < 1.1
    path2 = str(tmp_path / "bf16")
    JAX.checkpoint.save_index(path2, JAX.index.get_index())
    set_both("index_embedding_dtype", "int8")
    for pkg in BOTH:
        pkg.index.reset_index()
    PORT.checkpoint.restore_index(path2, PORT.index.get_index("cpu"))
    JAX.checkpoint.restore_index(path2, JAX.index.get_index())
    assert_same_index(PORT.index.get_index(), JAX.index.get_index())
    assert PORT.index.get_index().chunks.emb.dtype == torch.int8


def test_snapshot_moves_the_stored_bits_and_times_its_lock(port_store, set_both, tmp_path):
    """``checkpoint_arrays`` hands out bf16 rows as uint16 (never widened),
    copies that later writes do not change, and records how long the corpus
    lock was held; a background save writes the snapshot it took."""
    _populate(set_both, "bfloat16", vocab=False)
    chunks = PORT.index.get_index().chunks
    events.enable()
    try:
        snap = chunks.checkpoint_arrays()
        spans = [e for e in events.drain() if e["tag"] == "index.checkpoint_snapshot"]
    finally:
        events.disable()
    assert len(spans) == 1 and spans[0]["rows"] == chunks.count
    assert snap["emb"].dtype == np.uint16 and snap["emb"].shape == (chunks.count, 64)
    np.testing.assert_array_equal(
        snap["emb"].view(np.int16), chunks.emb[: chunks.count].view(torch.int16).numpy())
    wide = chunks.state_arrays()
    assert wide["emb"].dtype == np.float32 and wide.keys() == snap.keys()
    before = snap["lex"].copy()
    meta = PORT.checkpoint.save_index(str(tmp_path / "bg"), block=False)
    chunks.set_lex(list(chunks._id_to_pos)[:3], np.full((3, 1024), 7, np.int8))
    meta["_writer"].join(30)
    np.testing.assert_array_equal(snap["lex"], before)
    PORT.index.reset_index()
    PORT.checkpoint.restore_index(str(tmp_path / "bg"), PORT.index.get_index("cpu"))
    np.testing.assert_array_equal(
        PORT.index.get_index().chunks.lex[: before.shape[0]].numpy(), before)


def test_snapshot_cli_roundtrip_on_the_cpu(port_store, tmp_path, monkeypatch):
    """``scripts/index_snapshot`` save and restore with ``--device cpu``;
    without a card its default device raises."""
    from cadence_rag_tpu_torch.scripts.index_snapshot import main

    ingest_corpus(PORT)
    snap = str(tmp_path / "snap")
    monkeypatch.setattr(sys, "argv", ["index_snapshot", "save", snap, "--device", "cpu"])
    main()
    count = PORT.index.get_index().chunks.count
    PORT.index.reset_index()
    monkeypatch.setattr(sys, "argv", ["index_snapshot", "restore", snap, "--device", "cpu"])
    main()
    assert PORT.index.get_index().chunks.count == count > 0
    PORT.index.reset_index()
    monkeypatch.setattr(sys, "argv", ["index_snapshot", "restore", snap])
    with pytest.raises(RuntimeError, match="[Cc][Uu][Dd][Aa]"):
        main()


@pytest.mark.parametrize("vocab", [False, True], ids=["plain", "vocab"])
def test_startup_checks_a_restored_index_against_the_store(
        port_store, set_both, tmp_path, vocab):
    """A restored index starts only against a store with the same vocab
    (compared by content); it is then reconciled, not rebuilt."""
    _populate(set_both, "bfloat16", vocab)
    path = str(tmp_path / "ckpt")
    PORT.checkpoint.save_index(path)
    PORT.index.reset_index()
    PORT.checkpoint.restore_index(path, PORT.index.get_index("cpu"))
    PORT.api.startup("cpu")
    assert PORT.featurize.active_vocab()[1] == (1 if vocab else 0)
    # the store's vocab moves on: the same checkpoint no longer starts
    PORT.vocab.build_and_apply(PORT.db.get_store(), PORT.index.get_index(), head=32)
    PORT.index.reset_index()
    PORT.checkpoint.restore_index(path, PORT.index.get_index("cpu"))
    with pytest.raises(RuntimeError, match="restored index carries lex vocab"):
        PORT.api.startup("cpu")
