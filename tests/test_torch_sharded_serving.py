"""Mesh-sharded serving in one process, the port against itself and
against the JAX package, on the CPU: the counterpart of
tests/integration/test_sharded_serving.py.

With ``MESH_SHAPE=data:8`` the port's index holds eight shards on the CPU
(the JAX package's, on conftest's eight virtual devices) and the same
engine path serves. Its answers must be the port's unsharded index's, and
the JAX package's sharded engine's on the same store: ``retrieved_ids``
identical (the lanes' scores are exact f32 sums over bf16 rows; the
planner serves this corpus ``exact``). Then IVF built over the shards, the
filters, a checkpoint round trip and a growth across a doubling, each with
the unsharded index's ids; and with the JAX package's: its sharded IVF
build's state served by the port's shards, and the port's sharded save
restored by the JAX package.
"""

import numpy as np

from torch_parity import BOTH, JAX, PORT, port_store, set_both  # noqa: F401  (fixtures)

TEXTS = [
    "object store ECONNRESET retries on the gateway",
    "lenovo BOM pricing for the bake-off",
    "azure migration cutover runbook details",
    "SSD tiering latency improvements on ingest",
    "renewal forecast for the emea region",
    "kubernetes upgrade on the staging cluster",
]
QUERIES = [
    "ECONNRESET object store gateway",
    "lenovo bake-off pricing",
    "kubernetes staging upgrade",
]


def _populate(pkg, copies=3):
    s = pkg.schemas
    opts = s.ChunkingOptions(target_tokens=8, max_tokens=20, overlap_tokens=0)
    for i, t in enumerate(TEXTS * copies):
        pkg.ingest.ingest_transcript(
            s.CallRef(external_id=f"shard-{i}"),
            [s.UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                           text=f"{t} variant {i}")], opts)
    pkg.pipeline.run_embedding_backfill(batch_size=8)


def _ids(pkg, queries=QUERIES, **extra):
    return [pkg.retrieve.retrieve_evidence(pkg.request(
        {"query": q, "return_style": "ids_only", **extra}))["retrieved_ids"]
        for q in queries]


def _reshard(monkeypatch, shape):
    monkeypatch.setattr(PORT.settings, "mesh_shape", shape)
    PORT.index.reset_index()
    index = PORT.index.get_index("cpu")
    PORT.ingest.rebuild_index_from_store()
    return index


def test_sharded_results_match_unsharded(port_store, monkeypatch):
    _populate(PORT)
    baseline = _ids(PORT)
    index = _reshard(monkeypatch, "data:8")
    assert index.mesh is not None and index.chunks.n_shards == 8
    # the rows really are spread over eight shards of 32 rows
    assert sorted(index.chunks._shards) == list(range(8))
    assert {bufs[0].shape[0] for bufs in index.chunks._shards.values()} == {32}
    assert _ids(PORT) == baseline


def test_sharded_results_match_the_jax_package(port_store, monkeypatch):
    for pkg in BOTH:
        monkeypatch.setattr(pkg.settings, "mesh_shape", "data:8")
        pkg.index.reset_index()
    PORT.index.get_index("cpu")
    for pkg in BOTH:
        _populate(pkg)
    assert JAX.index.get_index().mesh is not None
    assert PORT.index.get_index().mesh is not None
    assert _ids(PORT) == _ids(JAX)


def test_sharded_ivf_matches_unsharded(port_store, monkeypatch):
    monkeypatch.setattr(PORT.settings, "dense_ivf_enabled", True)
    monkeypatch.setattr(PORT.settings, "ivf_min_rows", 1)
    _populate(PORT)
    # a non-empty artifacts corpus keeps the packed path
    PORT.ingest.ingest_analysis(
        PORT.schemas.CallRef(external_id="shard-0"),
        [PORT.schemas.AnalysisArtifactIn(kind="summary",
                                         content="gateway retries summary")])
    flat = PORT.index.get_index()
    built = flat.chunks.build_ivf(n_clusters=4, seed=3)
    assert flat.chunks.ivf_usable()
    baseline = _ids(PORT)
    index = _reshard(monkeypatch, "data:8")
    state = index.chunks.build_ivf(n_clusters=4, seed=3)
    assert index.chunks.ivf_usable() and state.n_clusters == 4
    # the k-means reads every shard: the unsharded build's clusters
    np.testing.assert_array_equal(state.buckets.numpy(), built.buckets.numpy())
    assert _ids(PORT) == baseline
    # the unsharded build's state, carried over, serves the same ids
    index.chunks.load_ivf_state(built)
    assert _ids(PORT) == baseline


def test_sharded_ivf_from_the_jax_package_serves_its_ids(port_store, set_both):
    """The JAX package's sharded engine with its own IVF build, and the
    port's sharded index carrying that state: the same ids."""
    for name, value in (("mesh_shape", "data:8"), ("dense_ivf_enabled", True),
                        ("ivf_min_rows", 1)):
        set_both(name, value)
    for pkg in BOTH:
        pkg.index.reset_index()
    PORT.index.get_index("cpu")
    for pkg in BOTH:
        _populate(pkg)
        pkg.ingest.ingest_analysis(
            pkg.schemas.CallRef(external_id="shard-0"),
            [pkg.schemas.AnalysisArtifactIn(kind="summary",
                                            content="gateway retries summary")])
    state = JAX.index.get_index().chunks.build_ivf(n_clusters=4, seed=3)
    PORT.index.get_index().chunks.load_ivf_state(state)
    assert PORT.index.get_index().chunks.ivf_usable()
    assert _ids(PORT) == _ids(JAX)


def test_sharded_ingest_and_filters(port_store, monkeypatch):
    monkeypatch.setattr(PORT.settings, "mesh_shape", "data:8")
    PORT.index.reset_index()
    PORT.index.get_index("cpu")
    _populate(PORT)
    resp = PORT.retrieve.retrieve_evidence(PORT.request({
        "query": "ECONNRESET object store",
        "filters": {"external_id": "shard-0"}}))
    assert resp["quotes"]
    assert len({q["call_id"] for q in resp["quotes"]}) == 1


def test_checkpoint_roundtrip_with_mesh(port_store, monkeypatch, tmp_path):
    monkeypatch.setattr(PORT.settings, "mesh_shape", "data:8")
    PORT.index.reset_index()
    PORT.index.get_index("cpu")
    _populate(PORT)
    before = _ids(PORT, ["ECONNRESET object store"])
    state = PORT.index.get_index().chunks.state_arrays()
    meta = PORT.checkpoint.save_index(str(tmp_path / "snap"))
    assert meta["format_version"] == 2    # one process saves v2 from its shards
    PORT.index.reset_index()
    index = PORT.index.get_index("cpu")
    PORT.checkpoint.restore_index(str(tmp_path / "snap"), index)
    assert index.mesh is not None and len(index.chunks._shards) == 8
    for key, value in index.chunks.state_arrays().items():
        np.testing.assert_array_equal(value, state[key], err_msg=key)
    assert _ids(PORT, ["ECONNRESET object store"]) == before


def test_growth_across_a_doubling_under_a_mesh(port_store, monkeypatch):
    """Rows ingested one call at a time into 8 shards of 2 rows: the 17th
    doubles the capacity and every row moves to the shard of the doubled
    layout (shard i then owns rows [4i, 4i+4)). The grown corpus equals an
    unsharded index rebuilt from the same store, and answers alike."""
    monkeypatch.setattr(PORT.settings, "index_initial_capacity", 16)
    monkeypatch.setattr(PORT.settings, "mesh_shape", "data:8")
    PORT.index.reset_index()
    index = PORT.index.get_index("cpu")
    _populate(PORT)
    assert index.chunks.capacity == 32 and index.chunks.count == 18
    assert {bufs[0].shape[0] for bufs in index.chunks._shards.values()} == {4}
    sharded_state = index.chunks.state_arrays()
    sharded = _ids(PORT)
    flat = _reshard(monkeypatch, "")
    assert flat.mesh is None and flat.chunks.capacity == 32
    for key, value in flat.chunks.state_arrays().items():
        np.testing.assert_array_equal(sharded_state[key], value, err_msg=key)
    assert _ids(PORT) == sharded


def test_a_sharded_save_restores_in_the_jax_package(port_store, set_both, tmp_path):
    """Both packages sharded over data:8 with the same corpus: the port's v2
    save of its shards, restored by the JAX package, answers with the
    port's ids."""
    set_both("mesh_shape", "data:8")
    for pkg in BOTH:
        pkg.index.reset_index()
    PORT.index.get_index("cpu")
    for pkg in BOTH:
        _populate(pkg)
    before = _ids(PORT)
    PORT.checkpoint.save_index(str(tmp_path / "snap"))
    JAX.index.reset_index()
    JAX.checkpoint.restore_index(str(tmp_path / "snap"))
    assert _ids(JAX) == before
