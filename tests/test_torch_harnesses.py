"""The measurement harnesses, JAX package vs port, on the CPU, at a small
size: ``evals/serve_bench.py``, ``evals/ingest_bench.py``,
``evals/host_profile.py`` and ``evals/fullstack_profile.py``.

Each package runs the harness on the same arguments; the port's on
``device="cpu"`` (``--device cpu``). Their reports carry the same JSON keys
and equal deterministic fields (row and call counts, the rows embedded);
host_profile prints the same sections (setup, compile+first, the engine's
timings_ms with the same stages, the profiled iterations, top by cumulative
and by tottime); fullstack_profile's own copy of ``bench.setup_index``
leaves the index as the JAX bench's does: the same capacities, array shapes
and storage widths, ids, embedded rows, lexical statistics (seeded numpy
draws, equal) and settings, and the same store rows. The synthetic row
values come from each package's own generator (``jax.random``, a
``torch.Generator``) and are not compared. Without a card each port CLI
raises instead of running on the CPU.
"""

import json
import re
import sys

import numpy as np
import pytest
import torch

from torch_parity import (
    JAX,
    PORT,
    port_store,  # noqa: F401  (fixture)
    set_both,  # noqa: F401  (fixture)
)

SERVE = dict(n_chunks=3000, batch=8, iters=3)
HOST_ARGS = ["--chunks", "3000", "--batch", "8", "--iters", "2",
             "--lex-dim", "1024", "--top", "5"]
FULLSTACK_ARGS = ["--n", "3000", "--batch", "8", "--iters", "2",
                  "--trials", "1", "--lex-dim", "1024"]


@pytest.fixture()
def small(port_store, set_both, monkeypatch):
    """Both packages at the conftest widths (64-d, 1024-wide signatures).
    The harnesses set settings they do not restore (the JAX package's
    host_profile and bench do not): every field of both is restored after
    the test."""
    import dataclasses

    for pkg in (JAX, PORT):
        for field in dataclasses.fields(pkg.settings):
            monkeypatch.setattr(pkg.settings, field.name,
                                getattr(pkg.settings, field.name))
    set_both("store_sync_interval_s", 0.0)
    return port_store


def _modules(name):
    import importlib

    return (importlib.import_module(f"cadence_rag_tpu.evals.{name}"),
            importlib.import_module(f"cadence_rag_tpu_torch.evals.{name}"))


@pytest.mark.parametrize("style,threads,ingest", [
    ("ids_only", 1, False),
    ("evidence_pack_json", 2, False),
    ("ids_only", 1, True),
])
def test_serve_bench_reports_match(small, style, threads, ingest):
    jax_mod, port_mod = _modules("serve_bench")
    kw = dict(SERVE, style=style, threads=threads, concurrent_ingest=ingest,
              ingest_rate_rows_s=500.0 if ingest else 0.0)
    jax_out = jax_mod.run_serve_bench(**kw)
    port_out = port_mod.run_serve_bench(device="cpu", **kw)
    assert port_out.keys() == jax_out.keys()
    for key in ("chunks", "batch", "style", "threads"):
        assert port_out.get(key) == jax_out.get(key), key
    assert port_out["qps"] > 0
    if ingest:
        assert port_out["concurrent_inserts"] % 64 == 0


def test_ingest_bench_reports_match(small):
    jax_mod, port_mod = _modules("ingest_bench")
    jax_out = jax_mod.run_ingest_bench(4, 12)
    port_out = port_mod.run_ingest_bench(4, 12, device="cpu")
    assert port_out.keys() == jax_out.keys()
    for key in ("calls", "utterances", "chunks", "embed_rows",
                "device_chunk_count"):
        assert port_out[key] == jax_out[key], key
    assert port_out["embed_rows"] == port_out["device_chunk_count"] > 0


def _sections(text):
    """host_profile's output -> {section: its lines}."""
    out, current = {}, None
    for line in text.splitlines():
        head = re.match(r"(setup|compile\+first|engine timings_ms:|profiled"
                        r"|===== top by \w+ =====)", line)
        if head:
            current = head.group(1)
            out[current] = [line]
        elif current is not None and line.strip():
            out[current].append(line)
    return out


def test_host_profile_prints_the_same_sections(small, monkeypatch, capsys):
    jax_mod, port_mod = _modules("host_profile")
    monkeypatch.setattr(sys, "argv", ["host_profile", *HOST_ARGS])
    jax_mod.main()
    jax_text = capsys.readouterr().out
    port_mod.main([*HOST_ARGS, "--device", "cpu"])
    port_text = capsys.readouterr().out
    jax_sec, port_sec = _sections(jax_text), _sections(port_text)
    assert list(port_sec) == list(jax_sec) == [
        "setup", "compile+first", "engine timings_ms:", "profiled",
        "===== top by cumulative =====", "===== top by tottime ====="]
    timings = [json.loads(sec["engine timings_ms:"][0].split(":", 1)[1])
               for sec in (jax_sec, port_sec)]
    assert timings[1].keys() == timings[0].keys()
    for sort in ("cumulative", "tottime"):
        lines = port_sec[f"===== top by {sort} ====="]
        assert "ncalls" in lines[1] and len(lines) == 2 + 5


def test_fullstack_setup_index_matches_the_bench(small):
    import bench

    from cadence_rag_tpu_torch.evals.fullstack_profile import _setup_index

    n, lex_dim = 3000, 1024
    jax_index, jax_dir = bench.setup_index(n, lex_dim)
    port_index, port_dir = _setup_index(n, lex_dim, "cpu")
    try:
        for name in ("prewarm_growth_enabled", "rerank_enabled", "lexical_dim",
                     "index_initial_capacity", "embeddings_provider"):
            assert getattr(PORT.settings, name) == getattr(JAX.settings, name), name
        assert PORT.settings.prewarm_growth_enabled is False
        assert port_index.call_capacity == jax_index.call_capacity
        for attr in ("chunks", "artifacts"):
            j, p = getattr(jax_index, attr), getattr(port_index, attr)
            assert (p.count, p.capacity, p.dim, p.lex_dim, p.tech_slots) == \
                (j.count, j.capacity, j.dim, j.lex_dim, j.tech_slots), attr
            for arr in ("emb", "lex", "tech", "call_idx", "started", "has_emb"):
                assert tuple(getattr(p, arr).shape) == tuple(getattr(j, arr).shape)
            for mirror in ("h_ids", "h_has_emb", "doc_freq"):
                np.testing.assert_array_equal(getattr(p, mirror), getattr(j, mirror))
            assert (p.dl_sum, p.emb_rows, p.tombstones) == \
                (j.dl_sum, j.emb_rows, j.tombstones)
            np.testing.assert_array_equal(
                np.asarray(j.has_emb), p.has_emb.numpy())
        for table in ("calls", "chunks", "artifact_chunks"):
            counts = [_count(pkg, table) for pkg in (JAX, PORT)]
            assert counts[0] == counts[1] > 0, table
    finally:
        import shutil

        shutil.rmtree(jax_dir, ignore_errors=True)
        shutil.rmtree(port_dir, ignore_errors=True)


def _count(pkg, table):
    with pkg.db.get_store().read() as conn:
        return conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]


def test_fullstack_profile_reports_match(small, monkeypatch, capsys):
    jax_mod, port_mod = _modules("fullstack_profile")
    import bench  # noqa: F401  (the JAX harness imports it from the root)

    monkeypatch.setattr(sys, "argv", ["fullstack_profile", *FULLSTACK_ARGS])
    jax_mod.main()
    jax_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port_mod.main([*FULLSTACK_ARGS, "--device", "cpu"])
    port_out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_out.keys() == jax_out.keys()
    for key in ("n", "batch", "iters"):
        assert port_out[key] == jax_out[key]
    tl = port_out["timeline_rrf_on_d3"]
    assert tl.keys() == jax_out["timeline_rrf_on_d3"].keys()
    assert tl["device_ms_p50"] > 0 and len(tl["per_batch"]) == 12
    assert PORT.settings.device_rrf_enabled is True


@pytest.mark.parametrize("name,argv", [
    ("serve_bench", ["serve_bench", "--chunks", "64"]),
    ("ingest_bench", ["ingest_bench", "--calls", "1"]),
    ("host_profile", None),
    ("fullstack_profile", None),
])
def test_the_clis_need_a_card(small, monkeypatch, name, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _jax_mod, port_mod = _modules(name)
    with pytest.raises(RuntimeError, match="cuda"):
        if argv is None:
            port_mod.main(["--chunks" if name == "host_profile" else "--n", "64"])
        else:
            monkeypatch.setattr(sys, "argv", argv)
            port_mod.main()
