"""The generators: queries, rows and texts, the same from the same seed,
every seed drawing the same sizes of work; and the bulk loader."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rag_bench import load
from rag_bench.spec import load_cell
from rag_bench.traffic import corpus as gen
from rag_bench.traffic import idents, texts
from rag_bench.traffic.queries import body, make_queries


@pytest.mark.parametrize("name", ["msmarco-8m.ids",
                                  "cadence-1m.packs"])
def test_queries_are_the_seeds_and_unique(name, tiny_root):
    cell = load_cell(name, tiny_root)
    a = make_queries(cell.traffic, cell.config, 2**31 + 11, 3000)
    assert a == make_queries(cell.traffic, cell.config, 2**31 + 11, 3000)
    b = make_queries(cell.traffic, cell.config, -5, 3000)
    assert a != b and len({t for t, _ in a}) == 3000
    lo, hi = cell.traffic["words"]
    for qs in (a, b):
        words = np.array([len(t.split()) for t, _ in qs])
        assert words.min() >= lo
    # the seed moves which queries, not how large they are
    assert abs(np.mean([len(t) for t, _ in a]) - np.mean([len(t) for t, _ in b])) < 1.5
    scoped = cell.traffic["scope"] == "one_call"
    assert all((c is not None) == scoped for _, c in a)
    assert ("filters" in body(cell.traffic, a[0])) == scoped


def test_queries_carry_the_deployments_identifiers(tiny_root):
    from rag_bench.reference.features import tech_tokens

    cell = load_cell("cadence-1m.packs", tiny_root)
    names = set(idents.identifiers(cell.config))
    qs = make_queries(cell.traffic, cell.config, 9, 2000)
    found = [tech_tokens(t) for t, _ in qs]
    assert all(set(f) <= names for f in found)
    share = np.mean([bool(f) for f in found])
    assert abs(share - sum(cell.traffic["identifier_share"])) < 0.05


def test_blocks_are_the_seeds_and_stand_alone(tiny_root):
    config = dict(load_cell("tiny.ids", tiny_root).config, chunks_rows=140000)
    one = gen.make_block(config, "chunks", 77, 1, "cpu")
    gen.make_block(config, "chunks", 77, 0, "cpu")
    again = gen.make_block(config, "chunks", 77, 1, "cpu")
    other = gen.make_block(config, "chunks", 78, 1, "cpu")
    for key in one:
        assert torch.equal(one[key], again[key])
        assert not torch.equal(one[key], other[key])
    assert one["emb"].dtype == torch.bfloat16
    norms = torch.linalg.vector_norm(one["emb"].float(), dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-2)
    nonzero = (one["lex"] != 0).float().mean().item()
    assert one["emb"].shape[0] == 140000 - gen.BLOCK_ROWS
    assert abs(nonzero - config["lexical_nonzero_share"]) < 0.01


def test_tech_slots_are_placed_as_ingest_places_them(tiny_root):
    """Each row's slots equal what the program's ingest writes for its
    identifiers in the order they were drawn (two-choice placement, repeats
    left out)."""
    from itertools import permutations

    from cadence_rag_tpu_torch.ops.hashing import tech_token_hashes

    cell = load_cell("tiny.ids", tiny_root)
    made = gen.make_block(cell.config, "artifacts", 5, 0, "cpu")["tech"].numpy()
    table = {int(h): name for name, h in zip(idents.identifiers(cell.config),
                                             idents.hashes(cell.config))}
    held = 0
    for row in made[:3000]:
        names = [table[int(h)] for h in row if h]
        held += len(names)
        assert any((tech_token_hashes(list(order), cell.config["tech_slots"])
                    == row).all() for order in permutations(names))
    assert held > 1000


def test_rows_are_written_into_the_programs_store(tmp_path, tiny_root):
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.store.db import get_store, reset_store

    config = dict(load_cell("tiny.scoped", tiny_root).config,
                  chunks_rows=3000, artifacts_rows=500)
    saved = settings.store_path
    settings.store_path = str(tmp_path / "s.db")
    try:
        reset_store()
        get_store()
        reset_store()
        load.write_store(settings.store_path, config, 3, rows=True)
        with get_store().read() as conn:
            assert conn.execute("SELECT COUNT(*) FROM chunks").fetchone()[0] == 3000
            assert conn.execute("SELECT COUNT(*) FROM artifact_chunks").fetchone()[0] == 500
            text, call, n, dl = conn.execute(
                "SELECT text, call_id, token_count, lex_dl FROM chunks"
                " WHERE chunk_id = 2000").fetchone()
            assert text == texts.chunk_text(3, 1999)
            assert n == dl == texts.tokens(3, "chunks", [1999])[0]
            # the upstream chunker's sizes: a 350-token target, at most 600
            sizes = conn.execute("SELECT MIN(token_count), AVG(token_count),"
                                 " MAX(token_count), AVG(LENGTH(text)) FROM chunks").fetchone()
            assert 300 <= sizes[0] and 330 <= sizes[1] <= 400 and sizes[2] <= 600
            assert 1300 <= sizes[3] <= 2000
            content, n = conn.execute(
                "SELECT content, token_count FROM artifact_chunks"
                " WHERE artifact_chunk_id = 7").fetchone()
            assert content == texts.artifact_text(3, 6)
            assert n == texts.tokens(3, "artifacts", [6])[0]
            seq = conn.execute("SELECT call_seq FROM calls WHERE call_id = ?",
                               (call,)).fetchone()[0]
            assert seq == 1999 * config["calls"] // 3000
    finally:
        reset_store()
        settings.store_path = saved
