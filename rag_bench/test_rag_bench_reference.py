"""The plain reference: hand-worked RRF and gaps, its lanes against brute
force, its features against the program's, its imports, and the control
failing where the program passes."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from rag_bench.reference import features, judge, search
from rag_bench.spec import ROOT, load_cell
from rag_bench.traffic import corpus as gen
from rag_bench.traffic.queries import make_queries, warm_texts

SEED = 4_000_000_123


def test_rrf_by_hand():
    fused = search.rrf({"lex": [5, 7], "tech": [7], "dense": [9, 5]})
    # 5: 1/61 + 1/62 and 7: 1/62 + 1/61 tie (first occurrence: 5), 9: 1/61
    assert [row for row, _ in fused] == [5, 7, 9]
    assert fused[0][1] == pytest.approx(1 / 61 + 1 / 62)
    assert fused[2][1] == pytest.approx(1 / 61)


def test_gap_by_hand():
    config = {"chunks_rows": 100, "artifacts_rows": 10}
    ref = {"chunks": [(4, 1 / 61 + 1 / 62), (9, 1 / 61), (2, 1 / 62)],
           "artifacts": [(0, 1 / 61)]}
    # merged: chunk:5 (0.0326), artifact_chunk:1 then chunk:10 (1/61 each,
    # artifact first on the tie), chunk:3 (1/62)
    exact = {"retrieved_ids": ["chunk:5", "artifact_chunk:1", "chunk:10", "chunk:3"]}
    assert judge.ids_only(ref, exact, config, 20) == (0.0, 0)
    swapped = {"retrieved_ids": ["chunk:5", "chunk:3", "artifact_chunk:1", "chunk:10"]}
    gap, wrong = judge.ids_only(ref, swapped, config, 20)
    assert gap == pytest.approx(1 / 61 - 1 / 62) and wrong == 0
    stranger = {"retrieved_ids": ["chunk:50", "chunk:5", "artifact_chunk:1", "chunk:10"]}
    gap, _ = judge.ids_only(ref, stranger, config, 20)
    assert gap == pytest.approx(1 / 61 + 1 / 62)
    short = {"retrieved_ids": ["chunk:5", "chunk:5", "chunk:101"]}
    assert judge.ids_only(ref, short, config, 20)[1] == 1


def _brute_force(config, corpus, query, mode):
    """Every row of the corpus at once, in numpy; in the ann mode the best
    row of each group of 8 (rows b*1024 + w*128 + g) first."""
    blocks = [gen.make_block(config, corpus, SEED, b, "cpu")
              for b in range(gen.n_blocks(config, corpus))]
    emb = torch.cat([b["emb"] for b in blocks]).double().numpy()
    lex = torch.cat([b["lex"] for b in blocks]).double().numpy()
    tech = torch.cat([b["tech"] for b in blocks]).long().numpy()
    n = emb.shape[0]
    call = np.arange(n) * int(config["calls"]) // n
    started = gen.call_starts(config, SEED)[call]
    ok = np.ones(n, bool) if query["call"] is None else call == query["call"]
    ks = search.lane_ks(config, corpus)
    # the deployment's embedding type on both sides
    q16 = torch.from_numpy(query["emb"]).to(torch.bfloat16).double().numpy()
    dense = emb @ q16
    lexical = lex @ query["lex"][corpus]
    match = np.isin(tech, query["tech"]).any(1) & ok
    # a row's candidate: (block, group), its place in the group
    r = np.arange(n)
    candidate = (r // 1024) * 128 + r % 128

    def best(scores, keep, k):
        rows = np.flatnonzero(keep)
        if mode == "exact":
            return rows[np.lexsort((rows, -scores[rows]))][:k].tolist()
        # per candidate its best row, the lowest on a tie; then candidates
        # by score, the lowest candidate on a tie
        rows = rows[np.lexsort((rows, -scores[rows], candidate[rows]))]
        firsts = rows[np.r_[True, np.diff(candidate[rows]) != 0]]
        return firsts[np.lexsort((candidate[firsts], -scores[firsts]))][:k].tolist()

    recent = np.flatnonzero(match)
    return {"dense": best(dense, ok, ks["dense"]),
            "lex": best(lexical, ok & (lexical > search.LEX_THRESHOLD), ks["lex"]),
            "tech": recent[np.lexsort((recent, -started[recent]))][:ks["tech"]].tolist()}


@pytest.mark.parametrize("mode", ["exact", "ann"])
def test_lanes_match_brute_force(tiny_root, mode):
    cell = load_cell("tiny.scoped", tiny_root)
    config = dict(cell.config, chunks_rows=20000, chunks_capacity=32768, calls=16)
    queries = make_queries(cell.traffic, config, SEED, 6)
    texts = [t for t, _ in queries]
    calls = [None, None, None] + [c for _, c in queries[3:]]
    inputs = search.query_inputs(config, SEED, texts, calls,
                                 features.embed(texts, int(config["embedding_dim"])))
    for corpus in gen.CORPORA:
        got = search.lanes(config, corpus, SEED, inputs, "cpu", mode)
        for q, lanes in zip(inputs, got):
            assert lanes == _brute_force(config, corpus, q, mode)
        assert any(lanes["tech"] for lanes in got)


def test_features_are_the_programs(tiny_root):
    from cadence_rag_tpu_torch.embed.stub import HashEmbeddingProvider
    from cadence_rag_tpu_torch.ingest.chunking import extract_tech_tokens
    from cadence_rag_tpu_torch.ops import hashing

    cell = load_cell("cadence-1m.packs", tiny_root)
    texts = [t for t, _ in make_queries(cell.traffic, cell.config, SEED, 50)] + [
        "ECONNRESET on 10.0.0.1 via https://x.io/a HTTP 503 ORA-01234 deadbeef1 "
        "/var/log/app.log v2.3.17 OPS-4411 object store vs Azure bake-off"]
    df = np.random.default_rng(0).integers(1, 5000, 4096)
    for text in texts:
        assert features.tech_tokens(text) == extract_tech_tokens(text)
        want = hashing.query_vector_from_features(
            *hashing.query_feature_arrays(text, 4096), 4096, df, 20000)
        assert np.allclose(features.lexical_query(text, 4096, df, 20000), want,
                           rtol=1e-6, atol=1e-7)
    assert np.allclose(features.embed(texts, 1024),
                       HashEmbeddingProvider().embed(texts).vectors, atol=1e-6)


def test_the_stub_embedder_is_the_hash_embedding(tmp_path):
    cell = load_cell("msmarco-8m.ids", ROOT)
    assert "query_embedder" not in cell.config
    stub = cell.embedder()
    texts = [t for t, _ in make_queries(cell.traffic, cell.config, SEED, 40)]
    assert np.array_equal(stub.embed(cell.config, SEED, tmp_path, texts, "cpu"),
                          features.embed(texts, 1024))
    assert stub.warm(cell.config, cell.traffic) == warm_texts(cell.traffic, cell.config)
    assert stub.prepare(cell.config, SEED, tmp_path, "cpu") == {}
    # the control: the same, rounded to bf16, one step below the float32 served
    want = torch.from_numpy(features.embed(texts, 1024)).to(torch.bfloat16).double()
    assert np.array_equal(stub.control(cell.config, SEED, tmp_path, texts, "cpu"),
                          want.numpy())


def test_served_vectors_are_judged_and_a_missing_one_counted():
    ref = features.embed(["alpha beta", "gamma delta", "epsilon"], 1024)
    served = {"alpha beta": ref[0].astype(np.float32),
              "epsilon": (ref[2] + 1e-3).astype(np.float32)}
    embs, gap, missing = judge.vectors(served, ["alpha beta", "gamma delta", "epsilon"],
                                       ref)
    assert missing == 1
    # the served vectors in the dense lane, the reference's where none was
    assert np.array_equal(embs[0], ref[0].astype(np.float32))
    assert np.array_equal(embs[1], ref[1])
    assert gap == pytest.approx(1e-3, rel=1e-3)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import rag_bench.reference.search, rag_bench.reference.judge, "
            "rag_bench.traffic.texts, rag_bench.readings as r; "
            "from rag_bench.spec import load_cell; load_cell('msmarco-8m.ids').embedder(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cadence_rag_tpu_torch', 'cadence_rag_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("name, real", [("tiny.ids", "msmarco-8m.ids"),
                                        ("tiny.packs", "cadence-1m.packs")])
def test_the_control_fails_where_the_reference_passes(tiny_root, name, real):
    """The reference in int8 in the program's place, at a tiny size, is
    held to the limit of the real cell of its traffic and comes out not
    correct by the rule a run is judged by."""
    from rag_bench import readings, run, verdict

    cell = load_cell(name, tiny_root)
    queries = make_queries(cell.traffic, cell.config, SEED, 128)
    texts, calls = [t for t, _ in queries], [c for _, c in queries]
    embs = features.embed(texts, int(cell.config["embedding_dim"]))
    ref = search.fused(cell.config, SEED, texts, calls, embs, "cpu", cell.own["modes"])
    itself = [readings.control_answer(cell, SEED, f) for f in ref]
    assert run.judge_all(cell, SEED, ref, itself) == (0.0, 0)
    sample = {"texts": texts, "calls": calls, "reference": ref, "reference_embs": embs,
              "control_embs": cell.embedder().control(cell.config, SEED, None, texts,
                                                      "cpu")}
    cell.own["limits"] = json.loads(
        (ROOT / "rag_bench" / "workloads" / f"{real}.json").read_text())["limits"]
    control = readings.control_checks(cell, SEED, sample, "cpu")
    assert control["rrf_gap"]["value"] > control["rrf_gap"]["limit"]
    assert control["embed_gap"]["value"] > control["embed_gap"]["limit"]
    assert control["wrong_answers"]["value"] == 0       # only the ranking moves
    assert not verdict.correct(control)
