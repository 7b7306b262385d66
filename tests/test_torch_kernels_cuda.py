"""Kernels K1, K2 and K3 on a CUDA card against their plain versions, at
the edge shapes their callers can hand them: partial query tiles (batch not
a multiple of 64 or 16), ragged row blocks, int8 embeddings, the dense half
off, every K2 block size and batch tile, the tech lane at three match
densities and every k up to its limit; and the whole packed dispatch on the
card against the same index on the CPU.

Needs a card, so every test here carries the ``cuda`` marker and skips
without one. The machine with the card has no jax, which tests/conftest.py
imports, so run them there with:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.ops import dense_scan as k2
from cadence_rag_tpu_torch.ops import fused_scan as k1
from cadence_rag_tpu_torch.ops import tech_keys as k3

pytestmark = pytest.mark.cuda

INT32_MIN = -2147483648


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(rng, n, dim, d, b, emb_dtype):
    """Values on a coarse grid: every product and partial sum is exact in
    f32, so kernel and plain version must agree bit for bit."""
    if emb_dtype == torch.int8:
        emb = torch.from_numpy(rng.integers(-127, 128, size=(n, dim)).astype(np.int8))
    else:
        emb = torch.from_numpy(
            rng.integers(-64, 65, size=(n, dim)).astype(np.float32) / 64.0
        ).to(torch.bfloat16)
    q_emb = torch.from_numpy(rng.integers(-64, 65, size=(b, dim)).astype(np.float32) / 64.0)
    lex = torch.from_numpy(rng.integers(-4, 5, size=(n, d)).astype(np.int8))
    q_lex = torch.from_numpy(rng.integers(-8, 9, size=(b, d)).astype(np.float32) / 16.0)
    mask = torch.from_numpy(rng.random((b, n)) < 0.8)
    has_emb = torch.from_numpy(rng.random(n) < 0.9)
    return q_emb, q_lex, emb, lex, mask, has_emb


def _k1_check(cuda, args, dense):
    """Kernel vs plain version, bit for bit (grid inputs)."""
    n, b = args[3].shape[0], args[1].shape[0]
    want = k1.fused_scan_plain(*args, dense=dense)
    before = k1.fused_scan.launches
    got = k1.fused_scan(*(a.to(cuda) for a in args), dense=dense)
    torch.cuda.synchronize()
    assert k1.fused_scan.launches == before + 1
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == (b, k1.n_candidates(n))
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("n,b,emb_dtype,dense", [
    (8, 3, torch.bfloat16, True),
    (100, 1, torch.int8, True),
    (1024, 64, torch.bfloat16, False),
    (2348, 5, torch.int8, True),
    (5000, 128, torch.bfloat16, True),
    (9000, 70, torch.bfloat16, True),
])
def test_k1_kernel_matches_plain(cuda, n, b, emb_dtype, dense):
    rng = np.random.default_rng(n + b)
    _k1_check(cuda, _k1_inputs(rng, n, 64, 128, b, emb_dtype), dense)


@pytest.mark.parametrize("b", [1, 8, 63, 64, 127, 128, 129, 256, 300])
def test_k1_batch_edges(cuda, b):
    """Every query tile width (64, 128, 256) full and partial, a second
    256-query tile past 256; both embedding types, dense on and off."""
    rng = np.random.default_rng(b)
    emb_dtype = torch.int8 if b % 2 else torch.bfloat16
    args = _k1_inputs(rng, 2500, 64, 128, b, emb_dtype)
    _k1_check(cuda, args, dense=True)
    _k1_check(cuda, args, dense=False)


@pytest.mark.parametrize("n", [127, 128, 1023, 1025])
@pytest.mark.parametrize("emb_dtype", [torch.bfloat16, torch.int8])
def test_k1_row_edges(cuda, n, emb_dtype):
    """Ragged row counts at the edges of a 64-row tile pair and a block."""
    rng = np.random.default_rng(n)
    _k1_check(cuda, _k1_inputs(rng, n, 64, 128, 70, emb_dtype), dense=True)


@pytest.mark.parametrize("emb_dtype,dense", [
    (torch.bfloat16, True), (torch.int8, True), (torch.bfloat16, False),
])
def test_k1_main_path_widths(cuda, emb_dtype, dense):
    """The main path's widths: 1024-d embeddings, 4096-wide signatures.
    Grid sums stay exact in f32 at these widths."""
    rng = np.random.default_rng(1024)
    _k1_check(cuda, _k1_inputs(rng, 3000, 1024, 4096, 128, emb_dtype), dense)


@pytest.mark.parametrize("emb_dtype", [torch.bfloat16, torch.int8])
def test_k1_gate_lex_dim_32(cuda, emb_dtype):
    """The recall gate's and the sweep's 32-wide signatures."""
    rng = np.random.default_rng(32)
    _k1_check(cuda, _k1_inputs(rng, 5000, 64, 32, 64, emb_dtype), dense=True)


@pytest.mark.parametrize("emb_dtype", [torch.bfloat16, torch.int8])
def test_k1_off_grid_lexical_query(cuda, emb_dtype):
    """An f32 lexical query off the bf16 grid (scatter-added idf weights, as
    the serving path densifies them) and unit-norm embeddings: the
    three-piece split holds both lanes to chip_smoke's tolerances, every
    differing candidate proven a near-tie by rescoring."""
    import chip_smoke
    from cadence_rag_tpu_torch.ops.lexical import LEX_MATCH_THRESHOLD

    args = chip_smoke.k1_inputs(cuda, 20_000, 128, 1024, 4096, emb_dtype, seed=7)
    q_emb, q_lex, emb, lex, mask, has_emb = args
    assert not torch.equal(q_lex, q_lex.to(torch.bfloat16).float())
    got = k1.fused_scan(*args, dense=True)
    want = k1.fused_scan_plain(*args, dense=True)
    torch.cuda.synchronize()
    scale = 1.0 / 127.0 if emb_dtype == torch.int8 else 1.0
    chip_smoke.check_lane(got[0], got[1], want[0], want[1],
                          (q_emb.to(torch.bfloat16).float(), emb, scale,
                           mask & has_emb[None, :], 20_000), chip_smoke.DENSE_ATOL)
    chip_smoke.check_lane(got[2], got[3], want[2], want[3],
                          (q_lex, lex, 1.0, mask, 20_000), chip_smoke.LEX_ATOL,
                          LEX_MATCH_THRESHOLD)


def _k2_inputs(rng, n, dim, b, density=0.8):
    """Grid values: every sum is exact in f32, so kernel and plain version
    agree bit for bit and ties (frequent on the grid) go to the same row."""
    rows = torch.from_numpy(
        rng.integers(-64, 65, size=(n, dim)).astype(np.float32) / 64.0
    ).to(torch.bfloat16)
    q = torch.from_numpy(rng.integers(-8, 9, size=(b, dim)).astype(np.float32) / 8.0)
    mask = torch.from_numpy(rng.random((b, n)) < density)
    return q, rows, mask


def _k2_check(cuda, args, block_n):
    want = k2.dense_scan_plain(*args, block_n=block_n)
    before = k2.dense_scan.launches
    got = k2.dense_scan(*(a.to(cuda) for a in args), block_n=block_n)
    torch.cuda.synchronize()
    assert k2.dense_scan.launches == before + 1
    n, b = args[1].shape[0], args[0].shape[0]
    for g, w in zip(got, want):
        assert g.shape == (b, k2.n_candidates(n, block_n))
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("block_n", list(range(256, 2049, 128)))
def test_k2_kernel_matches_plain_every_block_n(cuda, block_n):
    """Every block size (width 2..16), a ragged last block, a partial
    query tile."""
    rng = np.random.default_rng(block_n)
    _k2_check(cuda, _k2_inputs(rng, 3 * block_n + 200, 64, 70), block_n)


@pytest.mark.parametrize("n,b,density", [
    (1, 1, 1.0), (100, 3, 0.8), (1024, 64, 0.8), (1025, 65, 0.3),
    (100_000, 64, 0.05),
])
def test_k2_kernel_matches_plain_ragged(cuda, n, b, density):
    rng = np.random.default_rng(n + b)
    _k2_check(cuda, _k2_inputs(rng, n, 64, b, density), k2.DEFAULT_BLOCK_N)


def test_k2_refuses_int8_rows(cuda):
    rows = torch.zeros((1024, 64), dtype=torch.int8, device=cuda)
    q = torch.zeros((2, 64), device=cuda)
    mask = torch.ones((2, 1024), dtype=torch.bool, device=cuda)
    before = k2.dense_scan.launches
    with pytest.raises(TypeError, match="int8"):
        k2.dense_scan(q, rows, mask)
    assert k2.dense_scan.launches == before


@pytest.mark.parametrize("n,b,slots,capacity", [
    (8, 1, 16, 1), (1000, 17, 16, 1), (4096, 128, 16, 2), (3333, 9, 8, 4),
    (5000, 40, 32, 2),
])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_k3_lane_matches_plain_small(cuda, n, b, slots, capacity, k):
    """Small grids of few token values: many matches per range, ties in
    start seconds, rows with start seconds at -inf and below it (NaN)."""
    import chip_smoke

    if k > n:
        pytest.skip("k above the row count")
    rng = np.random.default_rng(n + k)
    tech = rng.integers(1, 30, size=(n, slots)).astype(np.int32)
    tech[rng.random((n, slots)) < 0.3] = 0
    started = np.repeat(rng.integers(1_600_000_000, 1_700_000_000, n // 10 + 1),
                        10)[:n].astype(np.int32)
    started[rng.random(n) < 0.05] = INT32_MIN
    started[rng.random(n) < 0.01] = -8388608
    started[rng.random(n) < 0.01] = -5
    q = rng.integers(0, 30, size=(b, slots * capacity)).astype(np.int32)
    mask = (rng.random((b, n)) < 0.9) & (started != INT32_MIN)[None, :]
    args = [torch.from_numpy(x).to(cuda) for x in (q, tech, started, mask)]
    before = k3.range_topk.launches
    chip_smoke.check_k3_case(*args, k)
    assert k3.range_topk.launches == before + 2


@pytest.mark.parametrize("density", ["none", "smoke", "dense"])
@pytest.mark.parametrize("k", [1, 10, 50, k3.MAX_K])
def test_k3_lane_matches_plain_1m(cuda, density, k):
    """Batch 128 x 1M rows, chip_smoke's three match densities."""
    import chip_smoke

    args = chip_smoke.k3_inputs(cuda, 1_048_576, 128, 16, density, seed=11)
    chip_smoke.check_k3_case(*args, k)


@pytest.mark.parametrize("n,b", [(1_000_003, 128), (1_048_576, 1), (1_048_576, 200)])
def test_k3_lane_edges_1m(cuda, n, b):
    """A ragged row count, batch 1 and batch 200 (two query groups past
    the CTA's eight), k 50."""
    import chip_smoke

    args = chip_smoke.k3_inputs(cuda, n, b, 16, "smoke", seed=12)
    chip_smoke.check_k3_case(*args, 50)


def test_k3_refuses_k_above_max(cuda):
    args = [torch.zeros((2, 16), dtype=torch.int32, device=cuda),
            torch.zeros((4096, 16), dtype=torch.int32, device=cuda),
            torch.zeros((4096,), dtype=torch.int32, device=cuda),
            torch.ones((2, 4096), dtype=torch.bool, device=cuda)]
    with pytest.raises(ValueError, match="k"):
        k3.range_topk(*args, k3.MAX_K + 1)


@pytest.mark.parametrize("block_n", list(range(256, 2049, 128)))
@pytest.mark.parametrize("n_kind,b", [("ragged", 1), ("aligned", 64),
                                      ("ragged", 128), ("aligned", 300)])
def test_k2_unit_rows_every_block_n(cuda, block_n, n_kind, b):
    """Unit bf16 rows at dim 1024 under a 5% mask, off the grid: candidates
    within chip_smoke's tolerance, the top-10 rows identical outside
    near-ties proven by rescoring (chip_smoke.check_k2)."""
    import chip_smoke

    n = 20 * block_n + (block_n // 3 + 1 if n_kind == "ragged" else 0)
    chip_smoke.check_k2(cuda, n, b, 1024, "random", seed=block_n + b, reps=0,
                        block_n=block_n, timed=False)


def test_packed_dispatch_card_matches_cpu(cuda, monkeypatch):
    """The same corpus (carried by state_arrays/load_state) and the same
    packed batch on the card and on the CPU."""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager

    import chip_smoke

    monkeypatch.setattr(settings, "embeddings_dim", 64)
    monkeypatch.setattr(settings, "lexical_dim", 256)
    monkeypatch.setattr(settings, "index_initial_capacity", 256)
    cpu_index, texts, tokens = chip_smoke.build_index(
        "cpu", n_chunks=6000, n_artifacts=700, n_known=4)
    card_index = DeviceIndexManager(cuda)
    card_index.ensure_call_capacity(cpu_index.call_capacity)
    for name in ("chunks", "artifact_chunks"):
        card_index.corpus(name).load_state(cpu_index.corpus(name).state_arrays())
    for scoped in (False, True):
        args, modes, expected = chip_smoke.plan_batch(
            cpu_index, texts, tokens, 8, scoped)
        for fuse in (False, True):
            outs = []
            for index in (cpu_index, card_index):
                disp = index.query_both_packed_async(
                    *args, chunk_ks=chip_smoke.CHUNK_KS,
                    artifact_ks=chip_smoke.ARTIFACT_KS, chunk_mode=modes[0],
                    artifact_mode=modes[1], recall_target=0.95, fuse_rrf=fuse)
                outs.append(index.collect_packed(disp))
            for cpu_c, card_c in zip(*outs):
                assert cpu_c.keys() == card_c.keys()
                for lane in cpu_c:
                    for a, c in zip(cpu_c[lane], card_c[lane]):
                        # f32 sums in another order: ids may swap only at
                        # near-ties, which the score tolerance bounds
                        if a.dtype.kind == "f":
                            np.testing.assert_allclose(c, a, rtol=1e-5, atol=1e-5)
                        else:
                            assert (c == a).mean() > 0.99
            if fuse:
                chip_smoke.check_first(outs[1], expected, "card")


def test_served_fixture_corpus_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The fixture corpus ingested and served through ``serve.testing`` on
    the card and on the CPU, each with a store of its own: the gold
    queries give identical ``retrieved_ids`` and evidence packs."""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.index import reset_index
    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu_torch.evals.fixtures import GOLD_QUERIES, ingest_fixtures
    from cadence_rag_tpu_torch.serve.testing import TestClient
    from cadence_rag_tpu_torch.store.db import reset_store

    import itertools
    from datetime import datetime, timedelta, timezone

    from cadence_rag_tpu_torch.ingest import ingest

    monkeypatch.setattr(settings, "embeddings_provider", "stub")
    monkeypatch.setattr(settings, "embeddings_base_url", "")
    monkeypatch.setattr(settings, "store_sync_interval_s", 0.0)
    monkeypatch.setattr(settings, "index_initial_capacity", 256)
    served = {}
    try:
        for device in ("cuda", "cpu"):
            # the same call start seconds on both runs: the tech lane ranks
            # by recency
            ticks = itertools.count()
            monkeypatch.setattr(ingest, "now_utc", lambda: datetime(
                2025, 6, 1, tzinfo=timezone.utc) + timedelta(seconds=next(ticks)))
            monkeypatch.setattr(settings, "store_path", str(tmp_path / f"{device}.db"))
            reset_store()
            reset_index()
            client = TestClient(device=device)
            ingest_fixtures()
            run_embedding_backfill(batch_size=16)
            out = []
            for style in ("ids_only", "evidence_pack_json"):
                resp = client.post("/retrieve/batch", json=[
                    {"query": q, "return_style": style} for _i, q, _n in GOLD_QUERIES])
                assert resp.status_code == 200, resp.json()
                out.append([r.get("retrieved_ids") or
                            [e["evidence_id"] for e in r["artifacts"] + r["quotes"]]
                            for r in resp.json()["results"]])
            served[device] = out
    finally:
        reset_store()
        reset_index()
    assert all(ids for ids in served["cuda"][0])
    assert served["cuda"] == served["cpu"]
