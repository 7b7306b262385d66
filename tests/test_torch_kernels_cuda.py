"""Kernels K1, K2 and K3 on a CUDA card against their plain versions, at
the edge shapes their callers can hand them: partial query tiles (batch not
a multiple of 64 or 16), ragged row blocks, int8 embeddings, the dense half
off, K1's two routes for the lexical query (fp16 and bf16 pieces, residual
pieces issued in no slab, some or all), every K2 block size and batch tile,
the tech lane at three match densities and every k up to its limit; and
the whole packed dispatch on the card against the same index on the CPU.

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


def _k1_inputs(rng, n, dim, d, b, emb_dtype, route="fp16"):
    """Values on a coarse grid: every product and partial sum is exact in
    f32, so kernel and plain version must agree bit for bit. The lexical
    query is on fp16's grid (K1's fp16 route) or, for ``route`` "bf16",
    scaled by 2^17 past fp16's range (the bf16 route; still exact)."""
    if emb_dtype == torch.int8:
        emb = torch.from_numpy(rng.integers(-127, 128, size=(n, dim)).astype(np.int8))
    else:
        emb = torch.from_numpy(
            rng.integers(-64, 65, size=(n, dim)).astype(np.float32) / 64.0
        ).to(torch.bfloat16)
    q_emb = torch.from_numpy(rng.integers(-64, 65, size=(b, dim)).astype(np.float32) / 64.0)
    lex = torch.from_numpy(rng.integers(-4, 5, size=(n, d)).astype(np.int8))
    q_lex = torch.from_numpy(rng.integers(-8, 9, size=(b, d)).astype(np.float32) / 16.0)
    if route == "bf16":
        q_lex[0, 0] = 0.5
        q_lex *= 2.0 ** 17
    mask = torch.from_numpy(rng.random((b, n)) < 0.8)
    has_emb = torch.from_numpy(rng.random(n) < 0.9)
    return q_emb, q_lex, emb, lex, mask, has_emb


def _k1_launch(cuda, args, dense):
    """One K1 launch on the card -> (candidates, the kernel's own count of
    the launch: route and lexical pieces a K slab), held to the count
    ``issued_pieces`` gives for the lexical query."""
    before = k1.fused_scan.launches
    counted = k1.route_counts(cuda)
    got = k1.fused_scan(*args, dense=dense)
    torch.cuda.synchronize()
    assert k1.fused_scan.launches == before + 1
    delta = {k: v - counted[k] for k, v in k1.route_counts(cuda).items()}
    route = "fp16" if delta["fp16"] else "bf16"
    assert delta["bf16"] + delta["fp16"] == 1
    tile = k1.query_tile(args[1].shape[0])
    assert delta["slabs"] == -(-args[1].shape[0] // tile) * (args[1].shape[1] // 32)
    issued = (route, delta["pieces"] / delta["slabs"])
    want_route, want_pieces = k1.issued_pieces(args[1], tile)
    assert route == want_route and issued[1] == pytest.approx(want_pieces, rel=1e-12)
    return got, issued


def _k1_check(cuda, args, dense, route="fp16"):
    """Kernel vs plain version, bit for bit (grid inputs), on ``route``."""
    n, b = args[3].shape[0], args[1].shape[0]
    want = k1.fused_scan_plain(*args, dense=dense)
    got, issued = _k1_launch(cuda, [a.to(cuda) for a in args], dense)
    assert issued[0] == route
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == (b, k1.n_candidates(n))
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


ROUTES = ["fp16", "bf16"]


@pytest.mark.parametrize("n,b,emb_dtype,dense", [
    (8, 3, torch.bfloat16, True),
    (100, 1, torch.int8, True),
    (1024, 64, torch.bfloat16, False),
    (2348, 5, torch.int8, True),
    (5000, 128, torch.bfloat16, True),
    (9000, 70, torch.bfloat16, True),
])
@pytest.mark.parametrize("route", ROUTES)
def test_k1_kernel_matches_plain(cuda, n, b, emb_dtype, dense, route):
    rng = np.random.default_rng(n + b)
    _k1_check(cuda, _k1_inputs(rng, n, 64, 128, b, emb_dtype, route), dense, route)


@pytest.mark.parametrize("b", [1, 8, 63, 64, 127, 128, 129, 256, 300])
@pytest.mark.parametrize("route", ROUTES)
def test_k1_batch_edges(cuda, b, route):
    """Every query tile width (64, 128, 256) full and partial, a second
    256-query tile past 256; both embedding types, dense on and off."""
    rng = np.random.default_rng(b)
    emb_dtype = torch.int8 if b % 2 else torch.bfloat16
    args = _k1_inputs(rng, 2500, 64, 128, b, emb_dtype, route)
    _k1_check(cuda, args, dense=True, route=route)
    _k1_check(cuda, args, dense=False, route=route)


@pytest.mark.parametrize("n", [127, 128, 1023, 1025])
@pytest.mark.parametrize("emb_dtype", [torch.bfloat16, torch.int8])
def test_k1_row_edges(cuda, n, emb_dtype):
    """Ragged row counts at the edges of a 64-row tile pair and a block."""
    rng = np.random.default_rng(n)
    _k1_check(cuda, _k1_inputs(rng, n, 64, 128, 70, emb_dtype), dense=True)


@pytest.mark.parametrize("emb_dtype,dense", [
    (torch.bfloat16, True), (torch.int8, True), (torch.bfloat16, False),
])
@pytest.mark.parametrize("route", ROUTES)
def test_k1_main_path_widths(cuda, emb_dtype, dense, route):
    """The main path's widths: 1024-d embeddings, 4096-wide signatures.
    Grid sums stay exact in f32 at these widths."""
    rng = np.random.default_rng(1024)
    _k1_check(cuda, _k1_inputs(rng, 3000, 1024, 4096, 128, emb_dtype, route), dense,
              route)


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
    got, (route, pieces) = _k1_launch(cuda, args, dense=True)
    assert route == "bf16" and pieces > 2.0
    want = k1.fused_scan_plain(*args, dense=True)
    torch.cuda.synchronize()
    scale = 1.0 / 127.0 if emb_dtype == torch.int8 else 1.0
    chip_smoke.check_lane(got[0], got[1], want[0], want[1],
                          (q_emb.to(torch.bfloat16).float(), emb, scale,
                           mask & has_emb[None, :], 20_000), chip_smoke.DENSE_ATOL)
    chip_smoke.check_lane(got[2], got[3], want[2], want[3],
                          (q_lex, lex, 1.0, mask, 20_000), chip_smoke.LEX_ATOL,
                          LEX_MATCH_THRESHOLD)


def _served_lex(rng, b, lex_dim, residuals):
    """Served-kind lexical queries: ~45 signed f16 weights a query
    scatter-added in f32 (``ops/pack._densify``). ``residuals``: "some"
    (buckets drawn with repeats, so a few are shared), "none" (no bucket
    shared: h alone in every slab), or "all" (besides, in every slab of
    every query tile, one bucket holding the f32 sum of three f16 weights
    that needs m and l)."""
    from cadence_rag_tpu_torch.ops.pack import _densify

    feats = 45
    if residuals == "none":
        buckets = np.argsort(rng.random((b, lex_dim)), axis=1)[:, :feats]
    else:
        buckets = rng.integers(0, lex_dim, size=(b, feats))
    values = (rng.lognormal(-1.0, 1.0, size=(b, feats))
              * rng.choice([-1.0, 1.0], size=(b, feats))).astype(np.float16)
    if residuals == "some":
        # at least one shared bucket whose sum is not an f16 value
        buckets[0, 1] = buckets[0, 0]
        values[0, :2] = (1.0, 2.0 ** -12)
    q = _densify(torch.from_numpy(buckets), torch.from_numpy(values.astype(np.float32)),
                 lex_dim)
    if residuals == "all":
        tile = k1.query_tile(b)
        three = np.float32(1.0) + np.float32(0.375 * 2.0 ** -10) + np.float32(1.5 * 2.0 ** -22)
        for t in range(-(-b // tile)):
            rows = min(tile, b - t * tile)
            for slab in range(lex_dim // 32):
                q[t * tile + slab % rows, 32 * slab + slab % 32] = float(three)
    masks = k1.slab_masks(k1.split_query(q, torch.float16), k1.query_tile(b))
    assert bool(k1.fp16_route(q))
    assert {"none": not bool(masks.any()), "all": bool(masks.all()),
            "some": bool(masks.any()) and not bool(masks.all())}[residuals]
    return q


@pytest.mark.parametrize("b", [1, 64, 117, 128, 256])
@pytest.mark.parametrize("emb_dtype,dense", [
    (torch.bfloat16, True), (torch.int8, True), (torch.bfloat16, False),
    (torch.int8, False),
])
@pytest.mark.parametrize("residuals", ["some", "none", "all"])
def test_k1_fp16_route_on_served_queries(cuda, b, emb_dtype, dense, residuals):
    """The served query (sums of f16 weights) takes the fp16 route at the
    main path's widths; residual pieces in some slabs, none or all: rows
    as the plain version's but at near-ties (proven by rescoring), values
    within chip_smoke's tolerances, and the kernel's count of the pieces
    it issued equal to ``issued_pieces``."""
    import chip_smoke
    from cadence_rag_tpu_torch.ops.lexical import LEX_MATCH_THRESHOLD

    n = 20_000
    rng = np.random.default_rng(b + 7)
    args = list(chip_smoke.k1_inputs(cuda, n, b, 1024, 4096, emb_dtype, seed=b))
    args[1] = _served_lex(rng, b, 4096, residuals).to(cuda)
    q_emb, q_lex, emb, lex, mask, has_emb = args
    want = k1.fused_scan_plain(*args, dense=dense)
    got, (route, pieces) = _k1_launch(cuda, args, dense)
    assert route == "fp16"
    assert (pieces == 1.0) == (residuals == "none") and (pieces == 3.0) == (residuals == "all")
    chip_smoke.check_lane(got[2], got[3], want[2], want[3],
                          (q_lex, lex, 1.0, mask, n), chip_smoke.LEX_ATOL,
                          LEX_MATCH_THRESHOLD)
    if dense:
        scale = 1.0 / 127.0 if emb_dtype == torch.int8 else 1.0
        chip_smoke.check_lane(got[0], got[1], want[0], want[1],
                              (q_emb.to(torch.bfloat16).float(), emb, scale,
                               mask & has_emb[None, :], n), chip_smoke.DENSE_ATOL)
    else:
        assert got[0] is None and want[0] is None


@pytest.mark.parametrize("b", [1, 64, 65, 117, 128, 129, 256, 300])
def test_k1_query_tile_is_the_launchers(cuda, b):
    """The C side's query tile, which sizes the slab bytes, is the one the
    CPU tests take for ``slab_masks``; the scratch it asks for holds the
    dense piece, the six lexical pieces and a byte per tile and slab."""
    from test_torch_fused_split import launch_tile

    tile = k1.query_tile(b)
    assert tile == launch_tile(b)
    lib = k1.build.load()
    slab_bytes = -(-b // tile) * (4096 // 32)
    assert lib.ck_fused_scan_work_bytes(b, 1024, 4096, 1) == 2 * b * 1024 + 12 * b * 4096 + slab_bytes
    assert lib.ck_fused_scan_work_bytes(b, 1024, 4096, 0) == 12 * b * 4096 + slab_bytes


@pytest.mark.parametrize("b,lex", [(117, "some"), (256, "all"), (300, "f32"), (64, "none")])
@pytest.mark.parametrize("dense", [True, False])
def test_k1_split_kernel_writes_pieces_in_kernel_order(cuda, monkeypatch, b, lex, dense):
    """The split kernel's scratch after a launch: the dense query rounded
    to bf16, the lexical query's bf16 and fp16 pieces (``split_query``),
    each 32-wide K slab in the kernel's order (``kernel_order`` of the CPU
    tests), then per query tile and slab the residual pieces' bits (bf16 m,
    l; fp16 m, l) as ``slab_masks`` marks them, and the fp16 route's
    shortfall bit set somewhere exactly off that route."""
    import chip_smoke
    from test_torch_fused_split import kernel_order

    args = list(chip_smoke.k1_inputs(cuda, 3000, b, 1024, 4096, torch.bfloat16, seed=b))
    if lex != "f32":
        args[1] = _served_lex(np.random.default_rng(b), b, 4096, lex).to(cuda)
    scratch = []
    make = k1._scratch
    monkeypatch.setattr(k1, "_scratch", lambda *a: scratch.append(make(*a)) or scratch[-1])
    k1.fused_scan(*args, dense=dense)
    torch.cuda.synchronize()
    (work,) = scratch
    q_emb, q_lex = args[0], args[1]
    at = 0
    if dense:
        size = 2 * b * 1024
        got = work[:size].view(torch.bfloat16).view(b, 1024)
        assert torch.equal(got, kernel_order(q_emb.float().to(torch.bfloat16)))
        at = size
    plane = b * 4096
    pieces = work[at:at + 12 * plane].view(torch.int16).view(6, b, 4096)
    tile = k1.query_tile(b)
    bits = work[at + 12 * plane:].view(-(-b // tile), 4096 // 32).long()
    want_bits = torch.zeros_like(bits)
    for i, dtype in enumerate((torch.bfloat16, torch.float16)):
        split = k1.split_query(q_lex, dtype)
        assert torch.equal(pieces[3 * i:3 * i + 3], kernel_order(split).view(torch.int16))
        masks = k1.slab_masks(split, tile).long()
        want_bits |= (masks[0] | masks[1] << 1) << (2 * i)
    assert torch.equal(bits & 0xF, want_bits)
    assert bool((bits & 0x10).any()) == (not bool(k1.fp16_route(q_lex)))


def test_k1_launch_waits_for_nothing(cuda):
    """The wrapper and both kernels' launch under the sync debug mode set
    to raise: nothing on the launch path reads the device (the route is
    decided on it)."""
    import chip_smoke

    args = list(chip_smoke.k1_inputs(cuda, 5000, 117, 1024, 4096, torch.bfloat16, seed=3))
    args[1] = _served_lex(np.random.default_rng(3), 117, 4096, "some").to(cuda)
    for dense in (True, False):
        k1.fused_scan(*args, dense=dense)          # builds, and makes the cached tensors
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for dense in (True, False):
            k1.fused_scan(*args, dense=dense)
            k1.fused_topk(*args, k_dense=50, k_lex=50, dense=dense)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


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


def test_packed_dispatch_records_the_pieces_k1_issued(cuda, monkeypatch):
    """A traced packed dispatch's ``index.dispatch`` event carries K1's own
    count of the lexical pieces it issued a K slab over the program's two
    launches (one a corpus), and their route: ``issued_pieces`` of the
    sparse rows the dispatch packed, densified."""
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager
    from cadence_rag_tpu_torch.ops.pack import _densify, sparse_lex_rows
    from cadence_rag_tpu_torch.utils import events

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
    args, modes, _ = chip_smoke.plan_batch(cpu_index, texts, tokens, 8, False)
    events.enable()
    try:
        card_index.collect_packed(card_index.query_both_packed_async(
            *args, chunk_ks=chip_smoke.CHUNK_KS, artifact_ks=chip_smoke.ARTIFACT_KS,
            chunk_mode=modes[0], artifact_mode=modes[1], recall_target=0.95))
        (ev,) = [e for e in events.drain() if e["tag"] == "index.dispatch"]
    finally:
        events.disable()
    want = []
    for corpus in (card_index.chunks, card_index.artifacts):
        buckets, values = sparse_lex_rows(args[1], corpus.doc_freq, corpus.live_count,
                                          int(settings.query_lex_features))
        q = _densify(torch.from_numpy(buckets.astype(np.int64)),
                     torch.from_numpy(values.astype(np.float32)), corpus.lex_dim)
        want.append(k1.issued_pieces(q, k1.query_tile(q.shape[0])))
    routes = {route for route, _ in want}
    assert ev["lex_route"] == (routes.pop() if len(routes) == 1 else "mixed")
    assert ev["lex_route"] == "fp16"
    assert ev["lex_pieces"] == pytest.approx(sum(p for _, p in want) / 2, rel=1e-12)


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


def test_startup_pins_full_precision_f32_matmul(tmp_path, monkeypatch):
    """A process that asked for TF32 matmuls before it started the server:
    ``startup`` on the card turns TF32 off again, and an ``ivf`` batch (the
    lane that scores f32 queries) gives the plain f32 answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.index import get_index, reset_index
    from cadence_rag_tpu_torch.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu_torch.evals.fixtures import ingest_fixtures
    from cadence_rag_tpu_torch.ingest.sync import reset_syncer
    from cadence_rag_tpu_torch.serve.api import startup
    from cadence_rag_tpu_torch.store.db import reset_store

    for name, value in (("embeddings_provider", "stub"), ("embeddings_base_url", ""),
                        ("store_sync_interval_s", 0.0), ("index_initial_capacity", 256),
                        ("store_path", str(tmp_path / "tf32.db"))):
        monkeypatch.setattr(settings, name, value)
    before = torch.get_float32_matmul_precision()
    try:
        reset_store()
        reset_index()
        reset_syncer()
        torch.set_float32_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        startup("cuda")
        assert not torch.backends.cuda.matmul.allow_tf32
        ingest_fixtures()
        run_embedding_backfill(batch_size=16)
        chunks = get_index().chunks
        n = chunks.count
        state = chunks.build_ivf(n_clusters=4, nprobe=4)    # every cluster probed
        assert state.built_count == n
        rng = np.random.default_rng(5)
        q = rng.standard_normal((16, chunks.dim)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        batch = q.shape[0]
        vals, pos = chunks.ivf_dense_query(
            q, np.ones((batch, get_index().call_capacity), dtype=bool),
            np.full(batch, INT32_MIN + 1, np.int32),
            np.full(batch, 2**31 - 1, np.int32), k=10)
        # the plain f32 answer: f64 products of the f32 query and the stored rows
        rows = chunks.emb[:n].float().cpu().numpy().astype(np.float64)
        scores = q.astype(np.float64) @ rows.T
        scores[:, ~chunks.h_has_emb[:n]] = -np.inf
        want = -np.sort(-scores, axis=1)[:, :10]
        got = vals.cpu().numpy()
        assert np.isfinite(got).all() and np.abs(got - want).max() < 2e-6
        np.testing.assert_array_equal(
            np.take_along_axis(scores, pos.cpu().numpy(), axis=1) >= want[:, -1:] - 2e-6,
            True)
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cuda.matmul.allow_tf32 = False
        reset_store()
        reset_index()
        reset_syncer()


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_index_writes_card_matches_cpu(cuda, emb_dtype):
    """Inserts, tombstones, scatters and a compaction on the card give the
    arrays the same operations give on the CPU, bit for bit."""
    from cadence_rag_tpu_torch.core.index import CorpusIndex, DocRow

    rng = np.random.default_rng(11)
    rows = []
    for i in range(700):
        vec = rng.standard_normal(64).astype(np.float32)
        sig = rng.integers(-4, 5, size=256).astype(np.int8)
        rows.append(DocRow(
            doc_id=i + 1, call_seq=int(rng.integers(0, 9)),
            started_sec=int(rng.integers(1_600_000_000, 1_700_000_000)),
            lex_sig=sig, lex_dl=int(rng.integers(3, 30)),
            lex_touched=np.flatnonzero(sig).astype(np.int32),
            tech=rng.integers(0, 2**31 - 1, size=16).astype(np.int32),
            embedding=None if i % 5 == 0 else vec / np.linalg.norm(vec)))
    states = []
    for device in (cuda, torch.device("cpu")):
        corpus = CorpusIndex("chunks", dim=64, lex_dim=256, tech_slots=16,
                             capacity=64, device=device, emb_dtype=emb_dtype)
        corpus.insert(rows[:400])
        corpus.insert(rows[400:])
        ids = list(range(50, 300))
        assert corpus.delete_ids(ids + [9999], None, None) == 250
        corpus.set_tech([1, 2, 60], np.arange(48, dtype=np.int32).reshape(3, 16))
        corpus.set_embeddings([1, 6], np.eye(64, dtype=np.float32)[:2])
        corpus.set_lex([3, 4], np.ones((2, 256), dtype=np.int8))
        before = corpus.state_arrays()
        assert corpus.maybe_compact() and corpus.tombstones == 0
        assert corpus.count == 450 and not corpus.contains([50, 299]).any()
        corpus.insert(rows[50:60])                 # deleted ids: refused
        assert corpus.count == 450
        states.append((before, corpus.state_arrays(), corpus.capacity, corpus.emb_rows))
    for got, want in zip(states[0][:2], states[1][:2]):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert states[0][2:] == states[1][2:]


# -- the index's lifecycle on the card ----------------------------------------------
def _corpus_like(name, device, arrays, count):
    """What ``chip_smoke.check_kernels_on_corpus`` reads of a corpus."""
    import threading
    import types

    return types.SimpleNamespace(name=name, device=device, lock=threading.RLock(),
                                 count=count, device_arrays=lambda: arrays)


def _synthetic_index(device, n_chunks, n_artifacts, dim=1024, lex_dim=4096):
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager
    from cadence_rag_tpu_torch.evals.synth import install_synthetic_corpus

    settings.embeddings_dim, settings.lexical_dim = dim, lex_dim
    index = DeviceIndexManager(device)
    index.ensure_call_capacity(1024)
    install_synthetic_corpus(index.chunks, n_chunks, 1024, seed=0)
    install_synthetic_corpus(index.artifacts, n_artifacts, 1024, seed=1)
    return index


@pytest.fixture()
def full_width(monkeypatch):
    from cadence_rag_tpu_torch.config import settings

    for name in ("embeddings_dim", "lexical_dim", "index_max_device_rows",
                 "cold_block_rows", "index_embedding_dtype", "index_initial_capacity"):
        monkeypatch.setattr(settings, name, getattr(settings, name))
    return settings


@pytest.mark.parametrize("rows", [262_144, 213_584])
def test_k1_k3_on_a_pinned_block_copied_in(cuda, full_width, rows):
    """A cold block's rows in pinned host memory, copied to the device
    without blocking as ``ColdTier.dispatch`` does: K1 (both lanes) and K3
    against their plain versions at the block's shape, full and ragged."""
    import chip_smoke

    from cadence_rag_tpu_torch.core.coldtier import ColdTier

    index = _synthetic_index(cuda, rows, 1024)
    tier = ColdTier(dim=1024, lex_dim=4096, tech_slots=16, emb_dtype=torch.bfloat16,
                    device=cuda)
    tier._alloc(rows)
    for dst, src in zip(tier.row_arrays(), index.chunks.device_arrays()):
        assert dst.is_pinned()
        dst[:rows].copy_(src[:rows])
    tier.count = rows
    staged = tuple(s[:rows] for s in tier._staging_for(rows))
    for dst, src in zip(staged, tier.row_arrays()):
        dst.copy_(src[:rows], non_blocking=True)
    before = (k1.fused_scan.launches, k3.range_topk.launches)
    out = chip_smoke.check_kernels_on_corpus(
        _corpus_like("block", cuda, staged, rows), 1024, 128, seed=5)
    assert out["rows"] == rows and out["max_abs_err"] < 1e-3
    assert k1.fused_scan.launches > before[0] and k3.range_topk.launches > before[1]


def test_k1_k3_on_2m_row_tensors(cuda, full_width):
    """The doubled capacity: 2,097,152-row tensors, 1,048,916 rows live."""
    import chip_smoke

    from cadence_rag_tpu_torch.evals.synth import append_synthetic_rows

    index = _synthetic_index(cuda, 1_048_000, 1024)
    rows = chip_smoke.synthetic_doc_rows(1024, 70_000_000, 1, 1024, 4096, 16)
    index.chunks.insert(rows)
    assert index.chunks.capacity == 2_097_152
    append_synthetic_rows(index.chunks, 1000, 1024, seed=2)
    out = chip_smoke.check_kernels_on_corpus(index.chunks, 1024, 128, seed=6)
    assert out["rows"] == 2_097_152 and out["max_abs_err"] < 1e-3


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
def test_checkpoint_card_to_cpu_and_back(cuda, full_width, tmp_path, emb_dtype):
    """A checkpoint saved from the card restores on the CPU and one saved
    from the CPU restores on the card, rows bit-equal; K1 and K3 hold on
    the restored tensors."""
    import chip_smoke

    from cadence_rag_tpu_torch.core.checkpoint import restore_index, save_index
    from cadence_rag_tpu_torch.core.index import DeviceIndexManager

    full_width.index_embedding_dtype = emb_dtype
    on_card = _synthetic_index(cuda, 20_000, 3000, dim=256, lex_dim=512)
    on_card.chunks.delete_ids(list(range(100, 600)))
    save_index(str(tmp_path / "card"), on_card)
    on_cpu = DeviceIndexManager("cpu")
    restore_index(str(tmp_path / "card"), on_cpu)
    save_index(str(tmp_path / "cpu"), on_cpu)
    back = DeviceIndexManager(cuda)
    restore_index(str(tmp_path / "cpu"), back)
    for name in ("chunks", "artifact_chunks"):
        a, b, c = on_card.corpus(name), on_cpu.corpus(name), back.corpus(name)
        assert chip_smoke.same_corpus_state(c, a) is None
        n = a.count
        for x, y in zip(a.device_arrays(), b.device_arrays()):
            assert torch.equal(x[:n].cpu(), y[:n])
        assert b.tombstones == a.tombstones and b._id_to_pos == a._id_to_pos
    out = chip_smoke.check_kernels_on_corpus(back.chunks, 1024, 64, seed=7)
    assert out["live"] == 19_500 and out["max_abs_err"] < 1e-3


@pytest.mark.parametrize("modes", [("ann", "ann"), ("exact", "exact")])
def test_capped_index_answers_as_the_uncapped_on_the_card(cuda, full_width, modes):
    """Blocks streamed from pinned memory through K1 and K3: every lane of
    the capped index carries the uncapped index's ids and scores."""
    import chip_smoke

    from cadence_rag_tpu_torch.core.index import DeviceIndexManager
    from cadence_rag_tpu_torch.evals.synth import install_capped_copy

    full, texts, tokens = chip_smoke.build_index(cuda, 40_000, 4000, 8)
    full_width.index_max_device_rows = 16_384
    full_width.cold_block_rows = 8192
    capped = DeviceIndexManager(cuda)
    capped.ensure_call_capacity(1024)
    install_capped_copy(full.chunks, capped.chunks)
    full_width.index_max_device_rows = 0
    capped.artifacts.load_state(full.artifacts.state_arrays())
    assert capped.chunks.cold.count == 40_008 - 16_384
    args, _planned, expected = chip_smoke.plan_batch(full, texts, tokens, 64,
                                                    scoped=modes[0] == "exact")
    kw = dict(chunk_ks=chip_smoke.CHUNK_KS, artifact_ks=chip_smoke.ARTIFACT_KS,
              chunk_mode=modes[0], artifact_mode=modes[1], recall_target=0.95)
    before = (k1.fused_scan.launches, k3.range_topk.launches)
    want = full.collect_packed(full.query_both_packed_async(*args, **kw))
    got = capped.collect_packed(capped.query_both_packed_async(*args, **kw))
    assert k1.fused_scan.launches >= before[0] + 2 + 3 + 2
    moved, apart, worst = chip_smoke.lanes_differ(got, want)
    assert apart == 0 and worst <= 1e-5
    chip_smoke.check_first_lanes(got, expected, "capped")
    # a writer after the dispatch: the blocks in flight are not disturbed
    disp = capped.query_both_packed_async(*args, **kw)
    cold_ids = [int(i) for i in capped.chunks.cold.ids[:4000]]
    capped.chunks.set_tech(cold_ids, np.zeros((4000, 16), np.int32))
    capped.chunks.delete_ids(cold_ids)
    capped.chunks.maybe_compact()
    again = capped.collect_packed(disp)
    assert chip_smoke.lanes_differ(again, got)[:2] == (0, 0)


def test_growth_migration_on_the_card(cuda, full_width):
    """The side-stream copy, the journal's replay and the swap on the card:
    a corpus that migrates while it is written ends bit-equal to a twin that
    grew synchronously."""
    import chip_smoke

    from cadence_rag_tpu_torch.core.index import CorpusIndex

    kw = dict(dim=256, lex_dim=512, tech_slots=16, capacity=65_536, device=cuda)
    mig_c, sync_c = CorpusIndex("chunks", **kw), CorpusIndex("chunks", **kw)
    first = chip_smoke.synthetic_doc_rows(60_000, 1, 3, 256, 512, 16)
    for c in (mig_c, sync_c):
        c.insert(first)
    assert mig_c.start_migration(131_072)
    rng = np.random.default_rng(4)
    for step in range(60):                 # writes while the copy runs and after
        # distinct ids: a scatter that names a row twice may keep either
        # value on the card, live and in the replay alike
        ids = [int(i) for i in rng.choice(np.arange(1, 60_001), size=64, replace=False)]
        vecs = rng.standard_normal((64, 256)).astype(np.float32)
        tech = rng.integers(1, 99, (64, 16)).astype(np.int32)
        lex = rng.integers(-3, 4, (64, 512)).astype(np.int8)
        for c in (mig_c, sync_c):
            c.set_embeddings(ids, vecs)
            c.set_tech(ids, tech)
            c.set_lex(ids, lex)
            c.delete_ids(ids[:2])
            c.insert(chip_smoke.synthetic_doc_rows(8, 100_000 + 8 * step, step, 256, 512, 16))
    assert mig_c._migration.ready.wait(120)
    late = chip_smoke.synthetic_doc_rows(8192, 200_000, 5, 256, 512, 16)
    for c in (mig_c, sync_c):
        c.insert(late)
    assert mig_c.capacity == sync_c.capacity == 131_072 and mig_c._migration is None
    torch.cuda.synchronize()
    assert chip_smoke.same_corpus_state(mig_c, sync_c) is None
