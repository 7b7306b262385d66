"""The port's ANN recall gate and filtered-recall sweep against the JAX
package, on CPU.

``recall_from_arrays`` and the JAX package's mode functions get the same
numpy corpus, queries and mask, and must report the same recall: ``exact``,
``pallas`` (the Pallas kernel in interpret mode vs K2's plain version) and
``ivf`` (JAX's k-means initial rows handed to the port's k-means). ``ann``
is the port's own lane (K1's strided groups; the JAX lane is
``approx_max_k``), so it is held to the JAX gate's floors instead. K2's
contiguous groups collapse under a small contiguous mask at CPU sizes, so
``pallas`` is held to the Pallas kernel, not to those floors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_rag_tpu.ops import topk as jtopk
from cadence_rag_tpu.ops.ivf import build_buckets, ivf_topk, kmeans
from cadence_rag_tpu.ops.pallas_topk import pallas_candidates, pallas_cosine_topk
from cadence_rag_tpu_torch.evals import ann_recall_gate as gate
from cadence_rag_tpu_torch.evals.filtered_recall_sweep import (
    ann_topk, batch_mask, gen_docs, run_sweep,
)

N, Q, K = 4096, 16, 10


@pytest.fixture(scope="module")
def docs():
    """The gate's corpus at N rows, as f32 numpy holding bf16 values."""
    return gen_docs(N, n_centers=max(64, N // 64), seed=0, device="cpu").float().numpy()


def _jax_recall(mode, docs, queries, mask_row, k=K, batch=16):
    """The JAX gate's mode functions and recall count
    (cadence_rag_tpu/evals/ann_recall_gate.py:97-158) on the same arrays."""
    n = docs.shape[0]
    e = jnp.asarray(docs, dtype=jnp.bfloat16)
    if mode == "exact":
        def fn(q, m):
            return jtopk.masked_topk_exact(jtopk.dense_scores(q, e), m, k)
    elif mode == "pallas":
        def fn(q, m):
            return pallas_cosine_topk(q, e, m, k, interpret=True)
    else:
        n_clusters = max(16, int(np.sqrt(n)))
        centroids, assign = kmeans(e, jax.random.PRNGKey(7),
                                   n_clusters=n_clusters, iters=10)
        buckets, overflow = build_buckets(np.asarray(assign), n_clusters,
                                          int(2.0 * n / n_clusters))
        if len(overflow) == 0:
            overflow = np.full(8, -1, dtype=np.int32)
        nprobe = max(4, int(n_clusters * 0.08))

        def fn(q, m):
            return ivf_topk(q, e, centroids, jnp.asarray(buckets),
                            jnp.asarray(overflow), m, k=k, nprobe=nprobe)
    hits = total = 0
    kk = min(k, int(mask_row.sum()))
    for start in range(0, queries.shape[0], batch):
        q = jnp.asarray(queries[start:start + batch])
        m = jnp.asarray(np.broadcast_to(mask_row, (q.shape[0], n)).copy())
        exact_idx = np.asarray(jtopk.masked_topk_exact(
            jtopk.dense_scores(q, e), m, k)[1])
        ann_idx = np.asarray(fn(q, m)[1])
        for row in range(exact_idx.shape[0]):
            hits += len(set(map(int, exact_idx[row, :kk]))
                        & set(map(int, ann_idx[row, :kk])))
            total += kk
    return hits, total


@pytest.mark.parametrize("mode", ["exact", "pallas", "ivf"])
@pytest.mark.parametrize("density,shape", [
    (1.0, "contiguous"), (0.05, "random"), (0.05, "contiguous"),
])
def test_array_function_matches_jax_modes(docs, mode, density, shape):
    t_docs = torch.from_numpy(docs)
    queries, mask_row = gate.make_queries(t_docs, Q, seed=0, density=density,
                                          mask_shape=shape)
    n_clusters = max(16, int(np.sqrt(N)))
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(7), N,
                                        shape=(n_clusters,), replace=False))
    got = gate.recall_from_arrays(docs, queries, mask_row, mode, k=K,
                                  ivf_init_idx=init)
    hits, total = _jax_recall(mode, docs, queries, mask_row)
    assert (got["hits"], got["total"]) == (hits, total)
    if mode == "exact":
        assert got["recall_at_k"] == 1.0


@pytest.mark.parametrize("n,density,shape", [
    (4096, 1.0, "contiguous"), (8192, 0.05, "contiguous"),
    (8192, 0.01, "contiguous"), (8192, 0.05, "random"),
])
def test_ann_mode_meets_the_jax_floors(n, density, shape):
    """tests/kernels/test_ann_recall.py's floors, through the port's lane."""
    result = gate.measure_recall(n=n, n_queries=16, k=10, mode="ann",
                                 density=density, mask_shape=shape)
    assert result["recall_at_k"] >= 0.9, result
    assert set(result) == {"n", "k", "queries", "mode", "ef_search",
                           "recall_target", "density", "mask_shape",
                           "recall_at_k"}


def test_pallas_mode_runs_at_the_gate_default_n():
    """The reference kernel asserts n % block_n == 0, so the JAX gate's
    pallas mode fails at its own default n = 100,000; K2 takes the ragged
    corpus."""
    e = jnp.zeros((1500, 32), dtype=jnp.bfloat16)
    with pytest.raises(AssertionError):
        pallas_candidates(jnp.zeros((1, 32)), e, jnp.ones((1, 1500), bool))
    result = gate.measure_recall(n=100_000, n_queries=8, k=10, mode="pallas")
    assert result["recall_at_k"] >= 0.95, result


def test_sweep_rows_keep_their_mask():
    rows = run_sweep(n=2048, batch=4, k=5, densities=[0.1, 1.0],
                     targets=[0.9, 0.95], mask_shapes=["contiguous", "random"],
                     rounds=1)
    assert [(r["mask"], r["density"], r["recall_target"]) for r in rows] == [
        (s, d, t) for s in ("contiguous", "random") for d in (0.1, 1.0)
        for t in (0.9, 0.95)]
    for r in rows:
        assert set(r) == {"n", "k", "batch", "mask", "density", "recall_target",
                          "recall_at_k", "approx_ms", "exact_ms"}
        assert r["recall_at_k"] >= 0.8 and np.isfinite(r["approx_ms"])
    # the targets run the same scan: one recall per (mask, density)
    assert rows[0]["recall_at_k"] == rows[1]["recall_at_k"]


def test_ann_lane_returns_only_rows_inside_the_mask(docs):
    rng = np.random.default_rng(3)
    mask_row = np.zeros(N, dtype=bool)
    mask_row[rng.choice(N, size=40, replace=False)] = True
    q = torch.from_numpy(docs[rng.choice(np.flatnonzero(mask_row), size=4)])
    vals, pos = ann_topk(q, torch.from_numpy(docs).to(torch.bfloat16),
                         batch_mask(mask_row, 4, "cpu"), 10)
    fin = torch.isfinite(vals)
    assert fin.all()
    assert mask_row[pos.numpy()].all()


def test_hnsw_mode(docs):
    from cadence_rag_tpu.native import hnsw

    if not hnsw.available():
        pytest.skip("native hnsw unavailable (no C++ toolchain)")
    queries, mask_row = gate.make_queries(torch.from_numpy(docs), Q, seed=0,
                                          density=1.0, mask_shape="contiguous")
    got = gate.recall_from_arrays(docs, queries, mask_row, "hnsw", k=K)
    assert got["recall_at_k"] >= 0.95, got
    mask_row[: N // 2] = False
    with pytest.raises(ValueError, match="unfiltered"):
        gate.recall_from_arrays(docs, queries, mask_row, "hnsw", k=K)


def test_unknown_mode_raises(docs):
    with pytest.raises(ValueError, match="unknown mode"):
        gate.mode_topk("approx", torch.from_numpy(docs), k=K)
