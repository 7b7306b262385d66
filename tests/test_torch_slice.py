"""The whole /retrieve device slice, JAX package vs port, on CPU.

One corpus is built in the JAX package's DeviceIndexManager, carried into
the port's with ``load_state(state_arrays())``, and the same planned batch
goes through both packages' ``query_both_packed_async`` -> ``collect_packed``
with device RRF off and on, in modes exact and ann.

Tolerances: exact lanes and tech lanes are identical; the port's ann lanes
(dense in ann mode, and lexical always — both come from kernel K1's
top-1-per-group candidates) reach recall >= 0.95 against the JAX lanes
(JAX's approx_max_k is exact on CPU); fused RRF scores agree within 1e-6
(f32 sums of at most three terms).
"""

import numpy as np
import pytest
import torch

from cadence_rag_tpu.config import settings
from cadence_rag_tpu.core.index import DocRow as JaxDocRow
from cadence_rag_tpu.core.index import get_index as jax_get_index
from cadence_rag_tpu.embed import embed_texts
from cadence_rag_tpu.ingest import featurize
from cadence_rag_tpu_torch.core.index import DeviceIndexManager
from cadence_rag_tpu_torch.ops.fusion import rrf_merge_rect

INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max
N_CALLS = 24
CHUNK_KS = (50, 50, 50)
ARTIFACT_KS = (10, 10, 50)
WORDS = [
    "gateway", "latency", "rollback", "kafka", "consumer", "lag", "tiering",
    "cluster", "retry", "budget", "azure", "lenovo", "bake-off", "storage",
    "object", "upgrade", "partition", "rebalance", "certificate", "handshake",
    "pipeline", "review", "quarterly", "ingest", "spike", "window", "broker",
    "replica", "shard", "index", "backfill", "timeout", "deadline", "owner",
]
TECH = [f"srv-{i}" for i in range(30)] + [f"v2.{i}.1" for i in range(12)]


def _texts(rng, n):
    texts, tokens = [], []
    for _ in range(n):
        toks = list(rng.choice(TECH, size=int(rng.integers(0, 3)), replace=False))
        words = list(rng.choice(WORDS, size=int(rng.integers(5, 11))))
        texts.append(" ".join(words + toks))
        tokens.append(toks)
    return texts, tokens


def _rows(rng, n, first_id, starts):
    texts, tokens = _texts(rng, n)
    sigs = featurize.lexical_signatures_batch(texts, avgdl=10.0)
    vecs = embed_texts(texts).vectors
    # calls are contiguous runs of rows sharing one start second
    calls = np.sort(rng.integers(0, N_CALLS, size=n))
    rows = []
    for i in range(n):
        sig, touched, dl = sigs[i]
        rows.append(JaxDocRow(
            doc_id=first_id + i, call_seq=int(calls[i]),
            started_sec=int(starts[calls[i]]), lex_sig=sig, lex_dl=dl,
            lex_touched=touched, tech=featurize.tech_slots(tokens[i]),
            embedding=None if rng.random() < 0.15 else vecs[i],
        ))
    return rows, texts, tokens


def _build(n_chunks, n_artifacts, seed):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(1_600_000_000, 1_700_000_000, N_CALLS))
    jidx = jax_get_index()
    jidx.ensure_call_capacity(N_CALLS)
    chunk_rows, texts, tokens = _rows(rng, n_chunks, 1, starts)
    jidx.chunks.insert(chunk_rows)
    art_rows, _, _ = _rows(rng, n_artifacts, 10_000, starts)
    jidx.artifacts.insert(art_rows)
    tidx = DeviceIndexManager("cpu")
    tidx.ensure_call_capacity(N_CALLS)
    for name in ("chunks", "artifact_chunks"):
        state = jidx.corpus(name).state_arrays()
        tidx.corpus(name).load_state(state)
        # bf16 rows arrive as ml_dtypes bfloat16 and are reinterpreted
        assert state["emb"].dtype.name == "bfloat16"
        n = state["ids"].shape[0]
        np.testing.assert_array_equal(
            tidx.corpus(name).emb[:n].view(torch.int16).numpy(),
            state["emb"].view(np.int16))
        assert tidx.corpus(name).capacity == jidx.corpus(name).capacity
    return rng, jidx, tidx, texts, tokens


def _batch(rng, texts, tokens, b, scoped):
    picks = rng.integers(0, len(texts), size=b)
    q_texts = [texts[i] + " " + str(rng.choice(WORDS)) for i in picks]
    q_tokens = [tokens[i] for i in picks]
    q_emb = np.stack(embed_texts(q_texts).vectors).astype(np.float32)
    feats = featurize.query_lexical_features_batch(q_texts)
    structures = featurize.query_tech_structures_batch(q_tokens)
    width = max(s.shape[0] for s, _ in structures)
    q_tech = np.zeros((b, width), dtype=np.int32)
    for i, (s, _dropped) in enumerate(structures):
        q_tech[i, : s.shape[0]] = s
    allowed = np.ones((b, 256), dtype=bool)
    dmin = np.full(b, INT32_MIN + 1, dtype=np.int32)
    dmax = np.full(b, INT32_MAX, dtype=np.int32)
    if scoped:
        allowed[:] = False
        for i in range(b):
            allowed[i, rng.choice(N_CALLS, size=8, replace=False)] = True
        dmin[1] = 1_650_000_000
    return q_emb, feats, q_tech, allowed, dmin, dmax


def _run(idx, args, mode, fuse):
    disp = idx.query_both_packed_async(
        *args, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS,
        chunk_mode=mode, artifact_mode=mode, recall_target=0.95,
        fuse_rrf=fuse)
    return idx.collect_packed(disp)


def _identical(got, ref, what):
    g_ids, g_scores, g_counts = got
    r_ids, r_scores, r_counts = ref
    np.testing.assert_array_equal(g_counts, r_counts, err_msg=what)
    for b in range(len(r_counts)):
        c = int(r_counts[b])
        np.testing.assert_array_equal(g_ids[b, :c], r_ids[b, :c], err_msg=what)
        np.testing.assert_allclose(g_scores[b, :c], r_scores[b, :c],
                                   rtol=1e-5, atol=1e-5, err_msg=what)


def _recall(got, ref):
    hit = total = 0
    for b in range(len(ref[2])):
        want = set(ref[0][b, : int(ref[2][b])].tolist())
        have = set(got[0][b, : int(got[2][b])].tolist())
        hit += len(want & have)
        total += len(want)
    return hit / max(total, 1)


def _check_lanes(t_out, j_out, mode, exact_lex):
    assert t_out.keys() == j_out.keys()
    dense = "dense" in j_out
    for lane in ("tech", "dense") if mode == "exact" and dense else ("tech",):
        _identical(t_out[lane], j_out[lane], lane)
    approx = ["lex"] + (["dense"] if mode != "exact" and dense else [])
    for lane in approx:
        if exact_lex:
            _identical(t_out[lane], j_out[lane], lane)
        else:
            assert _recall(t_out[lane], j_out[lane]) >= 0.95, lane


def _check_fused(t_m, j_m):
    t_ids, t_scores, t_masks, t_counts = t_m
    j_ids, j_scores, j_masks, j_counts = j_m
    np.testing.assert_array_equal(t_counts, j_counts)
    for b in range(len(j_counts)):
        c = int(j_counts[b])
        np.testing.assert_array_equal(t_ids[b, :c], j_ids[b, :c])
        np.testing.assert_array_equal(t_masks[b, :c], j_masks[b, :c])
        np.testing.assert_allclose(t_scores[b, :c], j_scores[b, :c], atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "ann"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("dense", [True, False])
def test_slice_small_corpus_identical(tmp_store, monkeypatch, mode, fuse, dense):
    """At capacity 128 every K1 group holds one row, so even the port's
    approximate lanes are exact: everything must match the JAX package.
    ``dense=False`` is a batch without query embeddings (no provider)."""
    monkeypatch.setattr(settings, "index_initial_capacity", 128)
    rng, jidx, tidx, texts, tokens = _build(110, 70, seed=1)
    assert jidx.chunks.capacity == 128
    for scoped in (False, True):
        args = _batch(rng, texts, tokens, 8, scoped)
        if not dense:
            args = (None,) + args[1:]
        t_out = _run(tidx, args, mode, fuse)
        j_out = _run(jidx, args, mode, fuse)
        for t_c, j_c in zip(t_out, j_out):
            if fuse:
                _check_fused(t_c["__rrf__"], j_c["__rrf__"])
            else:
                _check_lanes(t_c, j_c, mode, exact_lex=True)


@pytest.mark.parametrize("mode", ["exact", "ann"])
def test_slice_larger_corpus(tmp_store, mode):
    rng, jidx, tidx, texts, tokens = _build(7000, 400, seed=2)
    assert jidx.chunks.capacity == 8192
    args = _batch(rng, texts, tokens, 8, scoped=False)
    t_lanes = _run(tidx, args, mode, fuse=False)
    j_lanes = _run(jidx, args, mode, fuse=False)
    for t_c, j_c in zip(t_lanes, j_lanes):
        _check_lanes(t_c, j_c, mode, exact_lex=False)
    # device RRF over the port's lanes equals the host oracle over them
    t_fused = _run(tidx, args, mode, fuse=True)
    for t_c, t_m in zip(t_lanes, t_fused):
        rect = {"bm25": t_c["lex"], "tech_tokens": t_c["tech"],
                "dense": t_c["dense"]}
        host = rrf_merge_rect(rect)
        ids, scores, masks, counts = t_m["__rrf__"]
        for b, (h_ids, h_scores, h_masks, _names) in enumerate(host):
            c = int(counts[b])
            assert c == h_ids.size
            np.testing.assert_array_equal(ids[b, :c], h_ids)
            np.testing.assert_array_equal(masks[b, :c], h_masks)
            np.testing.assert_allclose(scores[b, :c], h_scores, atol=1e-6)


def test_cold_start_one_corpus_empty(tmp_store):
    """While one corpus is empty both packages take the per-corpus path."""
    rng = np.random.default_rng(3)
    starts = np.sort(rng.integers(1_600_000_000, 1_700_000_000, N_CALLS))
    rows, texts, tokens = _rows(rng, 40, 1, starts)
    jidx = jax_get_index()
    jidx.chunks.insert(rows)
    tidx = DeviceIndexManager("cpu")
    tidx.chunks.insert(rows)
    args = _batch(rng, texts, tokens, 4, scoped=False)
    t_out = _run(tidx, args, "exact", fuse=False)
    j_out = _run(jidx, args, "exact", fuse=False)
    _check_lanes(t_out[0], j_out[0], "exact", exact_lex=True)
    assert all(t_out[1][lane][0].shape == (4, 0) for lane in t_out[1])
