"""The in-process models on a CUDA card against the CPU and their plain paths:
the Qwen3 encoder's card path (bf16 tensor-core GEMMs with f32 outputs) at
the 4b preset's widths and two layers against its plain path (f32 products of
bf16-rounded operands) on the card; ``models/prng`` drawn on the card against
the CPU (bits and bf16 normals identical, f32 normals within a few ulps:
``log1p`` may round differently); the committed embedder and reranker
artifacts on the card against the CPU; training on the card: the card
path's gradients (bf16 GEMMs, cotangents rounded to bf16) against the plain
path's for both models at the gates' recipes, one ``train_step`` on the
card, and the training entry points' pin of full-precision f32 matmuls.

Needs a card, so every test here carries the ``cuda`` marker and skips
without one. Run them on the machine with the card (no jax there) with:

    python -m pytest --noconftest -m cuda tests/test_torch_models_cuda.py -q
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.models import embedder as emb
from cadence_rag_tpu_torch.models import prng, qwen3, reranker

pytestmark = pytest.mark.cuda

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
QWEN3_ATOL = 1e-2        # unit vectors, bf16 roundings of the residual stream
QWEN3_MIN_COS = 0.999
F32_NORMAL_ATOL = 1e-6
VEC_ATOL = 1e-5
# the card path's bf16 GEMMs sum in cuBLAS's order; chip_smoke.py read
# 9.05e-05 against the CPU on its own six texts
CARD_VEC_ATOL = 2e-4
# card path against plain path, gradients: each leaf's max |difference| over
# the larger of its max |gradient| and GRAD_FLOOR times the model's largest
# (the reranker's final_ln.bias gradient is zero in exact arithmetic). The
# card rounds each product's cotangent to bf16 (JAX's transpose of a bf16
# dot); read on an H100: the embedder 7.3e-3, the reranker 2.1e-2 but for
# pos_emb 8.1e-2, whose gradient sums the hi and lo pairs' opposite
# contributions at the query's shared positions, so the roundings weigh more
# against what is left
CARD_GRAD_RTOL = 0.1
GRAD_FLOOR = 1 / 64
CARD_LOSS_ATOL = 1e-3
PARAPHRASE_RECIPE = dict(vocab_buckets=8192, d_model=128, n_layers=2, n_heads=4,
                         d_ff=512, max_len=48, embed_dim=1024)
RERANK_RECIPE = dict(vocab_buckets=8192, d_model=128, n_layers=2, n_heads=4,
                     d_ff=512, max_len=64, prior_residual=True, prior_gain=1.0)
TEXTS = ["the ledger replica fell behind after the failover to the standby region",
         "rolling back to v2.3.1 stopped the resets on billing-api",
         "quota broker throttled the export runner overnight",
         "x"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_qwen3_card_path_against_plain_at_4b_widths(cuda):
    cfg = dataclasses.replace(qwen3.PRESETS["4b"], n_layers=2)
    model = qwen3.init_params(cfg, prng.PRNGKey(0), cuda)
    texts = TEXTS * 8
    tokens = torch.from_numpy(qwen3.batch_tokenize(texts, cfg, seq_len=16))
    card, plain = model(tokens), model(tokens, plain=True)
    torch.cuda.synchronize()
    assert card.shape == plain.shape == (len(texts), 1024)
    assert torch.isfinite(card).all() and torch.isfinite(plain).all()
    assert float((card - plain).abs().max()) <= QWEN3_ATOL
    assert float((card * plain).sum(dim=1).min()) >= QWEN3_MIN_COS


def test_qwen3_weights_on_the_card_are_the_cpus(cuda):
    cfg = dataclasses.replace(qwen3.PRESETS["4b"], n_layers=1, vocab_buckets=1024)
    on_card = qwen3.init_params(cfg, prng.PRNGKey(3), cuda)
    on_cpu = qwen3.init_params(cfg, prng.PRNGKey(3), "cpu")
    for name, param in on_cpu.named_parameters():
        assert torch.equal(getattr(on_card, name).cpu(), param), name


def test_prng_on_the_card(cuda):
    key = prng.split(prng.PRNGKey(2**33 + 5), 3)[1]
    shape = (3, 1000, 37)
    assert torch.equal(prng.bits(key, shape, cuda).cpu(), prng.bits(key, shape))
    bf16 = prng.normal(key, shape, torch.bfloat16, cuda)
    assert torch.equal(bf16.cpu(), prng.normal(key, shape, torch.bfloat16))
    f32 = prng.normal(key, shape, torch.float32, cuda)
    err = (f32.cpu() - prng.normal(key, shape, torch.float32)).abs().max()
    assert float(err) <= F32_NORMAL_ATOL


def test_embedder_artifact_on_the_card(cuda):
    path = str(ARTIFACTS / "embedder" / "tuned_small_v1.npz")
    card, cfg = emb.load_params(path, cuda)
    cpu, _ = emb.load_params(path, "cpu")
    assert float((card.bag_emb.cpu() - cpu.bag_emb).abs().max()) <= F32_NORMAL_ATOL
    tokens = torch.from_numpy(emb.batch_tokenize(TEXTS, cfg))
    got = card(tokens)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), cpu(tokens).numpy(),
                               atol=CARD_VEC_ATOL, rtol=0)
    np.testing.assert_allclose(card(tokens, plain=True).cpu().numpy(),
                               cpu(tokens).numpy(), atol=VEC_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["distilled_v1", "paraphrase_v1", "two_register_v1"])
def test_reranker_artifact_on_the_card(cuda, name):
    path = str(ARTIFACTS / "reranker" / f"{name}.npz")
    card, cfg = reranker.load_params(path, cuda)
    cpu, _ = reranker.load_params(path, "cpu")
    tokens = np.stack([reranker.pair_tokenize("replica lag after failover", d, cfg)
                       for d in TEXTS])
    prior = np.linspace(-1.0, 1.0, len(TEXTS), dtype=np.float32)
    got = reranker.score_pairs(card, tokens, prior)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               reranker.score_pairs(cpu, tokens, prior).numpy(),
                               atol=1e-4, rtol=1e-4)


def _tokens(rng, batch, max_len, vocab, low=1):
    tokens = rng.integers(low, vocab, size=(batch, max_len)).astype(np.int32)
    for row, length in enumerate(rng.integers(3, max_len + 1, size=batch)):
        tokens[row, length:] = 0
    return torch.from_numpy(tokens)


def _card_against_plain(model, loss_of):
    """-> (|loss difference|, {leaf: max |card - plain| / max(max |plain|,
    GRAD_FLOOR x the model's largest |plain|)})."""
    losses, grads = [], []
    for plain in (False, True):
        loss = loss_of(plain)
        losses.append(float(loss.detach()))
        grads.append(emb.gradients(model, loss))
    card, plain = grads
    top = max(float(g.abs().max()) for g in plain.values() if g is not None)
    rel = {}
    for name, g in plain.items():
        if g is None:
            assert card[name] is None, name
            continue
        scale = max(float(g.abs().max()), GRAD_FLOOR * top)
        rel[name] = float((card[name] - g).abs().max()) / scale
    return abs(losses[0] - losses[1]), rel


def _recipe_texts(seed=5):
    """One batch of 32 from the paraphrase corpus (chip_smoke.py's): the
    summaries, their calls' first transcript lines, another call's line."""
    from cadence_rag_tpu_torch.evals.train_corpus import generate_calls, train_eval_split

    calls = generate_calls(train_eval_split(seed=0)[0], seed=0)
    pick = np.random.default_rng(seed).choice(len(calls), 32, replace=False)
    return ([calls[i].summary for i in pick], [calls[i].transcript[0] for i in pick],
            [calls[(i + 1) % len(calls)].transcript[0] for i in pick])


def test_embedder_card_gradients_against_plain(cuda):
    cfg = emb.EmbedderConfig(**PARAPHRASE_RECIPE)
    model = emb.trainable(emb.init_params(cfg, prng.PRNGKey(0), cuda))
    a, p, n = (torch.from_numpy(emb.batch_tokenize(t, cfg)) for t in _recipe_texts())
    loss_diff, rel = _card_against_plain(
        model, lambda plain: emb.info_nce_loss(model, a, p, negatives=n, plain=plain))
    assert loss_diff <= CARD_LOSS_ATOL
    assert max(rel.values()) <= CARD_GRAD_RTOL, rel
    assert "bag_emb" not in rel and "mix" not in rel   # frozen: no gradient


def test_reranker_card_gradients_against_plain(cuda):
    cfg = reranker.RerankerConfig(**RERANK_RECIPE)
    model = emb.trainable(reranker.init_params(cfg, prng.PRNGKey(0), cuda))
    queries, positives, negatives = _recipe_texts()
    hi = np.stack([reranker.pair_tokenize(q, d, cfg) for q, d in zip(queries, positives)])
    lo = np.stack([reranker.pair_tokenize(q, d, cfg) for q, d in zip(queries, negatives)])
    p_hi, p_lo = np.random.default_rng(6).normal(size=(2, 32)).astype(np.float32)
    loss_diff, rel = _card_against_plain(
        model, lambda plain: reranker.pairwise_loss(model, hi, lo, p_hi, p_lo, plain))
    assert loss_diff <= CARD_LOSS_ATOL
    assert max(rel.values()) <= CARD_GRAD_RTOL, rel


def test_train_step_on_the_card(cuda):
    cfg = emb.EmbedderConfig(**PARAPHRASE_RECIPE)
    model = emb.init_params(cfg, prng.PRNGKey(0), cuda)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = emb.adamw_init(model)
    rng = np.random.default_rng(2)
    a, p, n = (_tokens(rng, 32, cfg.max_len, cfg.vocab_buckets) for _ in range(3))
    lr = 3e-4
    model, opt, loss = emb.train_step(model, opt, a, p, negatives=n, lr=lr)
    torch.cuda.synchronize()
    assert loss.is_cuda and bool(torch.isfinite(loss))
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    for name, param in model.named_parameters():
        assert param.is_cuda and bool(torch.isfinite(param).all()), name
        assert not torch.equal(param, before[name]), name   # decayed at least
    # the frozen bag and mixture take no gradient but are decayed, as in JAX
    mix0 = before["mix"].cpu().numpy()
    want = mix0 - np.float32(lr) * (np.float32(0.01) * mix0)
    np.testing.assert_allclose(model.mix.detach().cpu().numpy(), want, rtol=1e-7)
    assert float(opt["mu"]["mix"].abs().max()) == 0.0


def test_training_entry_points_pin_full_precision_f32_matmul(cuda, tmp_path):
    from cadence_rag_tpu_torch.config import settings
    from cadence_rag_tpu_torch.evals import geometry_gate
    from cadence_rag_tpu_torch.scripts import train_embedder, train_reranker

    pairs = [(f"anchor text {i} billing-api", f"positive text {i} billing-api")
             for i in range(8)]
    triples = [(f"query {i}", f"higher doc {i}", f"lower doc {i}") for i in range(8)]
    saved = settings.embeddings_dim
    settings.embeddings_dim = 32
    try:
        for run in (
            lambda: train_embedder.train(
                pairs, None, out_path=str(tmp_path / "e.npz"), steps=1, batch=4,
                lr=1e-4, d_model=32, n_layers=1, vocab_buckets=256, max_len=16,
                device=cuda),
            lambda: train_reranker.train(
                triples, out_path=str(tmp_path / "r.npz"), steps=1, batch=4,
                lr=1e-4, d_model=32, n_layers=1, vocab_buckets=256, max_len=16,
                device=cuda),
            lambda: geometry_gate.run_gates(
                np.eye(64, 32, dtype=np.float32), np.eye(4, 32, dtype=np.float32),
                k=2, recall_target=0.95, skip_ivf=True, device=cuda),
        ):
            torch.backends.cuda.matmul.allow_tf32 = True
            run()
            assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        settings.embeddings_dim = saved
