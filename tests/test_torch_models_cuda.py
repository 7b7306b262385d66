"""The in-process models on a CUDA card against the CPU and their plain paths:
the Qwen3 encoder's card path (bf16 tensor-core GEMMs with f32 outputs) at
the 4b preset's widths and two layers against its plain path (f32 products of
bf16-rounded operands) on the card; ``models/prng`` drawn on the card against
the CPU (bits and bf16 normals identical, f32 normals within a few ulps:
``log1p`` may round differently); the committed embedder and reranker
artifacts on the card against the CPU.

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
