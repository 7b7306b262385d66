"""The ``model`` mesh axis on a CUDA card: the Qwen3 tiny and 1b presets
tensor-parallel against unsharded on the card path (bf16 tensor-core GEMMs
with f32 outputs), over a mesh of the one card repeated, and one dp+tp
training step of the embedder against the unsharded step on the same batch.

Tolerances: the vectors within TP_ATOL with a cosine of at least TP_MIN_COS
per vector (JAX's own tolerance for tensor-parallel against one device,
``tests/unit/test_qwen3.py``; the row-parallel partials sum in another order,
so a bf16 activation can round the other way); the step's loss within
``tests/test_torch_training.py``'s TRAJECTORY_ATOL and the parameters' change
within ``chip_smoke.EMB_TP_CHANGE_RTOL`` of the unsharded change, as a share
of it (``chip_smoke.param_change_gap``: a step that changes nothing reads 1).

Needs a card, so every test here carries the ``cuda`` marker and skips
without one. Run them on the machine with the card (no jax there) with:

    python -m pytest --noconftest -m cuda tests/test_torch_tensor_parallel_cuda.py -q
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.models import embedder as emb
from cadence_rag_tpu_torch.models import prng, qwen3
from cadence_rag_tpu_torch.parallel.mesh import make_mesh
from chip_smoke import EMB_TP_CHANGE_RTOL, param_change_gap

pytestmark = pytest.mark.cuda

TP_ATOL = 2e-2
TP_MIN_COS = 0.999
LOSS_ATOL = 1.5e-2
LR = 1e-4
RECIPE = dict(vocab_buckets=8192, d_model=128, n_layers=2, n_heads=4, d_ff=512,
              max_len=48, embed_dim=1024)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tokens(rng, batch, seq, vocab):
    tokens = rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)
    for row, length in enumerate(rng.integers(2, seq + 1, size=batch)):
        tokens[row, length:] = 0
    return tokens


@pytest.mark.parametrize("preset, spec, layers", [
    ("tiny", "data:2,model:4", None), ("1b", "data:1,model:2", 4)])
def test_qwen3_tensor_parallel_on_the_card(cuda, preset, spec, layers):
    cfg = qwen3.PRESETS[preset]
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    n = int(np.prod([int(p.split(":")[1]) for p in spec.split(",")]))
    mesh = make_mesh(spec, [cuda] * n)
    whole = qwen3.init_params(cfg, prng.PRNGKey(0), cuda)
    born = qwen3.init_params(cfg, prng.PRNGKey(0), cuda, mesh=mesh)
    gathered = qwen3.gather_params(born).params()
    for name, value in whole.params().items():
        assert torch.equal(gathered[name], value), name
    tokens = _tokens(np.random.default_rng(0), 8, 16, cfg.vocab_buckets)
    tp, ref = born(tokens), whole(torch.from_numpy(tokens))
    assert tp.device.type == "cuda" and torch.isfinite(tp).all()
    assert float((tp - ref).abs().max()) <= TP_ATOL
    assert float((tp * ref).sum(dim=1).min()) >= TP_MIN_COS


def test_dp_tp_step_against_the_unsharded_step(cuda):
    cfg = emb.EmbedderConfig(**RECIPE)
    ref = emb.init_params(cfg, prng.PRNGKey(0), cuda)
    sharded = emb.shard_params(copy.deepcopy(ref), make_mesh("data:2,model:2", [cuda] * 4))
    start = {name: value.detach().clone() for name, value in ref.named_parameters()}
    rng = np.random.default_rng(1)
    a, p = (_tokens(rng, 32, cfg.max_len, cfg.vocab_buckets) for _ in range(2))
    _m, _o, want = emb.train_step(ref, emb.adamw_init(ref), a, p, lr=LR)
    _m, _o, got = emb.train_step(sharded, emb.adamw_init(sharded.params.leaves()), a, p,
                                 lr=LR)
    assert abs(float(got) - float(want)) <= LOSS_ATOL
    with torch.no_grad():
        stepped = dict(emb.gather_params(sharded).named_parameters())
        gap = param_change_gap(stepped, dict(ref.named_parameters()), start)
    assert gap <= EMB_TP_CHANGE_RTOL
