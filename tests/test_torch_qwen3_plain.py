"""The port's Qwen3 encoder (``models/qwen3.py``) against the benchmark's
plain reference (``rag_bench/reference/qwen3_plain.py``), on the CPU.

- ``Qwen3Encoder`` on seeded random weights gives the reference's vectors
  within PLAIN_ATOL, at the tiny preset and at a 3-layer GQA 4:1 shape,
  on batches of mixed length (padding, the causal mask and last-token
  pooling). The port rounds every product's operands and its residual
  stream to bfloat16 where the reference keeps float32 on the same
  bfloat16 weights; the widest gap this leaves is 2e-3 to 4e-3 on these
  shapes. The control, each product's operands in float8_e4m3fn, misses
  the same tolerance.
- A checkpoint the benchmark's ``prepare`` writes loads through
  ``load_params`` to exactly the tensors the reference reads, its
  ``rope_theta`` and ``rms_eps`` included (``__cfg_f__``); the port's own
  ``save_params`` writes that key only off the defaults, so a default
  config's file stays the JAX package's.
- The reference's hash tokenizer gives the port's ids.
- ``metrics/_encoder``'s operation count at the published widths: 7.27
  GFLOP a token.
- The provider is made anew when its checkpoint setting changes.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cadence_rag_tpu_torch.models import prng
from cadence_rag_tpu_torch.models import qwen3 as q3
from rag_bench.metrics import _encoder
from rag_bench.reference import qwen3_plain as plain
from rag_bench.spec import ROOT, load_file
from torch_parity import port_store  # noqa: F401  (fixture)

# bf16-rounded operands and residual stream against float32 on the same
# weights: 2e-3 to 4e-3 on these shapes; the fp8 control reads 4e-2 to
# 7e-2
PLAIN_ATOL = 1e-2
TINY = q3.PRESETS["tiny"]
GQA = q3.Qwen3Config(vocab_buckets=1024, d_model=256, n_layers=3, n_heads=8,
                     n_kv_heads=2, head_dim=32, d_ff=512, max_len=64, embed_dim=128)
TEXTS = ["hello world", "Other Text entirely", "alpha beta gamma delta epsilon",
         "one two three four five six seven eight nine ten eleven twelve",
         "x", "the ECONNRESET storm hit the object store gateway",
         "naïve café über straße"]
CONFIG = json.loads((ROOT / "rag_bench" / "configs" / "cadence-1m-qwen3.json").read_text())


def _group(cfg: q3.Qwen3Config) -> dict:
    """A configuration whose ``query_encoder`` group has ``cfg``'s widths."""
    return dict(CONFIG, query_encoder=dict(
        CONFIG["query_encoder"], vocab_size=cfg.vocab_buckets, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        intermediate_size=cfg.d_ff, max_input_tokens=cfg.max_len,
        output_dim=cfg.embed_dim, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps))


@pytest.fixture(scope="module")
def embedder():
    return load_file(ROOT / "rag_bench" / "reference" / "embedders" / "qwen3.py",
                     "rag_bench_embedder_qwen3_test")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, embedder):
    """{name: (config, checkpoint path)}: the tiny preset's seeded weights
    saved by the port, the GQA shape's drawn by the benchmark's
    ``prepare``."""
    tmp = tmp_path_factory.mktemp("qwen3_plain")
    (tmp / "tiny").mkdir()
    tiny = tmp / "tiny" / "port.npz"
    q3.save_params(str(tiny), q3.init_params(TINY, prng.PRNGKey(5), "cpu"))
    (tmp / "gqa").mkdir()
    got = embedder.prepare(_group(GQA), 2**31 + 9, tmp / "gqa", "cpu")
    return {"tiny": (_group(TINY), tiny), "gqa": (_group(GQA),
                                                  Path(got["qwen3_params_path"]))}


def _vectors(config, path, gemm=plain.matmul):
    model, cfg = q3.load_params(str(path), "cpu")
    ids = q3.batch_tokenize(TEXTS, cfg, seq_len=q3.seq_bucket(
        max(len(t.split()) for t in TEXTS), cfg))
    port = q3.encode(model, ids).double().numpy()
    want = plain.embed(plain.read_params(path), plain.shape(config), TEXTS, "cpu", gemm)
    return port, want


@pytest.mark.parametrize("name", ["tiny", "gqa"])
def test_the_port_gives_the_plain_references_vectors(checkpoints, name):
    config, path = checkpoints[name]
    port, want = _vectors(config, path)
    assert port.shape == want.shape == (len(TEXTS), plain.shape(config).out_dim)
    np.testing.assert_allclose(np.linalg.norm(want, axis=1), 1.0, atol=1e-12)
    gap = np.abs(port - want).max()
    assert 0 < gap <= PLAIN_ATOL
    # each text's vector is its own: padding and batch neighbours change
    # nothing
    alone = plain.embed(plain.read_params(path), plain.shape(config), TEXTS[3:4], "cpu")
    np.testing.assert_allclose(alone[0], want[3], atol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "gqa"])
def test_the_fp8_control_misses_the_tolerance(checkpoints, name):
    config, path = checkpoints[name]
    port, want = _vectors(config, path)
    _, control = _vectors(config, path, plain.fp8_matmul)
    assert np.abs(control - want).max() > PLAIN_ATOL
    assert np.abs(control - want).max() > 3 * np.abs(port - want).max()


def test_a_prepared_checkpoint_loads_to_the_tensors_the_reference_reads(
        tmp_path, embedder):
    cfg = dataclasses.replace(GQA, n_layers=2, rope_theta=10_000.0, rms_eps=1e-5)
    config = _group(cfg)
    path = Path(embedder.prepare(config, 7, tmp_path, "cpu")["qwen3_params_path"])
    model, loaded = q3.load_params(str(path), "cpu")
    assert loaded == cfg
    want = plain.read_params(path)
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, param in model.named_parameters():
        assert param.dtype == want[name].dtype and torch.equal(param, want[name]), name
    assert not want["tok_emb"][0].any()          # the pad row
    # the seed draws the weights
    again = embedder.draw(plain.shape(config), 7, "cpu")
    other = embedder.draw(plain.shape(config), 8, "cpu")
    assert np.array_equal(again["wq"], want["wq"].view(torch.int16).numpy().view(np.uint16))
    assert not np.array_equal(other["wq"], again["wq"])


def test_save_params_carries_the_float_fields_off_the_defaults(tmp_path):
    model = q3.init_params(dataclasses.replace(TINY, rope_theta=5e5, rms_eps=1e-5),
                           prng.PRNGKey(1), "cpu")
    q3.save_params(str(tmp_path / "odd.npz"), model)
    assert q3.load_params(str(tmp_path / "odd.npz"), "cpu")[1] == model.cfg
    q3.save_params(str(tmp_path / "default.npz"),
                   q3.init_params(TINY, prng.PRNGKey(1), "cpu"))
    with np.load(tmp_path / "default.npz") as data:
        assert "__cfg_f__" not in data.files
    assert q3.load_params(str(tmp_path / "default.npz"), "cpu")[1] == TINY


@pytest.mark.parametrize("cfg", [TINY, q3.PRESETS["4b"]], ids=["tiny", "4b"])
def test_the_references_tokenizer_gives_the_ports_ids(cfg):
    want = q3.batch_tokenize(TEXTS, cfg, seq_len=16)
    got = plain.tokenize(TEXTS, plain.shape(_group(cfg)))
    assert got.shape == (len(TEXTS), 12)
    np.testing.assert_array_equal(got, want[:, :12])
    assert not want[:, 12:].any()


def test_the_operation_count_at_the_published_widths():
    enc = CONFIG["query_encoder"]
    # q and o 2560 x 4096, k and v 2560 x 1024, three 2560 x 9728, 36 layers
    assert _encoder.matrix_params(enc) == 36 * (2 * 2560 * 4096 + 2 * 2560 * 1024
                                                + 3 * 2560 * 9728) == 3_633_315_840
    assert _encoder.useful_flop(enc, 1, 0) == 7_266_631_680
    # a nine-token text: 45 causal pairs, 4 x 32 heads x 128 a pair a layer
    assert _encoder.useful_flop(enc, 9, 45) == pytest.approx(
        9 * 7_266_631_680 + 36 * 4 * 32 * 128 * 45)
    assert _encoder.matrix_params(CONFIG["query_encoder"]) == sum(
        int(np.prod(shape)) for name, shape in plain.param_shapes(
            plain.shape(CONFIG)).items()
        if name.startswith("w"))


def test_the_provider_is_made_anew_for_another_checkpoint(port_store, monkeypatch,
                                                         tmp_path):
    from cadence_rag_tpu_torch import device

    monkeypatch.setattr(device, "_models_device", torch.device("cpu"))
    monkeypatch.setattr(port_store, "embeddings_dim", TINY.embed_dim)
    monkeypatch.setattr(q3.Qwen3EmbeddingProvider, "_instance", None)
    paths = []
    for seed in (1, 2):
        paths.append(str(tmp_path / f"{seed}.npz"))
        q3.save_params(paths[-1], q3.init_params(TINY, prng.PRNGKey(seed), "cpu"))
    monkeypatch.setattr(port_store, "qwen3_params_path", paths[0])
    first = q3.Qwen3EmbeddingProvider.shared()
    assert q3.Qwen3EmbeddingProvider.shared() is first
    monkeypatch.setattr(port_store, "qwen3_params_path", paths[1])
    second = q3.Qwen3EmbeddingProvider.shared()
    assert second is not first
    assert not torch.equal(second.model.wq, first.model.wq)


def test_the_served_query_reaches_the_index_rounded_to_bfloat16_once(
        port_store, monkeypatch, checkpoints):  # noqa: F811
    """The index scores a query in bfloat16 after the packed upload's
    float16 (``ops/pack``). The provider's vectors cross it as their own
    values, the single rounding the reference search makes; ``encode``'s
    float32 vectors would be rounded twice, and some elements land one
    bfloat16 step off."""
    from cadence_rag_tpu_torch import device
    from cadence_rag_tpu_torch.ops import pack

    monkeypatch.setattr(device, "_models_device", torch.device("cpu"))
    monkeypatch.setattr(port_store, "embeddings_dim", GQA.embed_dim)
    monkeypatch.setattr(port_store, "qwen3_params_path", str(checkpoints["gqa"][1]))
    monkeypatch.setattr(q3.Qwen3EmbeddingProvider, "_instance", None)
    provider = q3.Qwen3EmbeddingProvider.shared()
    b, F = len(TEXTS), 4

    def on_card(q):
        lex = (np.zeros((b, F), np.uint16), np.zeros((b, F), np.float16))
        packed = pack.pack_queries(q, lex, lex, np.zeros((b, 1), np.int32),
                                   np.ones((b, 1), bool), np.zeros(b, np.int32),
                                   np.zeros(b, np.int32))
        got = pack._unpack(torch.from_numpy(packed), batch=b, dim=GQA.embed_dim,
                           q_feats=F, tech_q=1, n_calls=1)["q_emb"]
        return got.to(torch.bfloat16).float().numpy()

    served = provider.embed(TEXTS).vectors
    ids = provider.tokenize(TEXTS)
    raw = q3.encode(provider.model, ids).numpy()
    once = torch.from_numpy(raw).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(served, once)
    # float16 holds a bfloat16 value exactly down to 2^-17; below that its
    # steps are 2^-24 apart
    normal = np.abs(served) >= 2.0 ** -17
    np.testing.assert_array_equal(on_card(served)[normal], served[normal])
    assert np.abs(on_card(served) - served).max() <= 2.0 ** -25
    assert (on_card(raw) != once).any()
