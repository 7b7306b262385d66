"""The byte-level BPE tokenizer (``models/tokenizer.py``, a verbatim copy of
the JAX package's): ``tests/unit/test_bpe_tokenizer.py`` runs against the
port as it stands (``torch_parity.mirror_tests``), and the two packages'
tokenizers give identical ids on a text sample, through ``encode`` and
through ``models/qwen3.batch_tokenize``.
"""

import json
import sys

import numpy as np
import pytest

from torch_parity import mirror_tests, port_store  # noqa: F401  (fixture)

SAMPLE = [
    "hello world", "Hello, World!", "the ECONNRESET storm hit v2.3.1 at 09:30",
    "ünïcödé — dashes and 中文 text", "  leading and trailing  ", "",
    "numbers 12345 and 3.14159, punctuation?!", "it's we'll they're",
    "hellohello worldworld", "tabs\tand\nnewlines",
]


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


BPE = mirror_tests(globals(), "bpe", "unit/test_bpe_tokenizer.py")


def test_the_mirrored_tests_ran_against_the_port():
    from cadence_rag_tpu_torch.models.tokenizer import BpeTokenizer

    assert sys.modules[f"{__name__}.bpe"].BpeTokenizer is BpeTokenizer


@pytest.mark.parametrize("form", ["tokenizer_json", "vocab_merges"])
def test_ids_match_the_jax_tokenizer(tmp_path, form):
    from cadence_rag_tpu.models import qwen3 as jq
    from cadence_rag_tpu.models.tokenizer import BpeTokenizer as JaxBpe
    from cadence_rag_tpu_torch.models import qwen3 as tq
    from cadence_rag_tpu_torch.models.tokenizer import BpeTokenizer as PortBpe

    tok = BPE._toy_tokenizer()
    if form == "tokenizer_json":
        data = {"model": {"type": "BPE", "vocab": dict(tok.vocab),
                          "merges": [f"{a} {b}" for a, b in tok.ranks]}}
        (tmp_path / "tokenizer.json").write_text(json.dumps(data))
    else:
        (tmp_path / "vocab.json").write_text(json.dumps(dict(tok.vocab)))
        (tmp_path / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tok.ranks))
    jtok, ptok = JaxBpe.load(str(tmp_path)), PortBpe.load(str(tmp_path))
    assert ptok.vocab_size == jtok.vocab_size
    for text in SAMPLE:
        for kw in ({}, {"add_eos": True}, {"max_len": 5}):
            assert ptok.encode(text, **kw) == jtok.encode(text, **kw), text
        assert ptok.decode(ptok.encode(text)) == jtok.decode(jtok.encode(text))
    np.testing.assert_array_equal(
        tq.batch_tokenize(SAMPLE, tq.preset("tiny"), seq_len=16, bpe=ptok),
        jq.batch_tokenize(SAMPLE, jq.preset("tiny"), seq_len=16, bpe=jtok))
