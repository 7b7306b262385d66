"""The deployment supervisor (``scripts/serve_all.py``), on the CPU.

``tests/integration/test_serve_all.py`` runs against the port as it stands
(``torch_parity.mirror_tests``), with ``--device cpu`` added to the
supervisor's arguments: one command brings up the api, the scanner and a
worker on a shared store, a bundle dropped in the inbox becomes retrievable
through the live api, and SIGTERM tears everything down. Without a card,
``--device cuda`` (the default) makes the api child exit nonzero before it
is healthy: the supervisor reports it, stops what it started and exits 1.
"""

import os
import subprocess
import sys

import pytest
import torch

from torch_parity import (
    mirror_tests,
    port_store,  # noqa: F401  (fixture)
)

ON_CPU = ((r'"--workers", "1"\]', '"--workers", "1", "--device", "cpu"]'),)


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


serve_all = mirror_tests(globals(), "serve_all", "integration/test_serve_all.py",
                         rewrites=ON_CPU)


def test_the_mirrored_test_runs_the_port():
    consts = serve_all.TestServeAll.test_full_deployment_roundtrip.__code__.co_consts
    assert "cadence_rag_tpu_torch.scripts.serve_all" in consts
    assert "--device" in consts and "cpu" in consts


def test_without_a_card_the_api_exits_and_the_supervisor_says_so(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    env = dict(os.environ, EMBEDDINGS_PROVIDER="stub", EMBEDDINGS_BASE_URL="",
               EMBEDDINGS_DIM="64", LEXICAL_DIM="1024")
    out = subprocess.run(
        [sys.executable, "-m", "cadence_rag_tpu_torch.scripts.serve_all",
         "--store", str(tmp_path / "shared.db"), "--host", "127.0.0.1",
         "--port", str(serve_all._free_port()), "--device", "cuda"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout[-3000:]
    assert "[serve_all] started api" in out.stdout
    assert "torch.cuda.is_available() is False" in out.stdout
    assert "[serve_all] api exited rc=1 before it became healthy" in out.stdout
    assert "[serve_all] api never became healthy; aborting" in out.stdout
