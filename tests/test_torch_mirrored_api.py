"""The JAX package's own API, request-path and store tests, run against the
port as they stand (``torch_parity.mirror_files``), on the CPU.

The port's router client is asked for the CPU (``TestClient(device="cpu")``);
nothing else in the files is rewritten but the package's name. The files are
spread over ``tests/test_torch_mirrored_{api,edge,retrieve,writes}.py``: two
files that define a fixture of one name cannot share a test module. Dropped,
and why: ``test_api.py``'s two ``TestDistributedStartupFlag`` cases patch
``jax.distributed.initialize``, which the port does not call (its gang joins
``torch.distributed``: ``tests/test_torch_serve.py``'s gang-settings cases and
``tests/test_torch_multihost.py`` hold it). The dtype names and the mesh of
``/index/stats`` and ``/diagnostics`` are the JAX package's, so
``TestHealthDiagnostics`` runs whole.
"""

from pathlib import Path

import pytest

from torch_parity import (
    MIRRORED_FILES,
    assert_mirrored_against_the_port,
    mirror_files,
    port_store,  # noqa: F401  (fixture)
)

STEMS = ("api", "http_server", "concurrency", "embed_cache", "locks")
JAX_DISTRIBUTED = ("patches jax.distributed.initialize, which the port does not "
                   "call: its gang joins torch.distributed")
# stem -> {class: the methods that do not apply}, for the reason above
DROP = {"api": {"TestDistributedStartupFlag": [
    "test_coordinated_init_invoked", "test_single_process_skips_init"]}}


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_files(globals(), STEMS, drop=DROP)


def test_the_mirrored_tests_ran_against_the_port():
    import sys

    from cadence_rag_tpu_torch.serve.testing import TestClient

    assert sys.modules[f"{__name__}.api"].TestClient is TestClient
    assert_mirrored_against_the_port(__name__, STEMS)


def test_only_the_jax_distributed_cases_are_dropped():
    """The dropped cases exist in the JAX package's file and patch
    ``jax.distributed``: nothing else is left out."""
    source = (Path(__file__).parent / MIRRORED_FILES["api"]).read_text()
    for methods in DROP["api"].values():
        for method in methods:
            body = source.split(f"def {method}(")[1].split("\n    def ")[0]
            assert "jax.distributed" in body, (method, JAX_DISTRIBUTED)
