"""The soak harness (``evals/soak.py``), JAX package vs port, on the CPU.

``tests/integration/test_soak.py`` runs against the port as it stands
(``torch_parity.mirror_tests``, the harness asked for the CPU): a
seconds-long run must drive queries, the throttled writer, deletes, one
compaction and the vocab auto-rebuild together, cross one capacity growth
and produce the windowed report. Then both packages' reports of one short
run carry the same keys, and the port's CLI refuses to run without a card.
"""

import sys

import pytest
import torch

from torch_parity import (
    mirror_tests,
    port_store,  # noqa: F401  (fixture)
)

ON_CPU = ((r"\brun_soak\(", 'run_soak(device="cpu", '),)
SHORT = dict(minutes=4 / 60, chunks=600, batch=4, writer_rows_s=200.0,
             delete_every_s=1.0, n_delete=10, window_s=1.0, decay_floor=0.0,
             vocab_at_frac=5.0, check=True)


@pytest.fixture()
def port_tmp_store(port_store):
    return port_store


mirror_tests(globals(), "soak", "integration/test_soak.py", rewrites=ON_CPU)


def test_the_mirrored_tests_ran_against_the_port():
    from cadence_rag_tpu_torch.evals.soak import run_soak

    assert sys.modules[f"{__name__}.soak"].run_soak.__module__ == run_soak.__module__


def test_reports_carry_the_jax_keys(port_store):
    """One short run of each package (no vocab rebuild): the same report
    keys, window keys and deterministic fields."""
    from cadence_rag_tpu.evals.soak import run_soak as jax_soak
    from cadence_rag_tpu_torch.evals.soak import run_soak as port_soak

    jax_out = jax_soak(**SHORT)
    port_out = port_soak(device="cpu", **SHORT)
    assert port_out.keys() == jax_out.keys()
    assert port_out["failures"] == jax_out["failures"] == []
    for key in ("minutes", "chunks_start", "batch", "capacity_start",
                "rss_mirror_allowance_mb"):
        assert port_out[key] == jax_out[key], key
    assert {frozenset(w) for w in port_out["windows"]} == \
        {frozenset(w) for w in jax_out["windows"]}


def test_the_cli_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from cadence_rag_tpu_torch.evals import soak

    monkeypatch.setattr(sys, "argv", ["soak", "--minutes", "0.01"])
    with pytest.raises(RuntimeError, match="cuda"):
        soak.main()
