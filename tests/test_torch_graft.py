"""The port's ``graft.entry`` and ``graft.dryrun_multichip`` on the CPU:
the counterpart of tests/integration/test_graft_entry.py, each with the JAX
package's asserts, and ``entry``'s vectors against the JAX package's
``__graft_entry__.entry`` on the same seeded weights (within ENTRY_ATOL;
read: 1.4e-4: in this process XLA keeps some bf16 intermediates in f32,
as ``test_torch_qwen3.py`` describes, and the port rounds them)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from cadence_rag_tpu_torch import graft

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as jax_graft  # noqa: E402

ENTRY_ATOL = 1e-3


def test_entry_runs_and_matches_the_jax_entry():
    fn, args = graft.entry(device="cpu")
    out = fn(*args).numpy()
    assert out.ndim == 2 and out.shape[0] == 2
    assert np.all(np.isfinite(out))
    jfn, jargs = jax_graft.entry()
    np.testing.assert_allclose(out, np.asarray(jax.jit(jfn)(*jargs)), rtol=0,
                               atol=ENTRY_ATOL)


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multichip(n):
    """``model:2`` over 8 positions (data:4), and an odd count (data:3)
    without a model axis, as the JAX package's dry run picks them."""
    graft.dryrun_multichip(n, device="cpu")


def test_entry_points_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        graft.dryrun_multichip(2)
