"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``: each
in a process of its own on a fresh store (both read their settings from
the environment at import), the port's with ``--device cpu`` and with jax
and the JAX package unimportable. The retrieve step's evidence ids and
snippets, its planner line and the expanded window are the JAX
quickstart's."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BLOCK = ("import sys, runpy\n"
         "for _name in ('jax', 'jaxlib', 'ml_dtypes', 'cadence_rag_tpu'):\n"
         "    sys.modules[_name] = None\n"
         "sys.argv = [sys.argv[1], '--device', 'cpu']\n"
         "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _answers(argv, store):
    # no syncer thread: the JAX process can abort in its teardown beside one
    env = dict(os.environ, STORE_PATH=str(store), JAX_PLATFORMS="cpu",
               STORE_SYNC_INTERVAL_S="0")
    proc = subprocess.run([sys.executable] + argv, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    return out[out.index("== retrieve =="):out.index("== browse ==")]


def test_the_port_quickstart_answers_as_the_jax_one(tmp_path):
    want = _answers([str(REPO / "examples" / "quickstart.py")], tmp_path / "jax.db")
    got = _answers(["-c", BLOCK, str(REPO / "examples" / "quickstart_torch.py")],
                   tmp_path / "port.db")
    assert "[Q-" in want and "[A-" in want and "planner:" in want
    assert got == want
