"""The on-card probes run without jax, without ``ml_dtypes`` and without the
JAX package (the machine with the card has no jax), on the CPU at a tiny
size, in a subprocess of their own (``tests/conftest.py`` imports jax in this
process): all ten modules import, and ``chip_smoke.py``'s ``probes`` phase
runs each probe's ``main`` in turn and reports it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu")
PROBES = ("rtt_probe", "rtt_probe2", "rtt_probe3", "h2d_probe", "h2d_probe2",
          "cta_ab", "coldtier_probe", "growth_probe", "prewarm_probe", "lane_probe")

SCRIPT = ("import sys\nBLOCKED = {!r}\nfor _name in BLOCKED:\n"
          "    sys.modules[_name] = None\n".format(BLOCKED)) + r"""
import importlib, json, tempfile
import torch
import chip_smoke as cs
from cadence_rag_tpu_torch.config import settings

tmp = tempfile.mkdtemp(prefix="nojax_probes_")
settings.store_path = tmp + "/store.db"
for name in PROBE_MODULES:
    importlib.import_module("cadence_rag_tpu_torch.evals." + name)
LINK = ("--rows", "2048", "--artifact-rows", "1024", "--batch", "4", "--iters", "2")
LANES = ("--n", "3000", "--batch", "4", "--iters", "1", "--lex-dim", "256", "--dim", "64")
TINY = (("rtt_probe2", LINK), ("rtt_probe", LINK), ("h2d_probe", ("--iters", "2")),
        ("h2d_probe2", LINK), ("rtt_probe3", LINK),
        ("cta_ab", ("--n", "3000", "--batch", "4", "--iters", "2", "--trials", "1",
                    "--lex-dim", "1024")),
        ("coldtier_probe", ("--hot", "4096", "--cold", "1500", "--batch", "4",
                            "--block", "1024", "--iters", "2", "--lex-dim", "1024")),
        ("growth_probe", ("--rows", "2048", "--dim", "64", "--lex-dim", "256")),
        ("prewarm_probe", ("--rows", "4096", "--dim", "64", "--lex-dim", "256")),
        ("lane_probe", LANES), ("lane_probe", LANES + ("--probe", "plane")))
assert [name for name, _ in TINY[:-1]] == [name for name, _ in cs.PROBES[:-1]]
pv = json.loads(json.dumps(cs.run_probes("cpu", TINY)))   # as the child hands it over
cs.check_served_shapes = lambda device, dispatched, corpora, seed: {"k1_max_abs_err": 0.0}
cs.report_probes(torch.device("cpu"), pv, "cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps({"loaded": loaded, "probes": [p["name"] for p in pv["probes"]],
                  "last": {p["name"]: p["lines"][-1] for p in pv["probes"]},
                  "dispatched": len(pv["dispatched"])}))
""".replace("PROBE_MODULES", repr(PROBES))


def test_the_probes_run_without_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert sorted(set(out["probes"])) == sorted(PROBES)
    assert json.loads(out["last"]["rtt_probe3"])["answers_equal"] is True
    assert json.loads(out["last"]["growth_probe"])["summary"]["rows_kept"] is True
    assert json.loads(out["last"]["lane_probe"])["checks_failed"] == []
    assert out["last"]["coldtier_probe"].startswith("cold blocks: not measured")
    assert out["dispatched"] >= 2
    assert "probes rtt_probe2 --rows 2048" in proc.stdout
