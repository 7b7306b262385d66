"""The model axis without jax, ``ml_dtypes`` or the JAX package (the
machine with the card has none of them), on the CPU in a subprocess of its
own (``tests/conftest.py`` imports jax in this process): ``chip_smoke.py``'s
``model_axis`` phase at a tiny size (the Qwen3 tiny preset tensor-parallel
and born sharded, two dp+tp steps of the committed embedder,
``graft.dryrun_multichip(8)`` and serving under ``data:2,model:2``), then
``graft.entry``."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu")

SCRIPT = ("import sys\nfor _name in {!r}:\n    sys.modules[_name] = None\n"
          .format(BLOCKED)) + r"""
import json, tempfile
import torch
import chip_smoke as cs
from cadence_rag_tpu_torch import graft
from cadence_rag_tpu_torch.config import settings
settings.embeddings_dim = 64
settings.lexical_dim = 1024
with tempfile.TemporaryDirectory() as tmp:
    out = cs.run_model_axis(torch.device("cpu"), tmp, preset="tiny", q_batch=4,
                            q_seq=16, q_reps=1, emb_steps=2, emb_batch=8,
                            n_chunks=8192, n_artifacts=2048, batch=8, n_known=4)
fn, args = graft.entry("cpu")
q, e, sv = out["qwen3"], out["embedder"], out["serving"]
print(json.dumps({
    "loaded": sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu")
                     and sys.modules[m] is not None),
    "steps": list(out["steps_s"]), "qwen_err": q["max_abs_err"],
    "qwen_bytes": q["bytes_per_position"], "qwen_whole": q["bytes_unsharded"],
    "emb_losses": e["losses"], "emb_gaps": [e["loss_gap"], e["param_change_gap"]],
    "modes": sv["modes"], "shards": sv["shards"], "launches": sv["launches_by_shard"],
    "counts": [sv["launches"], out["launches"], out["dryrun_launches"]],
    "engine": sv["engine_answers"], "entry": list(fn(*args).shape)}))
"""


def test_model_axis_phase_runs_without_jax():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(REPO)
    # one intra-op thread: beside the suite's other workers, a process of
    # spinning OpenMP threads slows every process on the machine
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["steps"] == ["qwen3", "embedder", "dryrun", "serving"]
    # the plain path: tensor-parallel sums the same bf16 roundings
    assert out["qwen_err"] == 0.0
    # each of the two positions holds half of every sharded weight
    assert 0.45 * out["qwen_whole"] < out["qwen_bytes"][0] < 0.55 * out["qwen_whole"]
    # another batch split sums the products in another order: the losses
    # agree within the phase's limit (read: 4e-5 at the first step)
    assert len(out["emb_losses"]) == 2 and out["emb_gaps"][0] < 1.5e-2
    # and the parameters moved alike (a run that changes nothing reads 1)
    assert out["emb_gaps"][1] <= 0.1
    assert out["modes"] == [["ann", "ann"], ["exact", "exact"]]
    # two data shards, each scanned (no kernel launches on the CPU: the
    # plain versions)
    assert out["shards"] == [0, 1]
    assert out["launches"] == {f"{c}/{s}": {} for c in ("artifact_chunks", "chunks")
                               for s in (0, 1)}
    assert out["counts"] == [{"fused_scan": 0, "tech_topk": 0}] * 3
    assert out["engine"] == 8 and out["entry"] == [2, 256]
