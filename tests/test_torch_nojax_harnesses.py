"""The measurement and deployment entry points run without jax, without
``ml_dtypes`` and without the JAX package (the machine with the card has
no jax), on the CPU at a tiny size, in a subprocess of their own
(``tests/conftest.py`` imports jax in this process):

- ``evals/serve_bench`` with the writer beside it, ``evals/ingest_bench``,
  ``evals/host_profile``, ``evals/fullstack_profile`` and ``evals/soak``
  (growth, deletes, the compaction and the vocab rebuild);
- the trace listener (``serve/profiler.py``) that ``serve.api.startup``
  starts for ``PROFILER_PORT``, one ``GET /trace`` over a served batch;
- ``scripts/serve_all.py --device cpu``, whose children (api, scanner,
  worker) block the same modules through a ``sitecustomize`` on their
  path: the api becomes healthy, answers ``/diagnostics`` on the CPU, and
  SIGTERM stops every child;
- ``chip_smoke.py``'s ``harness`` phase at a tiny size, and its report.

A file of its own: ``tests/test_torch_nojax.py`` already sets the suite's
longest file.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "cadence_rag_tpu")
BLOCK = ("import sys\nBLOCKED = {!r}\nfor _name in BLOCKED:\n"
         "    sys.modules[_name] = None\n").format(BLOCKED)

SCRIPT = BLOCK + r"""
import contextlib, io, json, tempfile, threading, urllib.request

from cadence_rag_tpu_torch.config import settings
settings.embeddings_dim = 64
settings.lexical_dim = 1024
settings.index_initial_capacity = 256
settings.store_sync_interval_s = 0.0
tmp = tempfile.mkdtemp(prefix="nojax_harness_")
settings.store_path = tmp + "/store.db"

from cadence_rag_tpu_torch.evals import (
    fullstack_profile, host_profile, ingest_bench, serve_bench, soak)

out = {}
out["serve_bench"] = serve_bench.run_serve_bench(
    2000, 4, 2, "ids_only", concurrent_ingest=True, ingest_rate_rows_s=500.0,
    device="cpu")
out["ingest_bench"] = ingest_bench.run_ingest_bench(2, 6, device="cpu")
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    host_profile.main(["--chunks", "2000", "--batch", "4", "--iters", "2",
                       "--lex-dim", "1024", "--top", "3", "--device", "cpu"])
    fullstack_profile.main(["--n", "2000", "--batch", "4", "--iters", "2",
                            "--trials", "1", "--lex-dim", "1024", "--device", "cpu"])
text = buf.getvalue()
out["host_profile_sections"] = [s for s in ("setup", "compile+first",
    "engine timings_ms:", "===== top by tottime =====") if s in text]
out["fullstack_keys"] = sorted(json.loads(text.strip().splitlines()[-1]))
out["soak"] = soak.run_soak(
    minutes=8 / 60, chunks=3000, batch=4, writer_rows_s=600.0,
    delete_every_s=1.0, n_delete=20, window_s=2.0, decay_floor=0.0,
    vocab_at_frac=0.25, device="cpu")
out["soak"].pop("windows"); out["soak"].pop("events")

# the trace listener startup starts for PROFILER_PORT, over a served batch
from cadence_rag_tpu_torch.core.index import reset_index
from cadence_rag_tpu_torch.engine.retrieve import retrieve_evidence_batch
from cadence_rag_tpu_torch.schemas import RetrieveRequest
from cadence_rag_tpu_torch.serve import profiler
from cadence_rag_tpu_torch.serve.api import startup
from cadence_rag_tpu_torch.store.db import reset_store
import socket
with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0)); port = sock.getsockname()[1]
settings.profiler_port = port
settings.store_path = tmp + "/served.db"
reset_store(); reset_index()
startup("cpu")
serve_bench._populate(500, device="cpu")
stop = threading.Event()
def serve():
    while not stop.is_set():
        retrieve_evidence_batch([RetrieveRequest(query="gateway retry budget")] * 4)
thread = threading.Thread(target=serve); thread.start()
try:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/trace?ms=300", timeout=60) as r:
        trace = json.loads(r.read())
finally:
    stop.set(); thread.join(); profiler.stop_server()
out["trace_names_dispatch"] = any(
    ev.get("name") == "retrieve.dispatch" for ev in trace["traceEvents"])
out["loaded"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps(out))
"""


HARNESS_PHASE = BLOCK + r"""
import json
import torch
import chip_smoke as cs
from cadence_rag_tpu_torch.config import settings
settings.embeddings_dim = 64
settings.lexical_dim = 1024
cs.HARNESS_CHUNKS = 3000
cs.SERVE_BENCH_ITERS = 3
cs.TRACE_MS = 300
cs.HOST_PROFILE_ARGV = ("--chunks", "3000", "--lex-dim", "1024", "--iters", "2",
                        "--top", "15")
cs.FULLSTACK_ARGV = ("--n", "3000", "--lex-dim", "1024", "--batch", "8",
                     "--trials", "1", "--iters", "2")
cs.SOAK_KW = dict(minutes=8 / 60, chunks=3000, batch=8, writer_rows_s=600.0,
                  window_s=2.0, decay_floor=0.0, delete_every_s=2.0, n_delete=40,
                  vocab_at_frac=0.25)
hv = json.loads(json.dumps(cs.run_harness("cpu")))   # as the child hands it over
checked = []
cs.check_served_shapes = lambda device, dispatched, corpora, seed: (
    checked.append((corpora["chunks"]["rows"], cs.served_cases(dispatched)))
    or {"k1_max_abs_err": 0.0})
cs.report_harness(torch.device("cpu"), hv, "cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
print(json.dumps({"loaded": loaded, "steps": list(hv["steps_s"]),
                  "soak_failures": hv["soak"]["failures"],
                  "serve_all": {k: hv["serve_all"][k] for k in (
                      "children", "alive_after", "rc", "diagnostics_device",
                      "job_status")},
                  "trace_bytes": hv["trace"]["bytes"],
                  "checked": [(rows, [list(c) for c in cases[0]]) for rows, cases in checked]}))
"""


def _env(extra_path=None):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (extra_path, str(REPO)) if p])
    return env


def test_the_harnesses_run_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    sb = out["serve_bench"]
    assert sb["chunks"] == 2000 and sb["qps"] > 0 and sb["concurrent_inserts"] >= 0
    ib = out["ingest_bench"]
    assert ib["calls"] == 2 and ib["embed_rows"] == ib["device_chunk_count"] > 0
    assert out["host_profile_sections"] == [
        "setup", "compile+first", "engine timings_ms:", "===== top by tottime ====="]
    assert "timeline_rrf_on_d3" in out["fullstack_keys"]
    sk = out["soak"]
    assert sk["failures"] == [], sk
    assert sk["compactions"] == 1 and sk["deleted_rows"] > 0
    assert sk["vocab_rebuild"]["ran"] and sk["capacity_growths"] == 1
    assert out["trace_names_dispatch"]


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_serve_all_runs_without_jax(tmp_path):
    """The supervisor and each child it starts with the blocked modules
    unimportable: the api is healthy on the CPU, then SIGTERM stops all."""
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(BLOCK)
    port = _free_port()
    env = _env(str(block))
    env.update(EMBEDDINGS_PROVIDER="stub", EMBEDDINGS_BASE_URL="",
               EMBEDDINGS_DIM="64", LEXICAL_DIM="1024",
               INDEX_INITIAL_CAPACITY="64", STORE_SYNC_INTERVAL_S="0.2",
               INGEST_POLL_SECONDS="1")
    log_path = tmp_path / "serve_all.log"
    with open(log_path, "w") as log:
        sup = subprocess.Popen(
            [sys.executable, "-m", "cadence_rag_tpu_torch.scripts.serve_all",
             "--store", str(tmp_path / "shared.db"),
             "--inbox", str(tmp_path / "ingest"), "--host", "127.0.0.1",
             "--port", str(port), "--device", "cpu"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 120
            diag = None
            while time.monotonic() < deadline and diag is None:
                assert sup.poll() is None, log_path.read_text()[-3000:]
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/diagnostics", timeout=10) as r:
                        diag = json.loads(r.read())
                except OSError:
                    time.sleep(0.5)
            assert diag is not None, log_path.read_text()[-3000:]
            assert diag["index"]["device"] == "cpu"
            time.sleep(2)            # the scanner and the worker are up
        finally:
            sup.send_signal(signal.SIGTERM)
            rc = sup.wait(timeout=60)
    text = log_path.read_text()
    assert rc == 0, text[-3000:]
    for name in ("api", "scanner", "worker0"):
        assert f"[serve_all] started {name}" in text
    assert "Error" not in text.replace("RuntimeError: x", ""), text[-3000:]
    assert "[serve_all] done" in text


def test_chip_smoke_harness_phase_runs_without_jax():
    """chip_smoke.py's ``harness`` phase on the CPU at a tiny size (its
    constants cut), jax blocked in this process and in serve_all's children
    (none of which asks for it): every step, the report, and one shape check
    a corpora shape the phase dispatched on."""
    proc = subprocess.run([sys.executable, "-c", HARNESS_PHASE], cwd=REPO,
                          env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["steps"] == ["serve_bench", "host_profile", "fullstack_profile",
                            "ingest_bench", "soak", "serve_all"]
    assert out["soak_failures"] == [] and out["trace_bytes"] > 0
    sa = out["serve_all"]
    assert sa["children"] == ["api", "scanner", "worker0"] and sa["alive_after"] == []
    assert (sa["rc"], sa["diagnostics_device"], sa["job_status"]) == (0, "cpu", "succeeded")
    # serve_bench's 3000 chunks (4096 rows), the soak's growth past them
    rows = [r for r, _cases in out["checked"]]
    assert rows[0] == 4096 and len(rows) >= 2 and rows == sorted(rows)
