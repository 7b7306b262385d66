"""One run of one cell: ``python -m rag_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the checkout's root.

The run makes the cell's corpus on the card from the seed, starts the
port's HTTP server in this process (``serve.py``) with the settings of the
deployment and of its query embedder (``reference/embedders/<name>.py``),
drives it from a client process of its own pinned to the last core
(``client.py``: a closed loop of the cell's callers, a warm-up, then
``--seconds`` of window), recording each query's vector as the program's
embedder served it. Then it frees the program's state and draws a seeded
sample of the window's answers; the embedder's plain reference embeds the
sample's texts while the run's work directory still holds the embedder's
files, and ``embed_gap`` holds the served vectors to those. The plain
reference search (``reference/``) takes its dense lane from the served
vectors and its other lanes from the text, and ``rrf_gap`` holds the
answers to it. The end-to-end metrics are ``setup_s`` and, on a card,
``card_us_per_query``: the card's time for the device programs enqueued in
the window (CUDA events around each, ``serve.CardClock``) over the queries
they served. With ``--trace 1`` it profiles a steady part of the window
and reports the per-layer metrics (one reader each in ``metrics/``, the
window's rate ``client.qps`` among them) in place of the end-to-end ones.

Standard error carries the run's account, ending with one line per number
compared and its limit; the last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``. Exit 2: no card, or
fewer than the cell needs; exit 3: JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def _process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


PROCESS_START = time.monotonic() - _process_age_s()

from . import verdict  # noqa: E402
from .stats import percentile  # noqa: E402
from .spec import ROOT, Cell, load_cell, load_file  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "cadence_rag_tpu")
SLICE_S = 5.0
FAILED_MS = 1e12
SLOW_TAGS = ("query.slow_batch", "query.slow_dispatch", "query.slow_device")


def thread_cpu() -> Dict[int, tuple]:
    """This process's threads: {tid: (name, CPU seconds)}."""
    import threading

    names = {t.native_id: t.name for t in threading.enumerate()}
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
        except OSError:        # the thread ended
            continue
        out[int(tid)] = (names.get(int(tid), name),
                         (int(fields[11]) + int(fields[12])) / tick)
    return out


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in BANNED and sys.modules[m] is not None)


def cpu_split():
    """(server cores, client cores): the client alone on the last core."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return cores, cores
    return cores[:-1], cores[-1:]


def reader(root: Path, name: str) -> Callable:
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    return load_file(Path(root) / "rag_bench" / "metrics" / f"{name}.py",
                     "rag_bench_metric_" + name).read


def _client(cell: Cell, seed: int, seconds: float, port: int, workdir: Path,
            cpus: List[int]):
    args = {"cell": cell.name, "root": str(cell.root), "seed": seed,
            "seconds": seconds, "port": port, "callers": int(cell.own["callers"]),
            "warm_seconds": float(cell.own["warm_seconds"]),
            "marked_share": float(cell.own["marked_share"]),
            "cpus": cpus, "out": str(workdir / "client.json")}
    path = workdir / "client_args.json"
    path.write_text(json.dumps(args))
    proc = subprocess.Popen([sys.executable, "-m", "rag_bench.client", str(path)],
                            cwd=str(Path(__file__).resolve().parent.parent),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, Path(args["out"])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             log: Callable[[str], None], before_window: Optional[Callable] = None,
             control: bool = False) -> Dict[str, Any]:
    """Set up, serve a window, judge. -> {"result": the last line's object
    without ``checks``, "checks": {name: {value, limit}}, "sample": ...};
    with ``control`` the sample also holds the embedder's control vectors
    (``readings.py``)."""
    import torch

    from . import serve
    from . import trace as tracing
    from .reference import judge, search
    from .traffic.queries import Queries, rng_for

    split: Dict[str, float] = {}
    t = time.monotonic()
    split["interpreter"] = t - PROCESS_START
    import cadence_rag_tpu_torch.serve.http  # noqa: F401
    import cadence_rag_tpu_torch.engine.retrieve  # noqa: F401
    split["import"] = time.monotonic() - t
    cuda = torch.device(device).type == "cuda"
    t = time.monotonic()
    if cuda:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    split["cuda context"] = time.monotonic() - t
    server_cpus, client_cpus = cpu_split()
    log(f"cpus: server {server_cpus}, client {client_cpus}")
    with tempfile.TemporaryDirectory(prefix="rag_bench_") as tmp:
        workdir = Path(tmp)
        served = serve.Served(cell, seed, device, workdir, split)
        proc = None
        try:
            if cuda:
                t = time.monotonic()
                from cadence_rag_tpu_torch.kernels import build
                build.load()
                split["kernels"] = time.monotonic() - t
            if trace:
                t = time.monotonic()
                tracing.warm(cuda)
                split["profiler"] = time.monotonic() - t
            if before_window is not None:
                before_window(served)
            t_client = time.monotonic()
            proc, out_path = _client(cell, seed, seconds, served.port, workdir,
                                     client_cpus)
            line = proc.stdout.readline()
            if not line.startswith("WINDOW "):
                proc.wait(60)
                raise RuntimeError(f"the client did not open the window: {line!r} "
                                   f"{proc.stderr.read()[-3000:]}")
            t0 = float(line.split()[1])
            cpu0 = thread_cpu()
            split["warm-up"] = t0 - t_client
            setup_s = t0 - PROCESS_START
            prof = None
            if trace:
                start = t0 + max(1.0, seconds / 4)
                time.sleep(max(0.0, start - time.monotonic()))
                prof = tracing.Profile(cuda)
                late = prof.mark - start
                time.sleep(min(5.0, seconds / 2))
                prof.stop()
            _, err = proc.communicate(timeout=seconds + 180)
            if proc.returncode != 0:
                raise RuntimeError(f"the client failed ({proc.returncode}): {err[-3000:]}")
            threads = _busy_threads(cpu0, thread_cpu())
            client = json.loads(out_path.read_text())
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            spans = served.ring.stop()
            fullest = served.ring.fullest
            served.ring = None
            sizes = [n for ts, n in served.sizes.records if t0 <= ts <= client["closed"]]
            dispatches = served.dispatches.calls
            card = (served.card.per_query_us(t0, client["closed"])
                    if served.card is not None else None)
            embeds = served.embeds.vectors
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
            served.close()
        traced = prof.read(workdir) if prof is not None else None
        end = t0 + seconds
        records = [r for r in client["records"] if t0 <= r[1] <= end]
        # the sample, and its reference embedding while the embedder's
        # files are still in the workdir
        finished = {int(r[0]) for r in records if r[3] == 200}
        have = sorted(int(i) for i in client["answers"] if int(i) in finished)
        order = rng_for(seed, 51).permutation(len(have))
        chosen = [have[j] for j in order[:int(cell.own["sample"])]]
        queries = Queries(cell.traffic, cell.config, seed)
        texts = [queries[i][0] for i in chosen]
        t = time.monotonic()
        ref_embs = (served.embedder.embed(cell.config, seed, workdir, texts, device)
                    if chosen else np.zeros((0, int(cell.config["embedding_dim"]))))
        embed_s = time.monotonic() - t
        if control:
            control_embs = served.embedder.control(cell.config, seed, workdir, texts,
                                                   device)
    if traced is not None:
        log(f"trace: {traced['window_s']:.3f} s from {traced['lo_us'] / 1e6 - t0:.3f} s "
            f"into the window (the profiler took {late:.3f} s to start), "
            f"{len(traced['kernels'])} kernels, busy {traced['busy_s']:.3f} s")

    attempted = len(records)
    failed = sum(1 for r in records if r[3] != 200)
    answered = sum(1 for r in records if r[3] == 200 and r[2] <= end)
    # a failed request misses every limit: it counts as the slowest
    latency = [(r[2] - r[1]) * 1e3 if r[3] == 200 else FAILED_MS for r in records]
    slices = [0] * int(-(-seconds // SLICE_S))
    for r in records:
        if r[3] == 200 and r[2] <= end:
            slices[min(int((r[2] - t0) // SLICE_S), len(slices) - 1)] += 1
    window_spans = [ev for ev in spans if t0 <= ev["t"] <= client["closed"]]
    log(f"setup split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; setup_s {setup_s:.3f}")
    log(f"window: {attempted} requests sent, {answered} answered in {seconds} s "
        f"({answered / seconds:.1f}/s), {failed} failed; answered by {SLICE_S:g} s "
        f"slice {slices}")
    if card is not None:
        log(f"card: {card[0]:.3f} us a query over {card[1]} device programs "
            f"({card[2]} queries) enqueued in the window")
    if latency:
        log(f"latency (ms, client clock, every request sent in the window): p50 "
            f"{percentile(latency, 50):.3f}, p95 {percentile(latency, 95):.3f}")
    log(f"client: {client['cpu_s']:.2f} s of CPU over "
        f"{client['closed'] - t0:.2f} s ({client['cpu_s'] / (client['closed'] - t0):.1%}"
        f" of its core)")
    log("engine by slice (batches; ms a batch by stage): "
        + json.dumps(_slice_stats(window_spans, t0, len(slices))))
    log(f"server threads over the window (name, CPU s): {threads}")
    slow = [ev for ev in window_spans if ev["tag"] in SLOW_TAGS]
    log(f"engine: {sum(ev['tag'] == 'retrieve.plan' for ev in window_spans)} batches "
        f"in the window; {len(spans)} ring events read, at most {fullest} a drain "
        f"(the ring holds 8192); slow events {slow}")

    # the reference, once the program's state is freed
    modes = {(d["chunk_mode"], d["artifact_mode"]) for d in dispatches
             if t0 <= d["t"] <= client["closed"]}
    want_modes = tuple(cell.own["modes"])
    mode_faults = sum(1 for d in dispatches if t0 <= d["t"] <= client["closed"]
                      and (d["chunk_mode"], d["artifact_mode"]) != want_modes)
    calls = [queries[i][1] for i in chosen]
    answers = [client["answers"][str(i)] for i in chosen]
    # the dense lane from the vectors served, themselves judged apart
    embs, embed_gap, unserved = judge.vectors(embeds, texts, ref_embs)
    t = time.monotonic()
    ref = (search.fused(cell.config, seed, texts, calls, embs, device,
                        cell.own["modes"]) if chosen else [])
    ref_s = time.monotonic() - t
    gaps, wrong = judge_each(cell, seed, ref, answers)
    gap = max(gaps, default=0.0)
    log(f"reference: {embed_s:.3f} s embedding ({served.embedder.__name__}), "
        f"{ref_s:.3f} s searching, over {len(chosen)} sampled answers; "
        f"{unserved} without a served vector; dispatched modes {sorted(modes)}")
    widest = sorted(zip(gaps, chosen), reverse=True)[:5]
    log("widest rrf gaps (gap, query): " + ", ".join(f"({g!r}, {q})" for g, q in widest))
    judged = verdict.checks(cell, gap, embed_gap, wrong + unserved, failed, mode_faults,
                            len(chosen))
    correct = verdict.correct(judged)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if not trace:
        values = {"setup_s": setup_s,
                  # none on the CPU, which has no card clock
                  "card_us_per_query": card[0] if card is not None else None}
        for m in cell.end_to_end():
            if values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"spans": window_spans, "config": cell.config, "latency_ms": latency,
               "qps": answered / seconds,
               "batch_sizes": sizes, "trace": traced,
               "dispatches": [d for d in dispatches
                              if traced and served_window(traced, d["t"])]}
        for m in cell.per_layer():
            value = reader(cell.root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced is not None:
            device_info["busy_s"] = traced["busy_s"]
            device_info["window_s"] = traced["window_s"]
            breakdown = {"device_ops": traced["top"],
                         "idle_gaps": tracing.name_gaps(traced["gaps"], spans)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    sample = {"texts": texts, "calls": calls, "answers": answers, "reference": ref,
              "reference_embs": ref_embs}
    if control:
        sample["control_embs"] = control_embs
    return {"result": result, "checks": judged, "sample": sample}


def _busy_threads(before, after) -> List[tuple]:
    """Threads that used a tenth of a second of CPU or more between two
    ``thread_cpu`` readings."""
    out = []
    for tid, (name, cpu) in after.items():
        used = cpu - before.get(tid, (name, 0.0))[1]
        if used >= 0.1:
            out.append((name, round(used, 2)))
    return sorted(out, key=lambda t: -t[1])


def _slice_stats(spans, t0: float, n: int) -> List[Dict[str, Any]]:
    """Per slice of the window: batches and each engine stage's mean ms a
    batch."""
    out: List[Dict[str, Any]] = [{"batches": 0} for _ in range(n)]
    for ev in spans:
        if not ev["tag"].startswith("retrieve.") or "s" not in ev:
            continue
        row = out[min(max(int((ev["t"] - t0) // SLICE_S), 0), n - 1)]
        stage = ev["tag"][len("retrieve."):]
        row["batches"] += stage == "plan"
        row[stage] = row.get(stage, 0.0) + ev["s"]
    for row in out:
        for stage in list(row):
            if stage != "batches":
                row[stage] = round(1e3 * row[stage] / max(row["batches"], 1), 1)
    return out


def served_window(traced: Dict[str, Any], t: float) -> bool:
    """A dispatch made inside the traced window."""
    return traced["lo_us"] <= t * 1e6 <= traced["hi_us"]


def judge_each(cell: Cell, seed: int, ref, answers) -> tuple:
    """-> ([each answer's widest rrf gap], wrong answers) over the sample."""
    from .reference import judge

    gaps, wrong = [], 0
    for fused, answer in zip(ref, answers):
        if cell.traffic["return_style"] == "ids_only":
            g, w = judge.ids_only(fused, answer, cell.config, int(cell.own["depth"]))
        else:
            g, w = judge.pack(fused, answer, cell.config, seed)
        gaps.append(g)
        wrong += w
    return gaps, wrong


def judge_all(cell: Cell, seed: int, ref, answers) -> tuple:
    """-> (widest rrf gap, wrong answers) over the sample."""
    gaps, wrong = judge_each(cell, seed, ref, answers)
    return max(gaps, default=0.0), wrong


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    # before torch starts threads: they inherit the server's cores
    os.sched_setaffinity(0, cpu_split()[0])
    try:
        cell = load_cell(args.workload, ROOT)
    except (OSError, KeyError) as exc:
        log(f"rag_bench: {exc}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"rag_bench: the cell needs {cell.chips} CUDA card(s); "
            f"available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} seen")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log)
    found = banned_modules()
    if found:
        log(f"rag_bench: JAX or the JAX package was loaded: {found}")
        return 3
    verdict.log_checks(out["checks"], log)
    line = dict(out["result"])
    line["checks"] = out["checks"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
