"""Multi-process distributed smoke check.

Counterpart of ``cadence_rag_tpu/evals/dist_check.py``: the corpus-sharded
lanes (``parallel/sharded.sharded_multi_lane``) must give a one-process
oracle's answers when the mesh SPANS PROCESSES, i.e. when each process
holds some shards and the candidates cross processes in a
``torch.distributed`` all-gather. Every process builds the same global
inputs from one seed, keeps its own row blocks, and compares the merged
lanes with the same exact lanes over the whole corpus (finite positions
identical as sets per query, as the JAX check compares them).

Launch the gang (spawns the workers, one OS process each):
    python -m cadence_rag_tpu_torch.evals.dist_check [--processes 2]
        [--devices-per-process 1] [--port 19911] [--device cuda|cpu]

or run one worker of a gang launched elsewhere:
    python -m cadence_rag_tpu_torch.evals.dist_check --worker \
        --process-id K --processes N --coordinator host:port --device cuda

``--device`` defaults to ``cuda`` and raises without a card. On CUDA the
backend is nccl when every process has a card of its own and gloo when
they share one (two processes may share ``cuda:0``); the tech lane is then
kernel K3 in every shard. On the CPU the backend is gloo.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def run_worker(process_id: int, n_processes: int, coordinator: str,
               devices_per_process: int, device: str) -> int:
    import numpy as np
    import torch

    from ..ops.hashing import tech_slot_choices
    from ..parallel import mesh as mesh_mod
    from ..parallel.sharded import _local_all_lanes, sharded_multi_lane

    gang = mesh_mod.init_gang(coordinator, n_processes, process_id, device)
    try:
        dev = gang.device
        mesh = mesh_mod.make_mesh(devices=[dev] * devices_per_process)
        n_devices = mesh.size

        # identical seed on every process -> identical global inputs
        rng = np.random.default_rng(0)
        # rows a shard: a multiple of K1's block; 16 tech slots, a width
        # kernel K3 is built for (the JAX check's 4 is not)
        n, dim, dlex, s, batch = 1024 * n_devices, 64, 256, 16, 2
        emb = rng.standard_normal((n, dim)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        lex = rng.integers(-4, 5, size=(n, dlex)).astype(np.int8)
        tech = np.zeros((n, s), dtype=np.int32)
        tech[::7, 0] = 99
        call_idx = (np.arange(n) % 16).astype(np.int32)
        started = rng.integers(1000, 5000, size=n).astype(np.int32)
        has_emb = np.ones(n, bool)
        q_emb = emb[:batch].copy()
        q_lex = (rng.standard_normal((batch, dlex)) * 0.1).astype(np.float32)
        # the query structure of hash 99 (both its choice columns)
        q_tech = np.zeros((batch, 2 * s), dtype=np.int32)
        q_tech[:, sorted(set(tech_slot_choices(99, s)))] = 99
        allowed = np.ones((batch, 16), dtype=bool)
        dmin = np.zeros(batch, np.int32)
        dmax = np.full(batch, 2**31 - 1, np.int32)
        rows = [torch.from_numpy(a) for a in (emb, lex, tech, call_idx, started, has_emb)]
        rows[0] = rows[0].to(torch.bfloat16)
        queries = [torch.from_numpy(a) for a in (q_emb, q_lex, q_tech, allowed, dmin, dmax)]
        ks = dict(k_dense=8, k_lex=8, k_tech=8)

        got = sharded_multi_lane(mesh, *rows, *queries, **ks)
        single = _local_all_lanes(*(a.to(dev) for a in rows),
                                  *(q.to(dev) for q in queries), **ks)
        ok = True
        for lane in ("dense", "lex", "tech"):
            s_scores, s_pos = (t.cpu().numpy() for t in single[lane])
            m_scores, m_pos = (t.cpu().numpy() for t in got[lane])
            for b in range(batch):
                s_set = {int(p) for p, v in zip(s_pos[b], s_scores[b]) if np.isfinite(v)}
                m_set = {int(p) for p, v in zip(m_pos[b], m_scores[b]) if np.isfinite(v)}
                if s_set != m_set:
                    ok = False
                    print(f"proc{process_id} MISMATCH lane={lane} b={b}", flush=True)
        print(f"proc{process_id}: sharded lanes {'MATCH' if ok else 'FAIL'} across "
              f"{n_processes} processes ({n_devices} global shards on {dev}, "
              f"backend {gang.backend})", flush=True)
        return 0 if ok else 1
    finally:
        mesh_mod.leave_gang()


def launch(n_processes: int, devices_per_process: int, port: int,
           device: str, timeout_s: float = 600.0) -> int:
    coordinator = f"127.0.0.1:{port}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cadence_rag_tpu_torch.evals.dist_check",
         "--worker", "--process-id", str(pid), "--processes", str(n_processes),
         "--coordinator", coordinator,
         "--devices-per-process", str(devices_per_process), "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for pid in range(n_processes)]
    rc = 0
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout_s)
            tail = [ln for ln in out.splitlines()
                    if "sharded lanes" in ln or "MISMATCH" in ln]
            print("\n".join(tail) or out[-2000:], flush=True)
            rc |= proc.returncode
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                rc |= 1
    print("DIST CHECK", "PASSED" if rc == 0 else "FAILED", flush=True)
    return rc


def main() -> None:
    parser = argparse.ArgumentParser(description="multi-process distributed smoke check")
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--devices-per-process", type=int, default=1)
    parser.add_argument("--port", type=int, default=19911)
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--coordinator", default="")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args()
    if args.worker:
        sys.exit(run_worker(args.process_id, args.processes, args.coordinator,
                            args.devices_per_process, args.device))
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("dist_check: --device cuda needs a card "
                             "(torch.cuda.is_available() is False)")
    sys.exit(launch(args.processes, args.devices_per_process, args.port, args.device))


if __name__ == "__main__":
    main()
