"""The closed-loop HTTP client, run in a process of its own.

``python -m rag_bench.client <args.json>`` from the checkout's root. Each
of ``callers`` callers sends a request, waits for its answer, and sends
the next: caller c sends the mix's queries c, c + callers, c + 2 callers,
... First a warm-up of ``warm_seconds`` on queries of their own, drained;
then the queries of three times the warm-up's rate over the window are
made (more are made if a run outruns them); then the window: every caller
starts at once, sends until ``seconds`` have passed, and waits for what it
sent (up to a minute past the close). Prints ``WINDOW <monotonic start>``
when the window opens and writes, per request of the window, (query,
sent, answered, status), the answers of the marked queries (a share drawn
from the seed, ``queries.marked``) and its own CPU seconds.
Times are ``time.monotonic()``, the machine's clock, which the server's
process reads too. Imports no torch and nothing of the program.
"""

from __future__ import annotations

import asyncio
import json
import os
import resource
import sys
import time

import aiohttp

from .spec import load_cell
from .traffic import queries as gen

LATE_S = 60.0


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


async def _drive(args):
    cell = load_cell(args["cell"], args["root"])
    traffic, config = cell.traffic, cell.config
    callers, seed = int(args["callers"]), int(args["seed"])
    window = gen.Queries(traffic, config, seed)
    warm = gen.Queries(traffic, config, seed, stream=1)
    share = float(args["marked_share"])
    url = f"http://127.0.0.1:{args['port']}/retrieve"
    headers = {"Content-Type": "application/json"}
    timeout = aiohttp.ClientTimeout(total=LATE_S + float(args["seconds"]))
    records, answers = [], {}

    async def post(session, data):
        async with session.post(url, data=data, headers=headers) as resp:
            return resp.status, await resp.read()

    def data(queries, i):
        return json.dumps(gen.body(traffic, queries[i])).encode()

    async def warm_caller(session, c, end):
        i, done = c, 0
        while time.monotonic() < end:
            status, _ = await post(session, data(warm, i))
            if status != 200:
                raise RuntimeError(f"warm-up request answered {status}")
            i, done = i + callers, done + 1
        return done

    async def caller(session, c, end):
        i = c
        while True:
            body = data(window, i)
            sent = time.monotonic()
            if sent >= end:
                return
            try:
                status, raw = await post(session, body)
            except (aiohttp.ClientError, asyncio.TimeoutError):
                status, raw = -1, b""
            records.append((i, sent, time.monotonic(), status))
            if status == 200 and gen.marked(seed, i, share):
                answers[i] = json.loads(raw)
            i += callers

    connector = aiohttp.TCPConnector(limit=0)
    async with aiohttp.ClientSession(connector=connector, timeout=timeout) as session:
        warm_s = float(args["warm_seconds"])
        end = time.monotonic() + warm_s
        done = sum(await asyncio.gather(*(warm_caller(session, c, end)
                                          for c in range(callers))))
        window.prepare(int(3 * done / warm_s * float(args["seconds"])) + callers)
        t0 = time.monotonic()
        cpu0 = _cpu_s()
        print(f"WINDOW {t0!r}", flush=True)
        end = t0 + float(args["seconds"])
        await asyncio.gather(*(caller(session, c, end) for c in range(callers)))
        closed = time.monotonic()
        cpu = _cpu_s() - cpu0
    return {"t0": t0, "closed": closed, "cpu_s": cpu, "records": records,
            "answers": {str(k): v for k, v in answers.items()}}


def main(path: str) -> None:
    with open(path) as f:
        args = json.load(f)
    if args.get("cpus"):
        os.sched_setaffinity(0, args["cpus"])
    out = asyncio.run(_drive(args))
    with open(args["out"], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
