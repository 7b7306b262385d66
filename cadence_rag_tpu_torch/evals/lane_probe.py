"""Each lane's device time at production shapes, beside the JAX probe's
lane variants, with every variant's answer held to the served lane's.

Counterpart of ``cadence_rag_tpu/evals/lane_probe.py``. The corpus is made
on the device from a ``torch.Generator`` (nothing crosses PCIe); the queries
come from numpy's generator, seeded as the JAX probe seeds them. Two kinds
of lane are timed, with CUDA events over ``--iters`` launches after two warm
ones (on the CPU, the host clock):

- the port's served lanes: kernel K1 dense + lexical and lexical-only
  (``ops/fused_scan.fused_topk``), kernel K3 with its final ``torch.topk``
  (``ops/tech_keys.tech_topk_keys``), the exact dense lane
  (``ops/topk.masked_topk_exact`` over ``dense_scores``) and the device RRF
  (``ops/fusion.rrf_fuse_lanes_device``) over K1's and K3's lanes;
- the JAX probe's variants, each a plain torch function of the JAX
  function's name: ``lane_dense`` and ``lane_lex``, the bf16-plane variants
  and the tech variants (``current``, ``slotted``, ``slotted_unrolled``,
  ``onepass``, ``percol``, ``percol_t``, ``summary``).

The lines keep the JAX probe's labels (``lex int8->bf16``: int8 values are
exact in bf16 and in the f32 these variants widen them to); the kernels'
lines are ``tech K3 kernel ...`` where the JAX probe's TPU-only lines are
``tech PALLAS kernel ...``. Where the JAX variants take
``jax.lax.approx_max_k``, these take the exact ``torch.topk``. The JAX tech variants broadcast ``(B, N, Q, S)`` and leave
the fusion to XLA; in eager torch that tensor would be over 100 GB of
booleans at 1M rows and batch 128, so the plain tech variants build their
(B, N) key plane over blocks of rows, each block's widest temporary at most
``TECH_BLOCK_BYTES`` (4,096 rows for ``current`` at batch 128, 131,072 for
the per-column variants, whose temporaries are (B, rows)), and the dense and
lexical variants build their score planes over blocks of ``PLANE_BLOCK_ROWS``
(the widened f32 rows). The dense query is rounded to bf16 values, as the
served dense lanes round it, so every lane scores the same products.

The tech corpus draws its tokens from [1, ``TECH_VOCAB``) (the synthetic
corpus's range), where the JAX probe draws from [1, 2^30) and nothing
matches; the queries draw from the same range, so every query matches
thousands of rows and the answers carry real rows.

**The answer check.** Each variant's top 50 is held to a served lane on the
same inputs, and the probe raises on a disagreement:

- ``lane_dense`` to the exact dense lane and to K1's dense lane;
  ``lane_lex`` to both K1 scans' lexical lanes; the bf16-plane variants to
  the exact dense lane and to K1's lexical-only lane. K1 keeps one winner
  per 8-row group (``ops/fused_scan``), so against K1 the variant's list is
  first cut to each group's first row and compared group by group; K1's
  values must also be the scores of the rows it names.
- Each tech variant to K3 given the same matches in its slot-aligned form:
  the any-slot query of ``current`` and ``summary`` with each token in every
  slot, ``slotted``'s (B, S, C) as K3's (B, C*S), ``summary``'s bitmap
  prefilter as K3's mask.
- The device RRF to the host merge (``ops/fusion.rrf_merge_batch``) of the
  same lanes.

Values must agree within the lane's tolerance (the bf16-plane variants:
their rounding), and the ids must be the same except among near-ties: a
position may hold another id (another group, against K1) only where its
value lies within the tolerance of the list's last value. ``-inf`` entries
(a query with fewer matches than k) carry no id.

Usage:
  python -m cadence_rag_tpu_torch.evals.lane_probe [--device cuda|cpu]
      [--n 1000000] [--batch 128] [--iters 20]
      [--probe dense|lex|plane|tech|all]
Prints one line per timed lane, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

S = 16                      # tech_hash_slots
K = 50
TECH_VOCAB = 5000
PLANE_BLOCK_ROWS = 65536    # bounds the widened f32 rows: 65536 x 4096 x 4 B = 1 GB
TECH_BLOCK_BYTES = 1 << 26  # bounds a tech variant's widest temporary: 64 MB
DENSE_ATOL = 1e-4           # 1024-term f32 sums of bf16 products, |score| <~ 5
LEX_ATOL = 3e-3             # 4096-term f32 sums in two orders, |score| up to ~75
RRF_ATOL = 1e-6             # f32 (device) against f64 (host) sums of 1/(60 + r)
NEG_INF = float("-inf")

Lane = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------- corpus ----

def _gen_emb(gen, n, dim, device):
    out = torch.empty((n, dim), dtype=torch.bfloat16, device=device)
    for r0 in range(0, n, PLANE_BLOCK_ROWS):
        r1 = min(n, r0 + PLANE_BLOCK_ROWS)
        v = torch.randn((r1 - r0, dim), generator=gen, device=device)
        out[r0:r1] = (v / torch.linalg.vector_norm(v, dim=1, keepdim=True)).bfloat16()
    return out


def _gen_lex(gen, n, lex_dim, device):
    return torch.randint(-8, 8, (n, lex_dim), generator=gen, device=device,
                         dtype=torch.int8)


def _gen_tech(gen, n, device):
    return torch.randint(1, TECH_VOCAB, (n, S), generator=gen, device=device,
                         dtype=torch.int32)


def _gen_started(gen, n, device):
    return torch.randint(0, 1 << 30, (n,), generator=gen, device=device,
                         dtype=torch.int32)


# ----------------------------------------------------------------- lanes ----

def _plane(n: int, batch: int, device, block: int,
           fill: Callable[[int, int], torch.Tensor],
           dtype=torch.float32) -> torch.Tensor:
    """A (B, n) plane, filled ``block`` rows at a time."""
    out = torch.empty((batch, n), dtype=dtype, device=device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        out[:, r0:r1] = fill(r0, r1)
    return out


def _top(plane: torch.Tensor, k: int = K) -> Lane:
    """Exact top-k (where the JAX variants take ``approx_max_k``)."""
    vals, rows = torch.topk(plane, min(k, plane.shape[1]), dim=1)
    return vals.float(), rows


def _scores(q, table, block=PLANE_BLOCK_ROWS, dtype=torch.float32):
    """q (B, K) f32 times the (N, K) rows widened to f32, f32 sums."""
    return _plane(table.shape[0], q.shape[0], q.device, block,
                  lambda r0, r1: (q @ table[r0:r1].float().T).to(dtype), dtype)


def lane_dense(emb, q):
    return _top(_scores(q, emb))


def lane_lex(lex, q):
    return _top(_scores(q, lex))


def lane_dense_bf16plane(emb, q):
    """The (B, N) plane narrowed to bf16 between the product and the top-k,
    widened back for it."""
    return _top(_scores(q, emb, dtype=torch.bfloat16).float())


def lane_dense_bf16plane_native(emb, q):
    """The same, with the top-k over the bf16 plane itself."""
    return _top(_scores(q, emb, dtype=torch.bfloat16))


def lane_lex_bf16plane(lex, q):
    return _top(_scores(q, lex, dtype=torch.bfloat16).float())


def _recency(started):
    return started.contiguous().view(torch.float32)


def _tech_lane(started, match: Callable[[int, int], torch.Tensor], batch,
               width: int) -> Lane:
    """Recency keys where ``match(r0, r1)`` holds, -inf elsewhere, over
    blocks of rows whose widest temporary, ``width`` bytes a (query, row)
    (at least the f32 key), fits ``TECH_BLOCK_BYTES``; their exact top-k."""
    rec = _recency(started)

    def keys(r0, r1):
        m = match(r0, r1)
        return torch.where(m, rec[None, r0:r1], torch.full_like(m, NEG_INF, dtype=torch.float32))

    block = max(1024, TECH_BLOCK_BYTES // (batch * max(width, 4)) // 1024 * 1024)
    return _top(_plane(started.shape[0], batch, started.device, block, keys))


def _match_any_slot(tech, q_tech, r0, r1):
    t = tech[r0:r1]
    eq = q_tech[:, None, :, None] == t[None, :, None, :]
    nonzero = q_tech[:, None, :, None] != 0
    return (eq & nonzero).any(dim=3).any(dim=2)


def lane_tech_current(tech, started, q_tech):
    """The (B, N, Q, S) broadcast compare: any query token in any slot."""
    return _tech_lane(started, lambda r0, r1: _match_any_slot(tech, q_tech, r0, r1),
                      q_tech.shape[0], q_tech.shape[1] * tech.shape[1])


def lane_tech_slotted(tech, started, q_by_slot):
    """Slot-aligned: the query's (B, S, C) hashes against each row's slot."""
    def match(r0, r1):
        eq = q_by_slot[:, None, :, :] == tech[None, r0:r1, :, None]
        nonzero = q_by_slot[:, None, :, :] != 0
        return (eq & nonzero).any(dim=3).any(dim=2)

    return _tech_lane(started, match, q_by_slot.shape[0],
                      q_by_slot.shape[1] * q_by_slot.shape[2])


def lane_tech_slotted_unrolled(tech, started, q_by_slot):
    """Slot-aligned, the capacity C unrolled into (B, N, S) passes."""
    def match(r0, r1):
        t = tech[r0:r1]
        hit = None
        for c in range(q_by_slot.shape[2]):
            q = q_by_slot[:, :, c]
            eq = (q[:, None, :] == t[None, :, :]) & (q[:, None, :] != 0)
            hit = eq.any(dim=2) if hit is None else hit | eq.any(dim=2)
        return hit

    return _tech_lane(started, match, q_by_slot.shape[0], q_by_slot.shape[1])


def lane_tech_onepass(tech, started, q_one):
    """One (B, N, S) compare pass (C = 1)."""
    def match(r0, r1):
        t = tech[r0:r1]
        return ((q_one[:, None, :] == t[None]) & (q_one[:, None, :] != 0)).any(dim=2)

    return _tech_lane(started, match, q_one.shape[0], q_one.shape[1])


def lane_tech_percol(tech, started, q_one):
    """S passes of (B, N) compares over the (N, S) rows' columns."""
    def match(r0, r1):
        hit = None
        for s in range(tech.shape[1]):
            h = (q_one[:, s, None] == tech[None, r0:r1, s]) & (q_one[:, s, None] != 0)
            hit = h if hit is None else hit | h
        return hit

    return _tech_lane(started, match, q_one.shape[0], 1)


def lane_tech_percol_t(tech_t, started, q_one):
    """The same over transposed (S, N) storage: contiguous slot rows."""
    def match(r0, r1):
        hit = None
        for s in range(tech_t.shape[0]):
            h = (q_one[:, s, None] == tech_t[s][None, r0:r1]) & (q_one[:, s, None] != 0)
            hit = h if hit is None else hit | h
        return hit

    return _tech_lane(started, match, q_one.shape[0], 1)


def lane_tech_summary(tech_bits, tech, started, q_bits, q_tech):
    """A 32-bit per-row summary bitmap as a prefilter, then the full
    any-slot compare, masked by it."""
    def match(r0, r1):
        hit = (tech_bits[None, r0:r1] & q_bits[:, None]) != 0
        return _match_any_slot(tech, q_tech, r0, r1) & hit

    return _tech_lane(started, match, q_tech.shape[0], q_tech.shape[1] * tech.shape[1])


# ------------------------------------------------------- the answer check ----

def group_of(rows: np.ndarray) -> np.ndarray:
    """K1's 8-row group of each row: block ``row // 1024``, lane ``row % 128``."""
    from ..ops.fused_scan import BLOCK_ROWS, GROUPS

    return (rows // BLOCK_ROWS) * GROUPS + rows % GROUPS


def _host(lane: Lane) -> Tuple[np.ndarray, np.ndarray]:
    return lane[0].float().cpu().numpy(), lane[1].cpu().numpy().astype(np.int64)


def agree_row(got_v, got_i, want_v, want_i, atol, grouped=False) -> Tuple[float, int]:
    """One query: the served lane (got) against a variant (want). ->
    (largest value difference, ids that differ beyond near-ties)."""
    fin = np.isfinite(want_v)
    v, i = want_v[fin], want_i[fin]
    keys = group_of(i) if grouped else i
    if grouped:
        _, first = np.unique(keys, return_index=True)
        first.sort()
        v, i, keys = v[first], i[first], keys[first]
    m = len(v)
    gv, gi = got_v[:m], got_i[:m]
    bad = int(not np.isfinite(gv).all())
    if not grouped:   # fewer matches than k: the rest carry -inf
        bad += int(np.isfinite(got_v[m:]).sum())
    if m == 0 or bad:
        return 0.0, bad
    gkeys = group_of(gi) if grouped else gi
    missing = set(keys[v > v[-1] + atol]) - set(gkeys)
    extra = set(gkeys[gv > gv[-1] + atol]) - set(keys)
    return float(np.abs(gv - v).max()), len(missing) + len(extra)


def agree(got: Lane, want: Lane, atol: float, grouped=False) -> Dict:
    gv, gi = _host(got)
    wv, wi = _host(want)
    err, bad = 0.0, 0
    for b in range(gv.shape[0]):
        e, n = agree_row(gv[b], gi[b], wv[b], wi[b], atol, grouped)
        err, bad = max(err, e), bad + n
    return {"max_abs_err": err, "ids_differ": bad, "atol": atol,
            "ok": bad == 0 and err <= atol}


def row_scores(q, table, rows) -> torch.Tensor:
    """The f32 scores of the named rows: (B, k)."""
    return (table[rows].float() * q[:, None, :]).sum(-1)


def k1_rows_hold(q, table, lane: Lane, atol) -> Dict:
    """K1's values are the scores of the rows it names."""
    vals, rows = lane
    fin = torch.isfinite(vals)
    err = float((row_scores(q, table, rows) - vals).abs()[fin].max()) if fin.any() else 0.0
    return {"max_abs_err": err, "ok": err <= atol}


def rrf_against_host(fused, lanes: Dict[str, Lane]) -> Dict:
    """The device RRF's order against the host merge of the same lanes."""
    from ..ops.fusion import rrf_merge_batch

    pos, score, _masks, counts = (t.cpu().numpy() for t in fused)
    host = {name: _host(lane) for name, lane in lanes.items()}
    plans = [{name: i[b][np.isfinite(v[b])] for name, (v, i) in host.items()}
             for b in range(pos.shape[0])]
    err, bad = 0.0, 0
    for b, (ids, scores, _m, _n) in enumerate(rrf_merge_batch(plans)):
        n = int(counts[b])
        if n != len(ids):
            bad += 1
            continue
        e, d = agree_row(score[b, :n].astype(np.float64), pos[b, :n].astype(np.int64),
                         scores, ids, RRF_ATOL)
        err, bad = max(err, e), bad + d
    return {"max_abs_err": err, "ids_differ": bad, "atol": RRF_ATOL,
            "ok": bad == 0 and err <= RRF_ATOL}


# ---------------------------------------------------------------- timing ----

def timed(fn, *args, iters=20, label="", device=None):
    """ms a launch: CUDA events around ``iters`` launches after two warm
    ones (the first builds the kernels); the host clock on the CPU. ->
    (ms, the last output)"""
    fn(*args)
    out = fn(*args)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        ms, how = start.elapsed_time(end) / iters, "cuda events"
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        ms, how = (time.perf_counter() - t0) / iters * 1e3, "host clock"
    print(f"{label:<28} {ms:8.3f} ms/dispatch ({how} x{iters})")
    return ms, out


# ------------------------------------------------------------------ main ----

def run(device="cuda", n: int = 1_000_000, batch: int = 128, iters: int = 20,
        lex_dim: int = 4096, dim: int = 1024, probe: str = "all", q: int = 8,
        c: int = 3) -> Dict:
    from ..device import pin_f32_matmul, resolve_device
    from ..ops.fused_scan import fused_topk
    from ..ops.fusion import rrf_fuse_lanes_device
    from ..ops.pack import LANE_ORDER
    from ..ops.tech_keys import tech_topk_keys
    from ..ops.topk import dense_scores, masked_topk_exact
    from .rtt_probe import device_name

    dev = resolve_device(device)
    pin_f32_matmul(dev)
    b = batch
    print(f"backend={dev.type} device={device_name(dev)} n={n} batch={b}")
    gen = torch.Generator(device=dev)
    rng = np.random.default_rng(0)
    lanes: List[Dict] = []
    failed: List[str] = []

    def t(label, fn, *args):
        ms, out = timed(fn, *args, iters=iters, label=label, device=dev)
        lanes.append({"lane": label, "ms": round(ms, 4)})
        return out

    def hold(label, check):
        lanes[-1].setdefault("checks", {})[label] = check
        if not check["ok"]:
            failed.append(f"{lanes[-1]['lane']} against {label}: {check}")

    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    has_emb = torch.ones(n, dtype=torch.bool, device=dev)
    served: Dict[str, Lane] = {}

    def dense_and_lex():
        gen.manual_seed(0)
        emb = _gen_emb(gen, n, dim, dev)
        gen.manual_seed(1)
        lex = _gen_lex(gen, n, lex_dim, dev)
        # the dense query in bf16 values: the served lanes round it so
        qd = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32)).to(dev)
        qd = qd.bfloat16().float()
        ql = torch.from_numpy(
            (rng.standard_normal((b, lex_dim)) * 0.05).astype(np.float32)).to(dev)
        return emb, lex, qd, ql

    if probe in ("dense", "lex", "all", "plane"):
        emb, lex, qd, ql = dense_and_lex()
        k1 = t("K1 dense+lexical", lambda: fused_topk(
            qd, ql, emb, lex, mask, has_emb, k_dense=K, k_lex=K, dense=True))
        hold("its rows' scores (dense)", k1_rows_hold(qd, emb, k1["dense"], DENSE_ATOL))
        hold("its rows' scores (lexical)", k1_rows_hold(ql, lex, k1["lex"], LEX_ATOL))
        k1_lex = t("K1 lexical-only", lambda: fused_topk(
            None, ql, emb, lex, mask, has_emb, k_dense=K, k_lex=K, dense=False))["lex"]
        hold("its rows' scores", k1_rows_hold(ql, lex, k1_lex, LEX_ATOL))
        exact = t("exact dense (ops/topk)", lambda: masked_topk_exact(
            dense_scores(qd, emb), mask & has_emb[None, :], K))
        served.update(k1_dense=k1["dense"], k1_lex=k1["lex"], k1_lex_only=k1_lex,
                      exact_dense=exact)
        plane = probe == "plane"
        if probe in ("dense", "all", "plane"):
            out = t(f"dense f32 plane ({dim})" if plane else f"dense bf16 ({dim})",
                    lane_dense, emb, qd)
            hold("exact dense lane", agree(exact, out, DENSE_ATOL))
            hold("K1 dense", agree(k1["dense"], out, DENSE_ATOL, grouped=True))
        if probe in ("lex", "all", "plane"):
            out = t(f"lex f32 plane ({lex_dim})" if plane else f"lex int8->bf16 ({lex_dim})",
                    lane_lex, lex, ql)
            hold("K1 lexical", agree(k1["lex"], out, LEX_ATOL, grouped=True))
            hold("K1 lexical-only", agree(k1_lex, out, LEX_ATOL, grouped=True))
        if plane:
            bf16_atol = float(exact[0][torch.isfinite(exact[0])].abs().max()) * 2.0 ** -8
            for label, fn in (("dense bf16 plane (widen)", lane_dense_bf16plane),
                              ("dense bf16 plane (native)", lane_dense_bf16plane_native)):
                out = t(label, fn, emb, qd)
                hold("exact dense lane", agree(exact, out, bf16_atol))
            lex_atol = float(k1_lex[0][torch.isfinite(k1_lex[0])].abs().max()) * 2.0 ** -8
            out = t("lex bf16 plane (widen)", lane_lex_bf16plane, lex, ql)
            hold("K1 lexical-only", agree(k1_lex, out, lex_atol, grouped=True))
        del emb, lex

    if probe in ("tech", "all"):
        gen.manual_seed(2)
        tech = _gen_tech(gen, n, dev)
        started = _gen_started(gen, n, dev)

        def ints(shape):
            return torch.from_numpy(rng.integers(1, TECH_VOCAB, shape).astype(np.int32)).to(dev)

        q_tech = ints((b, q))
        any_slot = q_tech.repeat_interleave(S, dim=1)   # column c*S+s holds token c
        k3 = t(f"tech K3 kernel (Q={q} in every slot)", lambda: tech_topk_keys(
            tech, started, any_slot, mask, K))
        served["k3"] = k3
        out = t(f"tech current (Q={q},S={S})", lane_tech_current, tech, started, q_tech)
        hold("K3", agree(k3, out, 0.0))
        q_slot = ints((b, S, c))
        by_column = q_slot.permute(0, 2, 1).reshape(b, c * S).contiguous()
        k3_slot = t(f"tech K3 kernel (S={S},C={c})", lambda: tech_topk_keys(
            tech, started, by_column, mask, K))
        out = t(f"tech slotted (S={S},C={c})", lane_tech_slotted, tech, started, q_slot)
        hold("K3", agree(k3_slot, out, 0.0))
        for cc in (2, 3):
            q_u = ints((b, S, cc))
            want = tech_topk_keys(tech, started,
                                  q_u.permute(0, 2, 1).reshape(b, cc * S).contiguous(),
                                  mask, K)
            out = t(f"tech slotted unrolled C={cc}", lane_tech_slotted_unrolled,
                    tech, started, q_u)
            hold("K3", agree(want, out, 0.0))
        q_one = ints((b, S))
        k3_one = t(f"tech K3 kernel (Q={S}, one a slot)", lambda: tech_topk_keys(
            tech, started, q_one, mask, K))
        for label, fn, table in (("tech one-pass (B,N,S)", lane_tech_onepass, tech),
                                 ("tech per-col (S x (B,N))", lane_tech_percol, tech)):
            out = t(label, fn, table, started, q_one)
            hold("K3", agree(k3_one, out, 0.0))
        tech_t = tech.T.contiguous()
        out = t("tech per-col transposed", lane_tech_percol_t, tech_t, started, q_one)
        hold("K3", agree(k3_one, out, 0.0))
        del tech_t
        bits = torch.from_numpy(rng.integers(0, 1 << 31, n).astype(np.int32)).to(dev)
        qbits = torch.from_numpy(rng.integers(0, 1 << 31, b).astype(np.int32)).to(dev)
        hit = (bits[None, :] & qbits[:, None]) != 0
        want = tech_topk_keys(tech, started, any_slot, hit, K)
        out = t("tech summary+full", lane_tech_summary, bits, tech, started, qbits, q_tech)
        hold("K3 under the bitmap's mask", agree(want, out, 0.0))

    if probe == "all":
        fusing = {"lex": served["k1_lex"], "tech": served["k3"],
                  "dense": served["k1_dense"]}
        fused = t("RRF (device, 3 lanes)", lambda: rrf_fuse_lanes_device(fusing, LANE_ORDER))
        hold("host RRF", rrf_against_host(fused, fusing))

    rec = {"n": n, "batch": b, "iters": iters, "probe": probe, "lanes": lanes,
           "checks_failed": failed, "device": device_name(dev)}
    print(json.dumps(rec))
    if failed:
        raise RuntimeError("lane_probe: a variant's answer disagrees with the served "
                           "lane's: " + "; ".join(failed))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--lex-dim", type=int, default=4096)
    parser.add_argument("--dim", type=int, default=1024)
    parser.add_argument("--probe", default="all",
                        choices=["tech", "lex", "dense", "plane", "all"])
    parser.add_argument("--q", type=int, default=8,
                        help="query tech slots for the current lane")
    parser.add_argument("--c", type=int, default=3,
                        help="per-slot query capacity for slotted lane")
    args = parser.parse_args(argv)
    run(args.device, args.n, args.batch, args.iters, args.lex_dim, args.dim,
        args.probe, args.q, args.c)


if __name__ == "__main__":
    main()
