"""Reciprocal Rank Fusion: on the device, and the host oracle.

Counterpart of ``cadence_rag_tpu/ops/fusion.py``. The reference fuses lanes
with score = sum over lanes of 1/(60 + rank), sorted by score descending
with first-occurrence order breaking ties (reference app/retrieve.py:245-260).

- ``rrf_fuse_lanes_device``: the merge inside the device program, as torch
  ops; sums in f32 (the host oracle sums in f64, so candidates whose f64
  scores differ below f32 resolution may swap — the oracle decides).
- ``rrf_merge_arrays`` … ``rrf_merge_rect``: the host merge, numpy over the
  port's copy of the native C++ core (``native/rrf.py``). Same f64
  accumulation order and the same (score desc, first occurrence) order as
  the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from ..native import rrf as native_rrf

DEFAULT_RRF_K = 60

MergedRow = Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[str, ...]]


def rrf_fuse_lanes_device(
    outs: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
    lane_order: Sequence[str],
    k: int = DEFAULT_RRF_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """outs: {lane: (vals (B, k_lane) sorted desc with -inf sentinels,
    positions (B, k_lane))}. -> (positions (B, K) i32, fused (B, K) f32,
    lane masks (B, K) i32, counts (B,) i32), sorted by (fused desc, slot
    asc); K = sum of lane widths."""
    vals_parts, pos_parts, contrib_parts, bits_parts, lane_of = [], [], [], [], []
    for i, name in enumerate(lane_order):
        if name not in outs:
            continue
        v, p = outs[name]
        width = v.shape[1]
        dev = v.device
        vals_parts.append(v.float())
        pos_parts.append(p.to(torch.int32))
        # built on the device: a host upload here would wait for the lanes
        # already enqueued on the stream and block the dispatching thread
        ranks = torch.arange(1, width + 1, dtype=torch.float32, device=dev)
        contrib_parts.append(1.0 / (k + ranks))
        bits_parts.append(torch.full((width,), 1 << i, dtype=torch.int32,
                                     device=dev))
        lane_of.append(width)
    vals = torch.cat(vals_parts, dim=1)                      # (B, K)
    pos = torch.cat(pos_parts, dim=1)                        # (B, K)
    dev = pos.device
    contrib = torch.cat(contrib_parts)                       # (K,)
    bits = torch.cat(bits_parts)                             # (K,)
    K = pos.shape[1]
    valid = torch.isfinite(vals)
    slot = torch.arange(K, dtype=torch.int32, device=dev)
    # unique negative keys for invalid slots so they never aggregate
    keyed = torch.where(valid, pos, -1 - slot[None, :])
    eq = keyed[:, :, None] == keyed[:, None, :]              # (B, K, K)
    contrib_v = torch.where(valid, contrib[None, :], torch.zeros_like(vals))
    # each lane holds a doc at most once, so a lane's slice of the sum has
    # one nonzero term: summing lane by lane in lane order keeps the f32
    # additions in the same order as a sequential sum over slots
    fused = torch.zeros_like(vals)
    start = 0
    for width in lane_of:
        sl = slice(start, start + width)
        fused = fused + (eq[:, :, sl].float() * contrib_v[:, None, sl]).sum(-1)
        start += width
    masks = (eq.to(torch.int32) * bits[None, None, :]).sum(-1).to(torch.int32)
    earlier = slot[:, None] > slot[None, :]                  # (K, K)
    dup = (eq & earlier[None]).any(dim=-1)
    keep = valid & ~dup
    sort_primary = torch.where(keep, -fused, torch.full_like(fused, float("inf")))
    # a stable sort on the primary key keeps slot order among ties: the
    # (primary, slot) two-key sort of jax.lax.sort(num_keys=2)
    _, order = torch.sort(sort_primary, dim=1, stable=True)
    counts = keep.sum(dim=1).to(torch.int32)
    return (torch.gather(pos, 1, order), torch.gather(fused, 1, order),
            torch.gather(masks, 1, order), counts)


def lane_mask_names(mask: int, lane_names: Sequence[str]) -> Set[str]:
    return {name for i, name in enumerate(lane_names) if mask & (1 << i)}


def _contrib(k: int, n: int) -> np.ndarray:
    return 1.0 / (k + np.arange(1, n + 1, dtype=np.float64))


def _empty() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64),
            np.zeros(0, dtype=np.uint8))


def _check_lanes(names: Sequence[str]) -> None:
    # lane provenance rides a uint8 bitmask (bit = 1 << lane index)
    if len(names) > 8:
        raise ValueError(f"rrf merge supports at most 8 lanes, got {len(names)}")


def rrf_merge_arrays(
    lanes: Dict[str, np.ndarray], k: int = DEFAULT_RRF_K
) -> MergedRow:
    """One plan's lanes ({lane: doc ids best-first}) -> (doc_ids, fused
    f64 scores, lane bitmasks u8, lane_names), by score desc with first
    occurrence breaking ties (dict insertion + stable sort)."""
    return rrf_merge_batch([lanes], k)[0]


def rrf_merge_batch(
    per_plan_lanes: Sequence[Dict[str, np.ndarray]], k: int = DEFAULT_RRF_K
) -> List[MergedRow]:
    """``rrf_merge_arrays`` for many plans in one pass, keyed by (plan, doc)."""
    parts_ids, parts_contrib, parts_bits, parts_plan = [], [], [], []
    names_per_plan: List[Tuple[str, ...]] = []
    for p, lanes in enumerate(per_plan_lanes):
        names = tuple(lanes.keys())
        _check_lanes(names)
        names_per_plan.append(names)
        for i, name in enumerate(names):
            ids = np.asarray(lanes[name], dtype=np.int64)
            if ids.size == 0:
                continue
            parts_ids.append(ids)
            parts_contrib.append(_contrib(k, ids.size))
            parts_bits.append(np.full(ids.size, 1 << i, dtype=np.uint8))
            parts_plan.append(np.full(ids.size, p, dtype=np.int64))
    n_plans = len(per_plan_lanes)
    if not parts_ids:
        return [_empty() + (names_per_plan[p],) for p in range(n_plans)]
    return _merge_flat(
        np.concatenate(parts_plan), np.concatenate(parts_ids),
        np.concatenate(parts_contrib), np.concatenate(parts_bits),
        n_plans, names_per_plan,
    )


def _merge_flat(
    all_plan: np.ndarray, all_ids: np.ndarray, all_contrib: np.ndarray,
    all_bits: np.ndarray, n_plans: int, names_per_plan,
) -> List[MergedRow]:
    """Group flat (plan, doc) entries, accumulate f64 scores in input order,
    OR masks, sort (plan, -score, first), split by plan."""
    native = native_rrf.merge_groups(
        all_plan.astype(np.int32, copy=False), all_ids, all_contrib,
        all_bits, n_plans,
    )
    if native is not None:
        plan_sorted, doc_sorted, score_sorted, mask_sorted = native
        plan_sorted = plan_sorted.astype(np.int64, copy=False)
    else:
        base = int(all_ids.max()) + 1  # doc ids are non-negative
        key = all_plan * base + all_ids
        uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
        scores = np.zeros(uniq.size, dtype=np.float64)
        np.add.at(scores, inv, all_contrib)      # accumulation order = lane order
        masks = np.zeros(uniq.size, dtype=np.uint8)
        np.bitwise_or.at(masks, inv, all_bits)
        uniq_plan = uniq // base
        order = np.lexsort((first, -scores, uniq_plan))
        plan_sorted = uniq_plan[order]
        doc_sorted = (uniq - uniq_plan * base)[order]
        score_sorted = scores[order]
        mask_sorted = masks[order]
    return _split_plans(plan_sorted, doc_sorted, score_sorted, mask_sorted,
                        n_plans, names_per_plan)


def _split_plans(
    plan_sorted: np.ndarray, doc_sorted: np.ndarray,
    score_sorted: np.ndarray, mask_sorted: np.ndarray,
    n_plans: int, names_per_plan,
) -> List[MergedRow]:
    bounds = np.searchsorted(plan_sorted, np.arange(n_plans + 1))
    out = []
    for p in range(n_plans):
        s, e = int(bounds[p]), int(bounds[p + 1])
        if s == e:
            out.append(_empty() + (names_per_plan[p],))
        else:
            out.append((doc_sorted[s:e], score_sorted[s:e], mask_sorted[s:e],
                        names_per_plan[p]))
    return out


def rrf_merge_rect(
    lanes: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    k: int = DEFAULT_RRF_K,
) -> List[MergedRow]:
    """``rrf_merge_batch`` over rectangular lane blocks ({lane: (ids (B, k)
    i64, scores (B, k), counts (B,) valid-prefix lengths)})."""
    names = tuple(lanes.keys())
    _check_lanes(names)
    n_plans = next(iter(lanes.values()))[0].shape[0] if lanes else 0
    native = native_rrf.merge_rect_groups(
        [(ids2d, counts) for ids2d, _s, counts in lanes.values()], n_plans, k,
    )
    if native is not None:
        plan_sorted, doc_sorted, score_sorted, mask_sorted = native
        return _split_plans(plan_sorted.astype(np.int64, copy=False),
                            doc_sorted, score_sorted, mask_sorted, n_plans,
                            [names] * n_plans)
    parts_ids, parts_contrib, parts_bits, parts_plan = [], [], [], []
    for i, name in enumerate(names):
        ids2d, _scores, counts = lanes[name]
        batch, width = ids2d.shape
        if width == 0:
            continue
        valid = np.arange(width)[None, :] < np.asarray(counts)[:, None]
        flat_ids = np.asarray(ids2d, dtype=np.int64)[valid]
        if flat_ids.size == 0:
            continue
        parts_ids.append(flat_ids)
        parts_contrib.append(np.broadcast_to(_contrib(k, width), (batch, width))[valid])
        parts_bits.append(np.full(flat_ids.size, 1 << i, dtype=np.uint8))
        parts_plan.append(np.broadcast_to(
            np.arange(batch, dtype=np.int64)[:, None], (batch, width))[valid])
    if not parts_ids:
        return [_empty() + (names,) for _ in range(n_plans)]
    return _merge_flat(
        np.concatenate(parts_plan), np.concatenate(parts_ids),
        np.concatenate(parts_contrib), np.concatenate(parts_bits),
        n_plans, [names] * n_plans,
    )
