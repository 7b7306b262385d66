"""Cold tier: host-memory document rows beyond the device-row cap.

Counterpart of ``cadence_rag_tpu/core/coldtier.py``. Device memory bounds
the hot corpus; a deployment can still hold a larger one by spilling rows
past ``INDEX_MAX_DEVICE_ROWS`` into host memory. The cold rows keep the hot
tier's layout (storage-dtype embeddings, int8 lexical signatures, tech
slots, call/date scalars) and are scanned by the SAME lane program
(``ops/fused._lanes_one_corpus``: kernels K1 and K3 on the card) in blocks
of ``COLD_BLOCK_ROWS`` streamed through the device per query batch, then
lane-merged with the hot results before RRF. Scoring is identical by
construction — same formulas, corpus-wide df/avgdl/idf — and with a cap and
a block size that are multiples of 1024 every cold row sits in the same
1024-row block and strided group as in an uncapped index, so the answers
match it; the trade is bandwidth: each batch re-ships the cold blocks over
the host link.

What changes from JAX. The row arrays are CPU tensors, pinned when the
index lives on a CUDA device (bf16 as ``torch.bfloat16``). A block is not
copied on the host: ``dispatch`` enqueues a non-blocking copy from the
pinned rows into staging tensors on the device, allocated once per tier,
and runs the lane program on them, all on the device's current stream and
under the corpus lock. The copy engine reads the pinned rows after the lock
is released, so every writer to rows a queued copy may read (``set_*``,
``tombstone``, ``compact``, and growth, which frees the old arrays) first
waits for the last enqueued copy (``_wait_copies``); an append writes only
rows past every queued block and needs no wait. The arrays grow by
doubling, and an insert allocates the larger ones before it takes the corpus
lock (``spare_arrays``): pinning gigabytes takes tenths of a second. The ragged tail block is
shipped as it is: eager torch compiles nothing per shape and the kernels
take ragged row counts.

Not supported with a sharded mesh; ``CorpusIndex`` refuses the combination.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..logging_utils import get_logger
from ..ops.fused import _lanes_one_corpus
from ..utils import events

logger = get_logger(__name__)

INT32_MIN = -2147483648

# a tier's row arrays, in the order of ``core/index.DEVICE_ARRAYS``
ROW_ARRAYS = ("emb", "lex", "tech", "call_idx", "started", "has_emb")

LaneBlocks = Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _host(arr) -> torch.Tensor:
    """A host array or tensor as a CPU tensor (no copy where it can)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(arr))


@dataclasses.dataclass
class ColdBlock:
    """One dispatched block: the lanes' host copies (pinned and filled by a
    non-blocking copy on CUDA; ready once the dispatch's event is), the
    block's doc ids as they were at dispatch, and its row count."""

    lanes: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    ids: np.ndarray
    rows: int


class ColdTier:
    """Host-side row arrays for one corpus, layout-identical to the hot
    tier. All mutation happens under the owning CorpusIndex's lock."""

    def __init__(self, *, dim: int, lex_dim: int, tech_slots: int,
                 emb_dtype: torch.dtype, device: torch.device) -> None:
        self.dim = dim
        self.lex_dim = lex_dim
        self.tech_slots = tech_slots
        self.emb_dtype = emb_dtype
        self.device = device
        self.pinned = device.type == "cuda"
        self.capacity = 0
        self.count = 0
        self.tombstones = 0
        self.emb_rows = 0
        # This tier's share of the corpus-wide lexical stats. Query-time
        # scoring uses the corpus totals (hot+cold agree on idf/avgdl);
        # checkpoints snapshot the HOT tier only, so the save subtracts
        # these deltas and the startup reconcile re-adds them when the
        # cold rows re-insert from the store.
        self.df = np.zeros(lex_dim, dtype=np.int64)
        self.dl_sum = 0
        self.ids = np.zeros(0, dtype=np.int64)
        self._id_to_pos: Dict[int, int] = {}
        # the device tensors a block is copied into, allocated at the first
        # dispatch and regrown only when a larger block is asked for
        self._staging: Optional[Tuple[torch.Tensor, ...]] = None
        # marks the end of the last enqueued block copy (CUDA only)
        self._last_copy: Optional[torch.cuda.Event] = None
        self._alloc(1024)

    # -- storage -----------------------------------------------------------
    def _shapes(self, cap: int):
        return {
            "emb": ((cap, self.dim), self.emb_dtype, 0),
            "lex": ((cap, self.lex_dim), torch.int8, 0),
            "tech": ((cap, self.tech_slots), torch.int32, 0),
            "call_idx": ((cap,), torch.int32, 0),
            "started": ((cap,), torch.int32, INT32_MIN),
            "has_emb": ((cap,), torch.bool, False),
        }

    def _new_arrays(self, cap: int) -> Dict[str, torch.Tensor]:
        """Empty row arrays of ``cap`` rows. Pinned allocations are slow
        (every page is locked in memory), which is why capacities double:
        timed as ``coldtier.alloc``."""
        with events.timed("coldtier.alloc", cap=int(cap),
                          pinned=bool(self.pinned)):
            return {name: torch.full(shape, fill, dtype=dtype,
                                     pin_memory=self.pinned)
                    for name, (shape, dtype, fill) in self._shapes(cap).items()}

    def spare_arrays(self, extra: int) -> Optional[Dict[str, torch.Tensor]]:
        """The larger row arrays that ``extra`` more rows would need, for the
        caller to allocate OFF the corpus lock (every dispatch takes it) and
        hand to ``insert``; None while the current arrays have room. The row
        count is read without the lock: a stale answer costs an allocation
        under the lock, or a spare thrown away."""
        need = self.count + extra
        if need <= self.capacity:
            return None
        return self._new_arrays(_next_pow2(need, lo=1024))

    def _alloc(self, cap: int,
               spare: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Move to arrays of at least ``cap`` rows (``spare`` if it is large
        enough, else new ones), carrying the live prefix over."""
        if spare is None or spare["lex"].shape[0] < cap:
            spare = self._new_arrays(cap)
        cap = spare["lex"].shape[0]
        # the old arrays are dropped below: no queued copy may still read them
        self._wait_copies()
        n = self.count
        for name, new in spare.items():
            old = getattr(self, name, None)
            if old is not None and n:
                new[:n].copy_(old[:n])
            setattr(self, name, new)
        ids = np.zeros(cap, dtype=np.int64)
        ids[:n] = self.ids[:n]
        self.ids = ids
        self.capacity = cap

    def _wait_copies(self) -> None:
        """Block until the last enqueued block copy has read the rows."""
        if self._last_copy is not None:
            self._last_copy.synchronize()
            self._last_copy = None

    def row_arrays(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, name) for name in ROW_ARRAYS)

    @property
    def live_count(self) -> int:
        return self.count - self.tombstones

    def contains(self, doc_id: int) -> bool:
        return int(doc_id) in self._id_to_pos

    def positions(self, doc_ids: Sequence[int]) -> np.ndarray:
        return np.array(
            [self._id_to_pos.get(int(d), -1) for d in doc_ids],
            dtype=np.int64,
        )

    def live_ids(self) -> np.ndarray:
        """Doc ids of the rows not tombstoned."""
        n = self.count
        return self.ids[:n][self.started[:n].numpy() != INT32_MIN]

    # -- mutation (caller holds the corpus lock) ------------------------
    def insert(self, rows, encode_emb: Callable,
               spare: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Append rows. ``encode_emb`` maps (n, dim) f32 rows to a tensor of
        the storage dtype (``CorpusIndex._encode_emb``); ``spare`` is what
        ``spare_arrays`` gave the caller before it took the lock."""
        n = len(rows)
        if self.count + n > self.capacity:
            self._alloc(_next_pow2(self.count + n, lo=1024), spare)
        start = self.count
        emb = np.zeros((n, self.dim), dtype=np.float32)
        has = np.zeros(n, dtype=bool)
        for i, r in enumerate(rows):
            pos = start + i
            if r.embedding is not None:
                emb[i] = r.embedding
                has[i] = True
            self.ids[pos] = r.doc_id
            self._id_to_pos[int(r.doc_id)] = pos
            self.df[r.lex_touched] += 1
            self.dl_sum += r.lex_dl
        sl = slice(start, start + n)
        self.emb[sl] = encode_emb(emb).cpu()
        self.lex[sl] = _host(np.stack([r.lex_sig for r in rows]).astype(np.int8))
        self.tech[sl] = _host(np.stack([r.tech for r in rows]).astype(np.int32))
        self.call_idx[sl] = _host(
            np.array([r.call_seq for r in rows], dtype=np.int32))
        self.started[sl] = _host(
            np.array([r.started_sec for r in rows], dtype=np.int32))
        self.has_emb[sl] = _host(has)
        self.emb_rows += int(has.sum())
        self.count += n

    def set_embeddings(self, pos: np.ndarray, vals: np.ndarray,
                       encode_emb: Callable) -> int:
        self._wait_copies()
        idx = _host(np.asarray(pos, dtype=np.int64))
        self.emb[idx] = encode_emb(np.asarray(vals, dtype=np.float32)).cpu()
        fresh = int((~self.has_emb[idx]).sum())
        self.has_emb[idx] = True
        self.emb_rows += fresh
        return int(idx.shape[0])

    def set_tech(self, pos: np.ndarray, vals: np.ndarray) -> int:
        self._wait_copies()
        idx = _host(np.asarray(pos, dtype=np.int64))
        self.tech[idx] = _host(np.asarray(vals, dtype=np.int32))
        return int(idx.shape[0])

    def set_lex(self, pos: np.ndarray, vals: np.ndarray) -> int:
        self._wait_copies()
        idx = _host(np.asarray(pos, dtype=np.int64))
        vals = np.asarray(vals, dtype=np.int8)
        self.df -= (self.lex[idx].numpy() != 0).sum(axis=0)
        self.lex[idx] = _host(vals)
        self.df += (vals != 0).sum(axis=0)
        return int(idx.shape[0])

    def tombstone(self, pos: np.ndarray,
                  lex_sigs: Optional[Sequence] = None,
                  lex_dls: Optional[Sequence] = None) -> int:
        """``lex_sigs``/``lex_dls`` (aligned with ``pos``) shed this
        tier's share of the corpus lexical stats, mirroring the hot
        tier's delete contract."""
        self._wait_copies()
        pos = np.asarray(pos, dtype=np.int64)
        idx = _host(pos)
        self.emb_rows -= int(self.has_emb[idx].sum())
        self.started[idx] = INT32_MIN
        self.has_emb[idx] = False
        for doc_id in self.ids[pos]:
            self._id_to_pos.pop(int(doc_id), None)
        if lex_sigs is not None:
            for sig in lex_sigs:
                if sig is not None:
                    touched = np.flatnonzero(sig)
                    self.df[touched] = np.maximum(self.df[touched] - 1, 0)
        if lex_dls is not None:
            self.dl_sum = max(
                self.dl_sum - int(sum(int(d or 0) for d in lex_dls)), 0
            )
        self.tombstones += int(pos.shape[0])
        return int(pos.shape[0])

    def compact(self) -> None:
        """Drop tombstoned rows (a host gather to the front of the same
        arrays)."""
        self._wait_copies()
        n = self.count
        live = np.flatnonzero(self.started[:n].numpy() != INT32_MIN)
        m = int(live.shape[0])
        take = _host(live)
        for name, (_shape, _dtype, fill) in self._shapes(0).items():
            arr = getattr(self, name)
            arr[:m] = arr[take]
            if name != "emb":
                arr[m:n] = fill
        self.ids[:m] = self.ids[live]
        self.ids[m:n] = 0
        self.count = m
        self.tombstones = 0
        self._id_to_pos = {
            int(d): p for p, d in enumerate(self.ids[:m])
        }

    def estimate(self, allowed_calls: Optional[np.ndarray], date_min: int,
                 date_max: int, require_embedding: bool,
                 unfiltered: bool) -> int:
        n = self.count
        if n == 0:
            return 0
        if unfiltered:
            return self.emb_rows if require_embedding else self.live_count
        started = self.started[:n].numpy()
        mask = (started >= date_min) & (started <= date_max)
        if allowed_calls is not None:
            mask &= allowed_calls[self.call_idx[:n].numpy()]
        if require_embedding:
            mask &= self.has_emb[:n].numpy()
        return int(mask.sum())

    # -- query -----------------------------------------------------------
    def _staging_for(self, rows: int) -> Tuple[torch.Tensor, ...]:
        """The device tensors a block is copied into: one set per tier,
        regrown only for a larger block (1.6 GB at 262,144 full-width rows,
        so never per batch)."""
        if self._staging is None or self._staging[0].shape[0] < rows:
            self._staging = None  # drop before the larger allocation
            with events.timed("coldtier.staging_alloc", rows=int(rows)):
                self._staging = tuple(
                    torch.empty((rows,) + tuple(shape[1:]), dtype=dtype,
                                device=self.device)
                    for shape, dtype, _fill in self._shapes(rows).values()
                )
        return self._staging

    def dispatch(
        self,
        q_emb: Optional[torch.Tensor],    # (B, dim) f32 on the device
        q_lex: torch.Tensor,              # (B, lex_dim) f32 DENSE, on device
        q_tech: torch.Tensor,
        allowed_calls: torch.Tensor,
        date_min: torch.Tensor,
        date_max: torch.Tensor,
        *,
        ks: Tuple[int, int, int],
        dense_mode: str,
        block_rows: int,
    ) -> List[ColdBlock]:
        """Enqueue, per cold block, the copy of its rows to the device and
        one lane program over them, plus the non-blocking copy of the lanes
        back to the host, and return without waiting. Must be called under
        the corpus lock, with the query tensors already on the tier's
        device. On the CPU the program runs here, on the rows themselves.
        A writer that changes the rows after the lock is released waits for
        the copies first (``_wait_copies``), so no dispatch in flight reads
        a block a writer changed."""
        n = self.count
        if n == 0:
            return []
        batch = q_tech.shape[0]
        dense_enabled = q_emb is not None
        if q_emb is None:
            q_emb = torch.zeros((batch, self.dim), dtype=torch.float32,
                                device=self.device)
        # IVF never covers the cold tier; any non-exact mode scans approx
        mode = "exact" if dense_mode == "exact" else "ann"
        block = min(int(block_rows), _next_pow2(n, lo=1024))
        staging = self._staging_for(min(block, n)) if self.pinned else None
        out: List[ColdBlock] = []
        for start in range(0, n, block):
            stop = min(start + block, n)
            bn = stop - start
            arrays = tuple(a[start:stop] for a in self.row_arrays())
            if staging is not None:
                staged = tuple(s[:bn] for s in staging)
                for dst, src in zip(staged, arrays):
                    dst.copy_(src, non_blocking=True)
                arrays = staged
            k_dense, k_lex, k_tech = (min(k, bn) for k in ks)
            lanes = _lanes_one_corpus(
                *arrays, q_emb, q_lex, q_tech, allowed_calls, date_min,
                date_max, k_dense=k_dense, k_lex=k_lex, k_tech=k_tech,
                dense_mode=mode, dense_enabled=dense_enabled,
            )
            if self.pinned:
                lanes = {lane: tuple(_to_pinned(t) for t in pair)
                         for lane, pair in lanes.items()}
            out.append(ColdBlock(lanes=lanes, ids=self.ids[start:stop].copy(),
                                 rows=bn))
        if self.pinned:
            self._last_copy = torch.cuda.Event()
            self._last_copy.record(torch.cuda.current_stream(self.device))
            ColdTier.bytes_shipped += sum(
                a[:n].numel() * a.element_size() for a in self.row_arrays())
        return out


# bytes of cold rows copied to the device since the process started (the
# measurement of the cold batch's host-link rate reads it)
ColdTier.bytes_shipped = 0


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def merge_rect_lanes(
    base: LaneBlocks, extras: Sequence[LaneBlocks], ks: Dict[str, int],
) -> LaneBlocks:
    """Merge per-lane rectangular blocks (ids (B,k), scores (B,k) sorted
    desc, counts (B,)) from the hot tier and cold blocks into one top-k
    per lane. Entries beyond each row's count are forced to -inf so only
    valid rows compete; ties keep source order (hot first) via stable
    sort — deterministic for deterministic inputs."""
    if not extras:
        return base
    merged: LaneBlocks = {}
    for lane, (ids0, scores0, counts0) in base.items():
        parts = [(ids0, scores0, counts0)] + [
            e[lane] for e in extras if lane in e
        ]
        ids_cat = np.concatenate([p[0] for p in parts], axis=1)
        scores_cat = np.concatenate(
            [p[1].astype(np.float32, copy=True) for p in parts], axis=1
        )
        col = 0
        for p_ids, _p_scores, p_counts in parts:
            w = p_ids.shape[1]
            if w:
                valid = np.arange(w)[None, :] < p_counts[:, None]
                scores_cat[:, col:col + w][~valid] = -np.inf
            col += w
        k = min(int(ks[lane]), ids_cat.shape[1])
        order = np.argsort(-scores_cat, axis=1, kind="stable")[:, :k]
        ids_out = np.take_along_axis(ids_cat, order, axis=1)
        scores_out = np.take_along_axis(scores_cat, order, axis=1)
        counts_out = np.isfinite(scores_out).sum(axis=1).astype(np.int32)
        merged[lane] = (ids_out, scores_out, counts_out)
    return merged


def collect_cold(
    corpus, pending: Sequence[ColdBlock], batch: int,
) -> List[LaneBlocks]:
    """Map dispatched cold blocks' positions to doc ids (the hot tier's
    rectangularizing postprocess with the block's id snapshot). The caller
    has waited for the dispatch's event."""
    return [
        corpus.postprocess_lanes(
            {lane: (v.numpy(), p.numpy()) for lane, (v, p) in blk.lanes.items()},
            batch, blk.ids, blk.rows)
        for blk in pending
    ]


__all__ = ["ColdBlock", "ColdTier", "merge_rect_lanes", "collect_cold"]
