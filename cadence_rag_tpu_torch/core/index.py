"""Device-resident retrieval index.

Counterpart of ``cadence_rag_tpu/core/index.py``, single device. Each
corpus is six capacity-padded tensors on one ``torch.device`` (embeddings
in the storage dtype, int8 lexical signatures, int32 tech-hash slots, call
index, start seconds with ``INT32_MIN`` for invalid rows, embedding
presence) plus host mirrors of the per-row scalars for id mapping and
planning.

What changes from JAX: tensors are updated in place (an insert writes its
rows into the existing buffers, a delete fills its rows' ``started`` and
``has_emb`` entries, a backfill scatters rows; growth and compaction
reallocate and copy), and the device program runs eagerly on PyTorch's
current stream. The chunks corpus may carry an IVF index (``build_ivf``,
single process): the planner's "ivf" mode serves the dense lane from it in
a dispatch of its own, beside the packed program. Not ported here: the cold
tier, growth prewarm/migration, the multi-host op-log and the gang IVF
build.

Stream order. JAX arrays are immutable, so a queued program keeps the
inputs it was given; here every writer (the batcher's engine thread, an
HTTP handler's ``delete_call``, the store syncer's thread) mutates the
tensors a queued program reads. What keeps that safe: every thread enqueues
on the device's default stream, and every reader and writer takes the
corpus lock around capturing the tensors and enqueuing its work, so a
tombstone, a scatter or a compaction lands after the programs queued before
it and before those queued after. A buffer dropped by growth or compaction
is freed to PyTorch's caching allocator, which hands it out again only to
work queued later on the same stream. No write path stages through a reused
pinned buffer: ``_put`` copies from pageable memory (the host waits for the
copy), and ``_stage`` pins a fresh buffer per call. The host mirrors are
written in place only at positions no dispatch in flight can name (rows
past its ``count``) or in fields it does not read (``h_started``,
``h_has_emb``); compaction, which renumbers rows, replaces the mirrors with
new arrays, so a dispatch made before it still maps its positions through
the arrays it captured. The planner's ``estimate_candidates`` reads three
mirrors and the count together, so it captures them under the corpus lock.

Entry points the serving engine calls: ``DeviceIndexManager.
query_both_packed_async`` (one packed H2D buffer, one device program, a
non-blocking D2H of one flat buffer) and ``collect_packed`` (wait, map
positions to doc ids).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import settings
from ..device import DeviceLike, resolve_device
from ..ops.fused import _lanes_one_corpus, dual_corpus_retrieve
from ..ops.hashing import query_vector_from_features
from ..ops.ivf import build_buckets, ivf_topk, kmeans
from ..ops.masks import filter_mask
from ..ops.pack import (
    dual_corpus_retrieve_packed,
    pack_queries,
    sparse_lex_rows,
    unflatten_lanes,
    unflatten_merged,
)
from ..utils import events

INT32_MIN = -2147483648
INT32_MAX = 2147483647

_EMB_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
# a corpus's device arrays, in the order ``device_arrays`` returns them
DEVICE_ARRAYS = ("emb", "lex", "tech", "call_idx", "started", "has_emb")


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _clamp_ks(ks: Tuple[int, int, int], cap: int) -> Tuple[int, int, int]:
    return tuple(min(k, cap) for k in ks)  # type: ignore[return-value]


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _from_host(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; read-only arrays (jax.device_get output) are
    copied, since torch.from_numpy shares memory."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array that references no corpus buffer. On CUDA it goes
    through pinned memory, so it does not wait for work already on the
    stream (an earlier batch's program)."""
    t = _from_host(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a non-blocking D2H copy into pinned memory."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


@dataclasses.dataclass
class DocRow:
    doc_id: int
    call_seq: int
    started_sec: int
    lex_sig: np.ndarray            # (lex_dim,) int8
    lex_dl: int
    lex_touched: np.ndarray        # (t,) int32 buckets, for df updates
    tech: np.ndarray               # (tech_slots,) int32
    embedding: Optional[np.ndarray]  # (dim,) f32 unit vector or None


@dataclasses.dataclass
class IvfState:
    """Probed-cluster dense index (ops/ivf.py) over the rows present at
    build time; rows inserted later live in the exact-scanned overflow tail
    until the next build (no row is ever invisible)."""

    centroids: torch.Tensor     # (C, dim) f32
    buckets: torch.Tensor       # (C, cap) int32
    overflow: torch.Tensor      # (Vcap,) int32, -1 padded
    overflow_count: int
    built_count: int
    n_clusters: int
    nprobe: int


def _padded_overflow(positions: np.ndarray) -> np.ndarray:
    """The overflow tail padded with -1 to a power of two >= 8."""
    padded = np.full(_next_pow2(max(len(positions), 8)), -1, dtype=np.int32)
    padded[: len(positions)] = positions
    return padded


@dataclasses.dataclass(frozen=True)
class QuerySignature:
    """The static shape of one packed dispatch: what ``collect_packed``
    needs to split the flat output."""

    batch: int
    emb_dim: int
    q_feats: int
    tech_q: int
    n_calls: int
    chunk_ks: Tuple[int, int, int]
    artifact_ks: Tuple[int, int, int]
    chunk_mode: str
    artifact_mode: str
    dense_enabled: bool
    fuse_rrf: bool = False


class CorpusIndex:
    """One document class (chunks or artifact_chunks) on one device."""

    def __init__(
        self,
        name: str,
        *,
        dim: int,
        lex_dim: int,
        tech_slots: int,
        capacity: int,
        device: torch.device,
        emb_dtype: str = "bfloat16",
    ):
        if emb_dtype not in _EMB_DTYPES:
            raise ValueError(
                f"index embedding dtype {emb_dtype!r}: the port stores "
                f"{sorted(_EMB_DTYPES)}"
            )
        self.name = name
        self.device = device
        self.dim = dim
        self.lex_dim = lex_dim
        self.tech_slots = tech_slots
        self.capacity = max(8, capacity)
        self.emb_dtype = _EMB_DTYPES[emb_dtype]
        self.count = 0
        # single writer; the lock makes buffer swaps (growth, restore)
        # atomic for concurrent readers
        self.lock = threading.RLock()
        self._alloc_device(self.capacity)
        # host mirrors (per-row scalars) for id mapping + planning
        self.h_ids = np.zeros(self.capacity, dtype=np.int64)
        self.h_call = np.zeros(self.capacity, dtype=np.int32)
        self.h_started = np.full(self.capacity, INT32_MIN, dtype=np.int32)
        self.h_has_emb = np.zeros(self.capacity, dtype=bool)
        # lexical corpus stats (df at bucket granularity, running doc length)
        self.doc_freq = np.zeros(lex_dim, dtype=np.int64)
        self.dl_sum = 0
        self._id_to_pos: Dict[int, int] = {}
        self.emb_rows = 0
        self.tombstones = 0
        # ids explicitly deleted here: never re-inserted (a stale sync or
        # rebuild read that raced the store delete); the syncer prunes an id
        # once the delete's log entry is behind its watermark
        self.deleted_ids: set = set()
        # optional probed-cluster dense index (settings.dense_ivf_enabled)
        self.ivf: Optional[IvfState] = None
        self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
        self._ivf_rebuilding = False
        # bumped whenever row positions are renumbered (load_state,
        # compaction): an IVF
        # build that started before must not install its stale buckets
        self._pos_gen = 0

    def _alloc_array(self, attr: str, cap: int) -> torch.Tensor:
        """One empty device array of ``cap`` rows: zeros, and ``started``
        all ``INT32_MIN`` (no row valid)."""
        shape, dtype = {
            "emb": ((cap, self.dim), self.emb_dtype),
            "lex": ((cap, self.lex_dim), torch.int8),
            "tech": ((cap, self.tech_slots), torch.int32),
            "call_idx": ((cap,), torch.int32),
            "started": ((cap,), torch.int32),
            "has_emb": ((cap,), torch.bool),
        }[attr]
        if attr == "started":
            return torch.full(shape, INT32_MIN, dtype=dtype, device=self.device)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _alloc_arrays(self, cap: int) -> Tuple[torch.Tensor, ...]:
        return tuple(self._alloc_array(attr, cap) for attr in DEVICE_ARRAYS)

    def _alloc_device(self, cap: int) -> None:
        (self.emb, self.lex, self.tech, self.call_idx, self.started,
         self.has_emb) = self._alloc_arrays(cap)

    def device_arrays(self) -> Tuple[torch.Tensor, ...]:
        return (self.emb, self.lex, self.tech, self.call_idx, self.started,
                self.has_emb)

    @property
    def avgdl(self) -> float:
        return (self.dl_sum / self.count) if self.count else 0.0

    @property
    def live_count(self) -> int:
        return self.count - self.tombstones

    def _encode_emb(self, rows: np.ndarray) -> torch.Tensor:
        """Host rows -> storage-dtype tensor on the device. int8 storage
        quantizes unit vectors as round(x*127) (the dense lane restores the
        scale); bf16 rows from a JAX checkpoint (ml_dtypes bfloat16) are
        reinterpreted through int16, never cast; f32 rows round to bf16."""
        rows = np.asarray(rows)
        if self.emb_dtype == torch.int8:
            if rows.dtype != np.int8:
                rows = np.clip(
                    np.rint(rows.astype(np.float32) * 127.0), -127, 127
                ).astype(np.int8)
            t = _from_host(rows)
        elif rows.dtype.name == "bfloat16" and rows.dtype.itemsize == 2:
            t = _from_host(rows.view(np.int16)).view(torch.bfloat16)
        else:
            t = _from_host(rows.astype(np.float32, copy=False)).to(torch.bfloat16)
        return t.to(self.device)

    def _put(self, arr, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=dtype)
        return _from_host(arr).to(device=self.device, dtype=dtype)

    # -- growth ---------------------------------------------------------
    def _grow_to(self, cap: int) -> None:
        with events.timed("index.grow", corpus=self.name,
                          old_cap=int(self.capacity), cap=int(cap)):
            old = self.device_arrays()
            self.capacity = cap
            self._alloc_device(cap)
            for new, prev in zip(self.device_arrays(), old):
                new[: prev.shape[0]].copy_(prev)
            for attr in ("h_ids", "h_call", "h_started", "h_has_emb"):
                mirror = getattr(self, attr)
                grown = np.zeros(cap, dtype=mirror.dtype)
                if attr == "h_started":
                    grown[:] = INT32_MIN
                grown[: mirror.shape[0]] = mirror
                setattr(self, attr, grown)

    def ensure_capacity(self, extra: int) -> None:
        need = self.count + extra
        if need <= self.capacity:
            return
        cap = self.capacity
        while cap < need:
            cap *= 2
        self._grow_to(cap)

    # -- ingest -----------------------------------------------------------
    def insert(self, rows: Sequence[DocRow]) -> None:
        if not rows:
            return
        with self.lock:
            with events.timed("index.insert", corpus=self.name,
                              rows=len(rows)):
                self._insert_locked(rows)
        self._maybe_schedule_ivf_rebuild()

    def _insert_locked(self, rows: Sequence[DocRow]) -> None:
        # a row already present (same doc_id) is a no-op: a syncer and a
        # local ingest may race to insert the same committed row
        rows = [r for r in rows if int(r.doc_id) not in self._id_to_pos]
        if self.deleted_ids:
            # a row tombstoned here can only reappear through a stale sync
            # or rebuild read that raced the store delete: refuse it
            rows = [r for r in rows if int(r.doc_id) not in self.deleted_ids]
        if not rows:
            return
        n = len(rows)
        # reserve the pow2-padded slab as the JAX index does, so both
        # packages reach the same capacities from the same inserts
        self.ensure_capacity(_next_pow2(n))
        start = self.count
        emb = np.zeros((n, self.dim), dtype=np.float32)
        has = np.zeros(n, dtype=bool)
        for i, r in enumerate(rows):
            if r.embedding is not None:
                emb[i] = r.embedding
                has[i] = True
        sl = slice(start, start + n)
        self.emb[sl] = self._encode_emb(emb)
        self.lex[sl] = self._put(np.stack([r.lex_sig for r in rows]), torch.int8)
        self.tech[sl] = self._put(np.stack([r.tech for r in rows]), torch.int32)
        self.call_idx[sl] = self._put(
            np.array([r.call_seq for r in rows]), torch.int32)
        self.started[sl] = self._put(
            np.array([r.started_sec for r in rows]), torch.int32)
        self.has_emb[sl] = self._put(has, torch.bool)
        for i, r in enumerate(rows):
            pos = start + i
            self.h_ids[pos] = r.doc_id
            self.h_call[pos] = r.call_seq
            self.h_started[pos] = r.started_sec
            self.h_has_emb[pos] = has[i]
            self._id_to_pos[int(r.doc_id)] = pos
            self.doc_freq[r.lex_touched] += 1
            self.dl_sum += r.lex_dl
        self.emb_rows += int(has.sum())
        self.count += n
        if self.ivf is not None:
            self._ivf_append_overflow(np.arange(start, start + n, dtype=np.int32))

    def position_of(self, doc_ids: Sequence[int]) -> np.ndarray:
        """Row position per doc id, -1 for an id this corpus lacks."""
        lookup = self._id_to_pos
        return np.array([lookup.get(int(d), -1) for d in doc_ids], dtype=np.int32)

    def set_embeddings(self, doc_ids: Sequence[int], vectors: np.ndarray) -> int:
        """Backfill embeddings of existing rows (reference analogue: UPDATE
        ... SET embedding, app/embedding_pipeline.py:149-168): one scatter
        of the rows and one of their ``has_emb`` flags. Ids this corpus
        lacks are skipped. -> rows written."""
        with self.lock:
            pos = self.position_of(doc_ids)
            keep = pos >= 0
            if not keep.any():
                return 0
            pos = pos[keep]
            rows = np.asarray(vectors, dtype=np.float32)[keep]
            idx = self._put(pos, torch.int64)
            self.emb.index_copy_(0, idx, self._encode_emb(rows))
            self.has_emb[idx] = True
            self.emb_rows += int((~self.h_has_emb[pos]).sum())
            self.h_has_emb[pos] = True
            return int(pos.shape[0])

    def contains(self, doc_ids: Sequence[int]) -> np.ndarray:
        """Presence of each id among the live rows (the syncer and
        ``reconcile`` ask this)."""
        with self.lock:
            lookup = self._id_to_pos
            return np.array([int(d) in lookup for d in doc_ids], dtype=bool)

    def _live_positions(self, doc_ids: Sequence[int], rows: np.ndarray,
                        positions: Optional[np.ndarray] = None):
        """(device index tensor, rows) of the ids this corpus holds live."""
        pos = positions if positions is not None else self.position_of(doc_ids)
        keep = pos >= 0
        return self._put(pos[keep], torch.int64), rows[keep]

    def set_tech(self, doc_ids: Sequence[int], tech_rows: np.ndarray) -> int:
        """Replace the tech-token slots of existing rows (tech-token
        backfill after lexicon changes): one scatter. -> rows written."""
        with self.lock:
            idx, vals = self._live_positions(
                doc_ids, np.asarray(tech_rows, dtype=np.int32))
            if idx.numel():
                self.tech.index_copy_(0, idx, self._put(vals, torch.int32))
            return int(idx.numel())

    def set_lex(
        self, doc_ids: Sequence[int], lex_rows: np.ndarray,
        positions: Optional[np.ndarray] = None,
    ) -> int:
        """Replace the lexical signatures of existing rows (a re-featurize
        under another layout): a pure row scatter; the caller rebuilds the
        df table with ``replace_doc_freq`` once every row is rewritten.
        ``positions`` skips the id lookup (-1 = not live)."""
        with self.lock:
            idx, vals = self._live_positions(
                doc_ids, np.asarray(lex_rows, dtype=np.int8), positions)
            if idx.numel():
                self.lex.index_copy_(0, idx, self._put(vals, torch.int8))
            return int(idx.numel())

    def set_lex_ids(
        self, doc_ids: Sequence[int], lex_rows: np.ndarray
    ) -> np.ndarray:
        """``set_lex`` by doc id -> the per-id live mask (a re-featurize
        rebuilds df over every live row from it)."""
        with self.lock, events.timed("index.set_lex_ids", corpus=self.name,
                                     rows=len(doc_ids)):
            pos = self.position_of(doc_ids)
            self.set_lex(doc_ids, lex_rows, positions=pos)
            return pos >= 0

    def replace_doc_freq(self, doc_freq: np.ndarray) -> None:
        """Swap the bucket-granularity df table after a full lexical
        re-featurize (doc lengths do not depend on the layout, so
        ``dl_sum`` stands)."""
        with self.lock:
            self.doc_freq = np.asarray(doc_freq, dtype=np.int64).copy()

    # -- delete / compaction ------------------------------------------------
    def delete_ids(
        self,
        doc_ids: Sequence[int],
        lex_sigs: Optional[Sequence[Optional[np.ndarray]]] = None,
        lex_dls: Optional[Sequence[int]] = None,
    ) -> int:
        """Tombstone rows: two in-place fills make them invisible to every
        lane from the next dispatch on (``ops/masks.filter_mask`` treats
        ``started == INT32_MIN`` as invalid, so kernels K1 and K3 never see
        them; ``has_emb`` False removes them from the dense lane); the rows'
        space is reclaimed by ``compact``. ``lex_sigs`` / ``lex_dls`` (from
        the store) let the lexical corpus stats shed the deleted documents'
        df and length mass. Unknown ids and repeats are skipped, but every
        id given joins ``deleted_ids``. -> rows tombstoned."""
        with self.lock:
            # blacklist first: an id deleted here must never re-enter, even
            # when this index does not hold it (a store-only writer's row)
            self.deleted_ids.update(int(d) for d in doc_ids)
            pos_all = self.position_of(doc_ids)
            # unknown ids and repeats of one id count once
            _uniq, first = np.unique(pos_all, return_index=True)
            keep = np.zeros(pos_all.shape[0], dtype=bool)
            keep[first] = True
            keep &= pos_all >= 0
            if not keep.any():
                return 0
            pos = pos_all[keep]
            idx = self._put(pos, torch.int64)
            self.started.index_fill_(0, idx, INT32_MIN)
            self.has_emb.index_fill_(0, idx, False)
            self.emb_rows -= int(self.h_has_emb[pos].sum())
            self.h_started[pos] = INT32_MIN
            self.h_has_emb[pos] = False
            for i in np.flatnonzero(keep):
                self._id_to_pos.pop(int(doc_ids[i]), None)
                sig = lex_sigs[i] if lex_sigs is not None else None
                if sig is not None:
                    touched = np.flatnonzero(sig)
                    self.doc_freq[touched] = np.maximum(
                        self.doc_freq[touched] - 1, 0)
                if lex_dls is not None:
                    self.dl_sum -= int(lex_dls[i])
            self.dl_sum = max(self.dl_sum, 0)
            self.tombstones += int(pos.shape[0])
            return int(pos.shape[0])

    def maybe_compact(self, threshold_frac: float = 0.25) -> bool:
        """Compact once tombstones reach a quarter of the rows (and at
        least 64): bounded wasted device memory and scan work for a
        one-time gather of the live rows."""
        with self.lock:
            if self.tombstones < max(int(self.count * threshold_frac), 64):
                return False
            self.compact()
            return True

    def compact(self) -> None:
        """Gather the live rows to the front of arrays of the new capacity
        (the JAX rule: the next power of two at or above the live rows,
        never under ``index_initial_capacity``). Every dispatch waits on
        the corpus lock meanwhile. Each array is gathered straight into the
        front of its new allocation and the old one released before the
        next is allocated, so the peak is the old arrays plus the largest
        new one, never a third gathered copy. Row positions change: the host
        mirrors are replaced (never written: a dispatch in flight maps its
        positions through the arrays it captured), the IVF index is dropped
        and ``_pos_gen`` moves."""
        with self.lock, events.timed("index.compact", corpus=self.name):
            n = self.count
            live = np.flatnonzero(self.h_started[:n] != INT32_MIN)
            out_rows = int(live.shape[0])
            cap = max(_next_pow2(max(out_rows, 8)),
                      int(settings.index_initial_capacity))
            take = self._put(live, torch.int64)
            for attr in DEVICE_ARRAYS:
                dst = self._alloc_array(attr, cap)
                torch.index_select(getattr(self, attr), 0, take,
                                   out=dst[:out_rows])
                setattr(self, attr, dst)
            self.capacity = cap
            for attr in ("h_ids", "h_call", "h_started", "h_has_emb"):
                old = getattr(self, attr)
                mirror = np.zeros(cap, dtype=old.dtype)
                if attr == "h_started":
                    mirror[:] = INT32_MIN
                mirror[:out_rows] = old[live]
                setattr(self, attr, mirror)
            self._id_to_pos = {
                int(d): p for p, d in enumerate(self.h_ids[:out_rows])}
            self.emb_rows = int(self.h_has_emb[:out_rows].sum())
            self.count = out_rows
            self.tombstones = 0
            self.ivf = None
            self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
            self._pos_gen += 1

    # -- planning ---------------------------------------------------------
    def estimate_candidates(
        self,
        allowed_calls: Optional[np.ndarray],
        date_min: int,
        date_max: int,
        require_embedding: bool = True,
        unfiltered: bool = False,
    ) -> int:
        """Masked row count for the exact-vs-ann planner, from the host
        mirrors (the unfiltered case is a cached counter). The count and
        the mirrors are taken together under the corpus lock (a compaction
        replaces them one by one and may shrink them) and read outside it."""
        with self.lock:
            n = self.count
            if n == 0:
                return 0
            if unfiltered:
                return self.emb_rows if require_embedding else self.live_count
            started = self.h_started[:n]
            call = self.h_call[:n]
            has_emb = self.h_has_emb[:n]
        mask = (started >= date_min) & (started <= date_max)
        if allowed_calls is not None:
            mask &= allowed_calls[call]
        if require_embedding:
            mask &= has_emb
        return int(mask.sum())

    # -- state carried across packages (checkpoint payload) ----------------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The JAX package's ``state_arrays`` dict. bf16 embeddings widen to
        f32 (exact; numpy has no bf16) and round back exactly on load."""
        with self.lock:
            c = self.count
            emb = self.emb[:c]
            return {
                "emb": _to_host(emb if emb.dtype == torch.int8 else emb.float()),
                "lex": _to_host(self.lex[:c]),
                "tech": _to_host(self.tech[:c]),
                "ids": self.h_ids[:c].copy(),
                "call": self.h_call[:c].copy(),
                "started": self.h_started[:c].copy(),
                "has_emb": self.h_has_emb[:c].copy(),
                "doc_freq": self.doc_freq.copy(),
                "dl_sum": np.array([self.dl_sum], dtype=np.int64),
            }

    def load_state(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install a ``state_arrays`` dict — from this package or from the
        JAX package's ``CorpusIndex.state_arrays()``."""
        with self.lock:
            n = int(arrays["ids"].shape[0])
            self.count = 0
            cap = max(self.capacity, _next_pow2(max(n, 8)))
            self.capacity = cap
            self._alloc_device(cap)
            self.h_ids = np.zeros(cap, dtype=np.int64)
            self.h_call = np.zeros(cap, dtype=np.int32)
            self.h_started = np.full(cap, INT32_MIN, dtype=np.int32)
            self.h_has_emb = np.zeros(cap, dtype=bool)
            if n:
                self.emb[:n] = self._encode_emb(arrays["emb"])
                self.lex[:n] = self._put(arrays["lex"].astype(np.int8), torch.int8)
                self.tech[:n] = self._put(arrays["tech"].astype(np.int32), torch.int32)
                self.call_idx[:n] = self._put(arrays["call"].astype(np.int32), torch.int32)
                self.started[:n] = self._put(arrays["started"].astype(np.int32), torch.int32)
                self.has_emb[:n] = self._put(arrays["has_emb"].astype(bool), torch.bool)
                self.h_ids[:n] = arrays["ids"]
                self.h_call[:n] = arrays["call"]
                self.h_started[:n] = arrays["started"]
                self.h_has_emb[:n] = arrays["has_emb"]
            self.doc_freq = arrays["doc_freq"].astype(np.int64)
            self.dl_sum = int(arrays["dl_sum"][0])
            started = arrays["started"].astype(np.int32)
            # tombstoned rows restore as tombstones: their ids do not resolve
            self._id_to_pos = {
                int(d): p for p, d in enumerate(arrays["ids"])
                if started[p] != INT32_MIN
            }
            self.emb_rows = int(arrays["has_emb"].astype(bool).sum())
            self.tombstones = int((started == INT32_MIN).sum())
            self.count = n
            # row positions changed: derived IVF state is invalid
            self.ivf = None
            self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
            self._pos_gen += 1

    # -- IVF dense index ----------------------------------------------------
    def _ivf_append_overflow(self, positions: np.ndarray) -> None:
        self._ivf_overflow_host = np.concatenate(
            [self._ivf_overflow_host, positions.astype(np.int32)])
        self.ivf = dataclasses.replace(
            self.ivf,
            overflow=self._put(_padded_overflow(self._ivf_overflow_host),
                               torch.int32),
            overflow_count=len(self._ivf_overflow_host),
        )

    def _ivf_plan(
        self, n: int, n_clusters: Optional[int], nprobe: Optional[int]
    ) -> Tuple[int, int]:
        """(clusters, nprobe) from the corpus size and settings, as the JAX
        index plans them: sqrt(N) clusters, 8% of them probed, capped so the
        probed rows stay near 5% of the corpus."""
        clusters = n_clusters or int(settings.ivf_clusters) or max(
            16, int(np.sqrt(n)))
        clusters = min(clusters, n)
        probe = nprobe or int(settings.ivf_nprobe) or max(
            4, int(clusters * 0.08))
        bucket_cap_est = max(8, int(2.0 * n / clusters))
        max_probe = max(4, int(0.05 * n / bucket_cap_est))
        return clusters, min(probe, max_probe, clusters)

    def build_ivf(
        self,
        n_clusters: Optional[int] = None,
        nprobe: Optional[int] = None,
        seed: int = 0,
    ) -> IvfState:
        """Build (or rebuild) the probed-cluster dense index on the device.

        Serving is not blocked for the k-means: the embeddings are copied
        under the lock, the clustering runs outside it, and the finished
        state installs atomically; rows inserted meanwhile join the
        exact-scanned overflow tail. A renumbering of rows while k-means
        ran (``_pos_gen`` moved) aborts the build."""
        with self.lock:
            if self.count == 0:
                raise RuntimeError(f"{self.name}: empty corpus, nothing to build")
            n = self.count
            pos_gen = self._pos_gen
            snapshot = self.emb[:n].clone()
        if self.emb_dtype == torch.int8:
            # k-means runs in float space (float centroids cast back to int8
            # degenerate); the probed scan widens int8 rows and rescales
            snapshot = snapshot.float() / 127.0
        clusters, probe = self._ivf_plan(n, n_clusters, nprobe)
        gen = torch.Generator(device=snapshot.device)
        gen.manual_seed(int(seed))
        centroids, assign = kmeans(snapshot, n_clusters=clusters, iters=10,
                                   generator=gen)
        del snapshot
        bucket_cap = max(8, int(2.0 * n / clusters))
        buckets_np, overflow_np = build_buckets(
            assign.cpu().numpy(), clusters, bucket_cap)
        with self.lock:
            if self._pos_gen != pos_gen:
                raise RuntimeError(
                    f"{self.name}: concurrent compaction/restore "
                    "invalidated the IVF build (row positions changed); "
                    "re-run the build")
            # rows inserted during the build join the overflow tail
            self._ivf_overflow_host = np.concatenate(
                [overflow_np, np.arange(n, self.count, dtype=np.int32)])
            self.ivf = IvfState(
                centroids=centroids,
                buckets=self._put(buckets_np, torch.int32),
                overflow=self._put(_padded_overflow(self._ivf_overflow_host),
                                   torch.int32),
                overflow_count=len(self._ivf_overflow_host),
                built_count=n,
                n_clusters=clusters,
                nprobe=probe,
            )
            return self.ivf

    def load_ivf_state(self, state) -> None:
        """Install an IVF state carried from elsewhere — the JAX index's
        ``IvfState`` (any object with its fields) — over the current rows,
        as ``load_state`` carries the rows, so both packages can serve the
        same IVF."""
        with self.lock:
            count = int(state.overflow_count)
            overflow = np.asarray(state.overflow).astype(np.int32)
            self._ivf_overflow_host = overflow[:count].copy()
            self.ivf = IvfState(
                centroids=self._put(np.asarray(state.centroids, np.float32),
                                    torch.float32),
                buckets=self._put(np.asarray(state.buckets), torch.int32),
                overflow=self._put(overflow, torch.int32),
                overflow_count=count,
                built_count=int(state.built_count),
                n_clusters=int(state.n_clusters),
                nprobe=int(state.nprobe),
            )

    def _maybe_schedule_ivf_rebuild(self) -> None:
        """Rebuild in a background thread once the overflow tail passes half
        the built index (before ``ivf_usable`` turns false). The check and
        the flag are set under the lock, so concurrent inserters start one
        rebuild."""
        with self.lock:
            state = self.ivf
            if (
                state is None
                or self._ivf_rebuilding
                or not settings.dense_ivf_enabled
                or state.overflow_count < max(state.built_count // 2, 8)
            ):
                return
            self._ivf_rebuilding = True

        def rebuild():
            try:
                self.build_ivf(seed=int(self.count))
            except Exception:  # logged, never fatal to the inserting thread
                logging.getLogger(__name__).exception(
                    "ivf.rebuild_failed corpus=%s", self.name)
            finally:
                self._ivf_rebuilding = False

        threading.Thread(target=rebuild, daemon=True).start()

    def ivf_usable(self) -> bool:
        """IVF serves the dense lane only while the exact-scanned tail is
        smaller than the built index."""
        return (self.ivf is not None
                and self.ivf.overflow_count < max(self.ivf.built_count, 1))

    def ivf_dense_query(
        self, q_emb, allowed_calls, date_min, date_max, k: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense lane from the IVF index -> (scores (B, k) f32,
        positions (B, k) int64, -1 where no hit); inputs are host arrays
        or tensors already on the device."""
        with self.lock:
            state = self.ivf
            mask = filter_mask(
                self.call_idx, self.started, self._put(allowed_calls, torch.bool),
                self._put(date_min, torch.int32), self._put(date_max, torch.int32))
            return ivf_topk(
                self._put(q_emb, torch.float32), self.emb, state.centroids,
                state.buckets, state.overflow, mask & self.has_emb[None, :],
                k=min(k, self.capacity), nprobe=state.nprobe)

    # -- query -------------------------------------------------------------
    def query(
        self,
        q_emb: Optional[np.ndarray],      # (B, dim) f32 or None
        q_lex: np.ndarray,                # (B, lex_dim) f32
        q_tech: np.ndarray,               # (B, Q) int32
        allowed_calls: np.ndarray,        # (B, C) bool
        date_min: np.ndarray,             # (B,) int32
        date_max: np.ndarray,             # (B,) int32
        *,
        k_dense: int,
        k_lex: int,
        k_tech: int,
        dense_mode: str = "exact",
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """This corpus's lanes alone -> rectangular (ids, scores, counts)
        per lane; an empty corpus gives empty lanes."""
        if self.count == 0:
            return self.empty_lanes(q_lex.shape[0], q_emb is not None)
        with self.lock:
            batch = q_lex.shape[0]
            dense_enabled = q_emb is not None
            if not dense_enabled:
                q_emb = np.zeros((batch, self.dim), np.float32)
            out = _lanes_one_corpus(
                *self.device_arrays(),
                self._put(q_emb, torch.float32),
                self._put(q_lex, torch.float32),
                self._put(q_tech, torch.int32),
                self._put(allowed_calls, torch.bool),
                self._put(date_min, torch.int32),
                self._put(date_max, torch.int32),
                k_dense=min(k_dense, self.capacity),
                k_lex=min(k_lex, self.capacity),
                k_tech=min(k_tech, self.capacity),
                dense_mode=dense_mode, dense_enabled=dense_enabled,
            )
            host = {lane: (_to_host(v), _to_host(p)) for lane, (v, p) in out.items()}
            return self.postprocess_lanes(host, batch)

    def postprocess_lanes(
        self, out: Dict[str, Tuple[np.ndarray, np.ndarray]], batch: int,
        h_ids: Optional[np.ndarray] = None, count: Optional[int] = None,
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Positions -> doc ids, rectangular: per lane (ids (B,k) i64,
        scores (B,k) f32, counts (B,) i32), each row's first counts[b]
        entries valid. Callers outside the lock pass the (h_ids, count)
        snapshot taken at dispatch."""
        if h_ids is None:
            h_ids = self.h_ids
        if count is None:
            count = self.count
        result: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for lane, (scores, pos) in out.items():
            scores = np.asarray(scores)
            pos = np.asarray(pos)
            keep = np.isfinite(scores) & (pos >= 0) & (pos < count)
            ids_all = h_ids[np.where(keep, pos, 0)]
            scores_f32 = scores.astype(np.float32, copy=False)
            counts = keep.sum(axis=1, dtype=np.int32)
            if keep.shape[1] and not bool((keep[:, :-1] >= keep[:, 1:]).all()):
                # scores arrive sorted desc with -inf last, so `keep` is a
                # prefix; compact per row if that ever fails to hold
                ids_fix = np.full_like(ids_all, -1)
                scores_fix = np.full_like(scores_f32, -np.inf)
                for b in range(batch):
                    m = int(counts[b])
                    ids_fix[b, :m] = ids_all[b][keep[b]]
                    scores_fix[b, :m] = scores_f32[b][keep[b]]
                ids_all, scores_f32 = ids_fix, scores_fix
            result[lane] = (ids_all.astype(np.int64, copy=False),
                            scores_f32, counts)
        return result

    def postprocess_merged(
        self,
        merged: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        h_ids: Optional[np.ndarray] = None,
        count: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Device-fused RRF block -> (doc_ids i64 (B,K), scores f64 (B,K),
        masks u8 (B,K), counts i32 (B,)); out-of-range positions (a
        snapshot race) are dropped and the row recompacted."""
        if h_ids is None:
            h_ids = self.h_ids
        if count is None:
            count = self.count
        fused, pos, masks, counts = merged
        counts = counts.astype(np.int32, copy=False)
        K = pos.shape[1]
        in_prefix = np.arange(K)[None, :] < counts[:, None]
        keep = in_prefix & (pos >= 0) & (pos < count)
        if not bool((keep == in_prefix).all()):
            counts = keep.sum(axis=1, dtype=np.int32)
            ids_fix = np.zeros(pos.shape, dtype=np.int64)
            scores_fix = np.zeros(pos.shape, dtype=np.float64)
            masks_fix = np.zeros(pos.shape, dtype=np.uint8)
            ids_all = h_ids[np.where(keep, pos, 0)]
            for b in range(pos.shape[0]):
                m = int(counts[b])
                ids_fix[b, :m] = ids_all[b][keep[b]]
                scores_fix[b, :m] = fused[b][keep[b]].astype(np.float64)
                masks_fix[b, :m] = masks[b][keep[b]].astype(np.uint8)
            return ids_fix, scores_fix, masks_fix, counts
        ids = h_ids[np.where(keep, pos, 0)].astype(np.int64, copy=False)
        return ids, fused.astype(np.float64), masks.astype(np.uint8, copy=False), counts

    def empty_lanes(self, batch: int, dense_enabled: bool):
        empty = (np.zeros((batch, 0), dtype=np.int64),
                 np.zeros((batch, 0), dtype=np.float32),
                 np.zeros(batch, dtype=np.int32))
        lanes = {"lex": empty, "tech": empty}
        if dense_enabled:
            lanes["dense"] = empty
        return lanes


@dataclasses.dataclass
class PackedDispatch:
    """An in-flight dispatch: the flat output's host copy (pinned and
    filled by a non-blocking D2H on CUDA), the event that marks it done,
    and the host-mirror snapshot postprocess needs. ``extra_dense`` is the
    host copy of an out-of-program dense lane (the IVF dispatch), and
    ``served_chunk_mode`` the dense mode that actually served the chunks
    ("ivf" falls back to "ann" when the index was dropped between planning
    and dispatch). ``ready`` carries immediate results for the cold-start
    path (one corpus still empty)."""

    flat_host: Optional[torch.Tensor] = None
    done: Optional[object] = None       # torch.cuda.Event or None
    sig: Optional[QuerySignature] = None
    served_chunk_mode: Optional[str] = None
    extra_dense: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    chunk_snap: Tuple[Optional[np.ndarray], int] = (None, 0)
    artifact_snap: Tuple[Optional[np.ndarray], int] = (None, 0)
    batch: int = 0
    ready: Optional[Tuple[Dict, Dict]] = None


class DeviceIndexManager:
    """Both corpora on one device, plus the call-registry capacity that
    sizes the filter bitmaps."""

    def __init__(self, device: DeviceLike) -> None:
        self.device = resolve_device(device)
        cap = int(settings.index_initial_capacity)
        kwargs = dict(
            dim=int(settings.embeddings_dim),
            lex_dim=int(settings.lexical_dim),
            tech_slots=int(settings.tech_hash_slots),
            capacity=cap,
            device=self.device,
            emb_dtype=settings.index_embedding_dtype,
        )
        self.chunks = CorpusIndex("chunks", **kwargs)
        self.artifacts = CorpusIndex("artifact_chunks", **kwargs)
        self.call_capacity = 256

    def ensure_call_capacity(self, n_calls: int) -> None:
        while self.call_capacity < n_calls:
            self.call_capacity *= 2

    def corpus(self, name: str) -> CorpusIndex:
        if name == "chunks":
            return self.chunks
        if name == "artifact_chunks":
            return self.artifacts
        raise KeyError(name)

    def query_both(
        self,
        q_emb: Optional[np.ndarray],
        chunk_q_lex: np.ndarray,
        artifact_q_lex: np.ndarray,
        q_tech: np.ndarray,
        allowed_calls: np.ndarray,
        date_min: np.ndarray,
        date_max: np.ndarray,
        *,
        chunk_ks: Tuple[int, int, int],
        artifact_ks: Tuple[int, int, int],
        chunk_mode: str,
        artifact_mode: str,
        recall_target: float,
    ) -> Tuple[Dict, Dict]:
        """Six lanes over both corpora from dense query vectors; per-corpus
        calls while either corpus is still empty (cold start), which serve a
        planner "ivf" choice as ann."""
        batch = chunk_q_lex.shape[0]
        dense_enabled = q_emb is not None
        with self.chunks.lock, self.artifacts.lock:
            if self.chunks.count == 0 or self.artifacts.count == 0:
                if chunk_mode == "ivf":
                    chunk_mode = "ann"
                return tuple(  # type: ignore[return-value]
                    corpus.query(
                        q_emb, q_lex, q_tech, allowed_calls, date_min,
                        date_max, k_dense=ks[0], k_lex=ks[1], k_tech=ks[2],
                        dense_mode=mode,
                    )
                    for corpus, q_lex, ks, mode in (
                        (self.chunks, chunk_q_lex, chunk_ks, chunk_mode),
                        (self.artifacts, artifact_q_lex, artifact_ks,
                         artifact_mode),
                    )
                )
            chunk_mode, ivf_dense = self._resolve_chunk_dense(
                chunk_mode, dense_enabled, q_emb, allowed_calls, date_min,
                date_max, chunk_ks[0])
            put = self.chunks._put
            chunks_raw, artifacts_raw = dual_corpus_retrieve(
                self.chunks.device_arrays(),
                self.artifacts.device_arrays(),
                put(q_emb if dense_enabled
                    else np.zeros((batch, self.chunks.dim), np.float32),
                    torch.float32),
                put(chunk_q_lex, torch.float32),
                put(artifact_q_lex, torch.float32),
                put(q_tech, torch.int32),
                put(allowed_calls, torch.bool),
                put(date_min, torch.int32),
                put(date_max, torch.int32),
                chunk_ks=_clamp_ks(chunk_ks, self.chunks.capacity),
                artifact_ks=_clamp_ks(artifact_ks, self.artifacts.capacity),
                chunk_mode=chunk_mode, artifact_mode=artifact_mode,
                dense_enabled=dense_enabled,
            )
            if ivf_dense is not None:
                chunks_raw = dict(chunks_raw)
                chunks_raw["dense"] = ivf_dense

            def host(out):
                return {lane: (_to_host(v), _to_host(p))
                        for lane, (v, p) in out.items()}

            return (self.chunks.postprocess_lanes(host(chunks_raw), batch),
                    self.artifacts.postprocess_lanes(host(artifacts_raw), batch))

    def query_both_packed_async(
        self,
        q_emb: Optional[np.ndarray],          # (B, dim) f32 or None
        q_lex_feats: Sequence,                # per-plan (buckets, signs, tfs)
        q_tech: np.ndarray,
        allowed_calls: np.ndarray,
        date_min: np.ndarray,
        date_max: np.ndarray,
        *,
        chunk_ks: Tuple[int, int, int],
        artifact_ks: Tuple[int, int, int],
        chunk_mode: str,
        artifact_mode: str,
        recall_target: float,
        fuse_rrf: bool = False,
    ) -> PackedDispatch:
        """ONE packed H2D buffer and one device program for all six lanes,
        returning without waiting for the device: the flat output's D2H
        copy is enqueued into pinned memory behind the program, and
        ``collect_packed`` waits for it. A chunks ``"ivf"`` plan runs the
        dense lane from the IVF index in a second dispatch and turns
        ``fuse_rrf`` off. ``recall_target`` is accepted as the JAX index's
        callers pass it; the port's ann lane is K1's fixed candidate
        partition, which no target changes."""
        batch = q_tech.shape[0]
        dense_enabled = q_emb is not None
        F = int(settings.query_lex_features)
        if self.chunks.count == 0 or self.artifacts.count == 0:
            # cold start: the per-corpus path (rare; not packed)
            dense_q = [
                np.stack([_dense_query_vector(f, corpus) for f in q_lex_feats])
                for corpus in (self.chunks, self.artifacts)
            ]
            ready = self.query_both(
                q_emb, dense_q[0], dense_q[1], q_tech, allowed_calls,
                date_min, date_max, chunk_ks=chunk_ks,
                artifact_ks=artifact_ks, chunk_mode=chunk_mode,
                artifact_mode=artifact_mode, recall_target=recall_target,
            )
            return PackedDispatch(
                ready=ready,
                served_chunk_mode="ann" if chunk_mode == "ivf" else chunk_mode)

        # idf from LIVE counts, as the JAX index does
        chunk_sparse = sparse_lex_rows(
            q_lex_feats, self.chunks.doc_freq, self.chunks.live_count, F)
        artifact_sparse = sparse_lex_rows(
            q_lex_feats, self.artifacts.doc_freq, self.artifacts.live_count, F)
        packed = pack_queries(q_emb, chunk_sparse, artifact_sparse, q_tech,
                              allowed_calls, date_min, date_max)
        # uploads that reference no corpus buffer are staged outside the
        # locks: the packed batch, and the IVF dispatch's inputs
        d_packed = _stage(packed, self.device)
        ivf_inputs = (q_emb, allowed_calls, date_min, date_max)
        if dense_enabled and chunk_mode == "ivf":
            ivf_inputs = tuple(_stage(a, self.device) for a in ivf_inputs)
        with self.chunks.lock, self.artifacts.lock:
            chunk_mode, ivf_dense = self._resolve_chunk_dense(
                chunk_mode, dense_enabled, *ivf_inputs, chunk_ks[0])
            # device RRF needs every lane in the packed program: with the
            # IVF dense lane in its own dispatch ("none") the caller merges
            # the lanes on the host
            fuse_rrf = bool(fuse_rrf and chunk_mode != "none")
            sig = QuerySignature(
                batch=batch,
                emb_dim=self.chunks.dim if dense_enabled else 1,
                q_feats=F, tech_q=q_tech.shape[1],
                n_calls=allowed_calls.shape[1],
                chunk_ks=_clamp_ks(chunk_ks, self.chunks.capacity),
                artifact_ks=_clamp_ks(artifact_ks, self.artifacts.capacity),
                chunk_mode=chunk_mode, artifact_mode=artifact_mode,
                dense_enabled=dense_enabled, fuse_rrf=fuse_rrf,
            )
            flat = dual_corpus_retrieve_packed(
                self.chunks.device_arrays(), self.artifacts.device_arrays(),
                d_packed, batch=batch, emb_dim=sig.emb_dim, q_feats=F,
                tech_q=sig.tech_q, n_calls=sig.n_calls,
                chunk_ks=sig.chunk_ks, artifact_ks=sig.artifact_ks,
                chunk_mode=chunk_mode, artifact_mode=artifact_mode,
                dense_enabled=dense_enabled, fuse_rrf=sig.fuse_rrf,
            )
            # snapshot the host mirrors while the positions are current
            chunk_snap = (self.chunks.h_ids, self.chunks.count)
            artifact_snap = (self.artifacts.h_ids, self.artifacts.count)
        done = None
        if flat.is_cuda:
            flat_host = _to_pinned(flat)
            if ivf_dense is not None:
                ivf_dense = tuple(_to_pinned(t) for t in ivf_dense)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(flat.device))
        else:
            flat_host = flat
        return PackedDispatch(
            flat_host=flat_host, done=done, sig=sig,
            served_chunk_mode="ivf" if chunk_mode == "none" else chunk_mode,
            extra_dense=ivf_dense, chunk_snap=chunk_snap,
            artifact_snap=artifact_snap, batch=batch,
        )

    def _resolve_chunk_dense(
        self, chunk_mode, dense_enabled, q_emb, allowed_calls, date_min,
        date_max, k_dense,
    ):
        """The chunks corpus's dense mode, resolved under the locks: a
        dropped IVF falls back to ann; a live IVF serves the dense lane in
        its own dispatch and the packed program skips it ("none").
        -> (mode, IVF dense result or None)."""
        if not (dense_enabled and chunk_mode == "ivf"):
            return chunk_mode, None
        if self.chunks.ivf is None:
            return "ann", None
        return "none", self.chunks.ivf_dense_query(
            q_emb, allowed_calls, date_min, date_max, k_dense)

    def collect_packed(self, disp: PackedDispatch) -> Tuple[Dict, Dict]:
        """Wait for a dispatch's flat output and map positions -> doc ids.
        With ``fuse_rrf`` each corpus comes back as {"__rrf__": merged
        block}; otherwise as per-lane rectangular blocks."""
        if disp.ready is not None:
            return disp.ready
        if disp.done is not None:
            disp.done.synchronize()
        flat_np = disp.flat_host.numpy()
        sig = disp.sig
        layout = dict(
            chunk_ks=sig.chunk_ks, artifact_ks=sig.artifact_ks,
            chunk_mode=sig.chunk_mode, artifact_mode=sig.artifact_mode,
            dense_enabled=sig.dense_enabled,
        )
        if sig.fuse_rrf:
            chunks_m, artifacts_m = unflatten_merged(flat_np, **layout)
            return (
                {"__rrf__": self.chunks.postprocess_merged(
                    chunks_m, *disp.chunk_snap)},
                {"__rrf__": self.artifacts.postprocess_merged(
                    artifacts_m, *disp.artifact_snap)},
            )
        chunks_np, artifacts_np = unflatten_lanes(flat_np, **layout)
        if disp.extra_dense is not None:
            chunks_np = dict(chunks_np)
            chunks_np["dense"] = tuple(_to_host(t) for t in disp.extra_dense)
        return (
            self.chunks.postprocess_lanes(chunks_np, disp.batch, *disp.chunk_snap),
            self.artifacts.postprocess_lanes(
                artifacts_np, disp.batch, *disp.artifact_snap),
        )


def _dense_query_vector(feats, corpus: CorpusIndex) -> np.ndarray:
    buckets, signs, tfs = feats
    return query_vector_from_features(
        buckets, signs, tfs, corpus.lex_dim, corpus.doc_freq,
        corpus.live_count,
    )


_index: Optional[DeviceIndexManager] = None
_index_lock = threading.Lock()


def get_index(device: Optional[DeviceLike] = None) -> DeviceIndexManager:
    """The process-wide index. The first call names its device; later
    calls may omit it (or must name the same one)."""
    global _index
    with _index_lock:
        if _index is None:
            if device is None:
                raise ValueError("get_index: the first call must name a device")
            _index = DeviceIndexManager(device)
        elif device is not None and resolve_device(device) != _index.device:
            raise ValueError(
                f"get_index: index lives on {_index.device}, not {device}"
            )
        return _index


def reset_index() -> None:
    global _index
    with _index_lock:
        _index = None
