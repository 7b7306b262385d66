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
a dispatch of its own, beside the packed program. Rows past
``INDEX_MAX_DEVICE_ROWS`` spill to the host cold tier (``core/coldtier.py``),
whose blocks stream through the same lane program; capacity growth may run
as a background ``GrowthMigration``; ``checkpoint_arrays`` and
``load_state_streaming`` are the checkpoint's side (``core/checkpoint.py``).

Row sharding (``MESH_SHAPE=data:N``, any other axes, ``parallel/``): a
corpus built with a mesh holds one set of the six arrays per data shard
instead, in JAX's contiguous layout (shard ``i`` owns rows
``[i*cap/N, (i+1)*cap/N)``, on the device of the lowest position of data
index ``i`` this process holds), so a v3 checkpoint's row blocks mean the
same rows in both packages. A ``model`` axis replicates the rows, as JAX's
``P("data", None)`` does: one process keeps and computes each data shard
once, and a gang's processes that share a shard each hold a copy. Every
write lands each row in the shard that owns its global position
(``_write``); growth and compaction move rows to the shards the new layout
gives them (``_relayout``); queries run each shard's lanes and merge the
candidates (``parallel/sharded.py``). The cold tier and a mesh
are mutually exclusive, and a sharded corpus grows synchronously: the
background migration replays writes onto one device's buffers, and stands
down under a mesh. In a multi-process gang (``DIST_COORDINATOR``) each
process holds its own shards; the leader mirrors every device op to the
followers over the op-log (``parallel/oplog.py``, ``set_oplog``), emitted
under the corpus lock before the device work, and both corpora share one
lock so the log is a valid serialization of the leader's order.

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
The one thread off the default stream is a growth migration's: it works on a
side stream, and only on buffers no other thread can reach before the swap
(``GrowthMigration`` says how its reads of the live arrays are made good).

Entry points the serving engine calls: ``DeviceIndexManager.
query_both_packed_async`` (one packed H2D buffer, one device program, a
non-blocking D2H of one flat buffer) and ``collect_packed`` (wait, map
positions to doc ids).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import settings
from ..device import DeviceLike, resolve_device
from ..ops.fused import _lanes_one_corpus, dual_corpus_retrieve
from ..ops import fused_scan
from ..ops.hashing import query_vector_from_features
from ..ops.ivf import build_buckets, ivf_topk, kmeans
from ..ops.masks import filter_mask
from ..ops.pack import (
    _densify,
    _unpack,
    dual_corpus_retrieve_packed,
    pack_queries,
    sparse_lex_rows,
    unflatten_lanes,
    unflatten_merged,
)
from ..parallel import sharded as sharded_mod
from ..parallel.mesh import Mesh, gang_world, make_mesh
from ..utils import events
from .coldtier import ColdTier, collect_cold, merge_rect_lanes

logger = logging.getLogger(__name__)

# Multi-process serving (parallel/oplog.py): the leader mirrors every
# device op below to the follower processes. set_oplog is called on the
# LEADER only; followers replay through oplog._apply.
_oplog = None


def set_oplog(log) -> None:
    global _oplog
    _oplog = log


def _multiprocess() -> bool:
    """True when the index spans processes (a gang): every device op is
    mirrored, both corpora share one lock, and the stand-downs apply."""
    return gang_world() > 1


def _np(x) -> np.ndarray:
    """A host array of a numpy array or a tensor (the op-log's payloads)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

INT32_MIN = -2147483648
INT32_MAX = 2147483647

_EMB_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


def dtype_name(dtype: torch.dtype) -> str:
    """A storage dtype as the JAX package names it ("bfloat16", "int8"):
    the checkpoint's meta and the API's answers."""
    return str(dtype).replace("torch.", "")

# a corpus's device arrays, in the order ``device_arrays`` returns them
DEVICE_ARRAYS = ("emb", "lex", "tech", "call_idx", "started", "has_emb")
HOST_MIRRORS = ("h_ids", "h_call", "h_started", "h_has_emb")


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


@functools.lru_cache(maxsize=None)
def _readback_stream(device: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


def _read_back(tensors: Sequence[torch.Tensor], done) -> List[torch.Tensor]:
    """Blocking D2H copies of ``tensors`` requested now, the collect-time
    readback of ``READBACK_PREFETCH_ENABLED=0``: on a stream of their own
    that waits for ``done`` (the dispatch's event) only, so they do not
    queue behind programs dispatched after these tensors' own."""
    stream = _readback_stream(tensors[0].device)
    stream.wait_event(done)
    with torch.cuda.stream(stream):
        hosts = [_to_pinned(t) for t in tensors]
    stream.synchronize()
    return hosts


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


def _apply_op(bufs: Sequence[torch.Tensor], op: str, args: Tuple) -> None:
    """One in-place row write on a corpus's six device arrays. Every write
    site of ``CorpusIndex`` goes through here, and so does the growth
    migration's replay onto its new buffers: what is replayed is what was
    written. Every op is idempotent (rows and their final values)."""
    emb, lex, tech, call_idx, started, has_emb = bufs
    if op == "write_slabs":
        start, emb_t, lex_t, tech_t, call_t, started_t, has_t = args
        sl = slice(start, start + emb_t.shape[0])
        emb[sl] = emb_t
        lex[sl] = lex_t
        tech[sl] = tech_t
        call_idx[sl] = call_t
        started[sl] = started_t
        has_emb[sl] = has_t
    elif op == "scatter_emb":
        idx, rows = args
        emb.index_copy_(0, idx, rows)
        has_emb.index_fill_(0, idx, True)
    elif op == "scatter_tech":
        idx, rows = args
        tech.index_copy_(0, idx, rows)
    elif op == "scatter_lex":
        idx, rows = args
        lex.index_copy_(0, idx, rows)
    elif op == "tombstone":
        (idx,) = args
        started.index_fill_(0, idx, INT32_MIN)
        has_emb.index_fill_(0, idx, False)
    else:  # pragma: no cover - the write sites are fixed
        raise ValueError(f"unknown index write {op!r}")


def _apply_sharded(shards: Dict[int, Sequence[torch.Tensor]], rows: int,
                   op: str, args: Tuple, pos) -> None:
    """``_apply_op`` on a row-sharded layout of ``rows`` rows a shard: each
    row lands in the shard that owns its global position (a slab by its
    start, a scatter or a tombstone by ``pos``, the host positions); rows
    of shards not in ``shards`` are another process's to write."""
    if op == "write_slabs":
        start, *tensors = args
        end = start + tensors[0].shape[0]
        for s, bufs in shards.items():
            a, b = max(start, s * rows), min(end, (s + 1) * rows)
            if a < b:
                dev = bufs[0].device
                _apply_op(bufs, op, (a - s * rows, *(
                    t[a - start:b - start].to(dev) for t in tensors)))
        return
    pos = np.asarray(pos, dtype=np.int64)
    payload = args[1:]
    for s, bufs in shards.items():
        sel = np.flatnonzero((pos >= s * rows) & (pos < (s + 1) * rows))
        if not sel.size:
            continue
        dev = bufs[0].device
        local = torch.from_numpy(pos[sel] - s * rows).to(dev)
        if sel.size < pos.size:
            pick = torch.from_numpy(sel).to(payload[0].device) if payload else None
            picked = [t.index_select(0, pick).to(dev) for t in payload]
        else:
            picked = [t.to(dev) for t in payload]
        _apply_op(bufs, op, (local, *picked))


class GrowthMigration:
    """Background capacity growth with an atomic swap.

    The synchronous ``_grow_to`` allocates, fills and copies while it holds
    the corpus lock, which every dispatch takes. A migration moves that
    work off the lock: a daemon thread allocates the target buffers, fills
    their tail and copies the live arrays into their head on a side stream
    of each device, and ``ensure_capacity`` then swaps them in under the
    lock. A row-sharded corpus (one process's mesh) migrates to the new
    layout's shards: global row ``g`` of the old layout lands in shard
    ``g // new_rows`` of the new one (the contiguous layout of
    ``_relayout``), so a doubling moves most rows to another shard.

    The port's tensors are written in place, so a copy taken off the lock
    races the writers: a row written after the copy read it would be lost,
    and one written while the copy reads it may arrive torn. What makes the
    swap exact is the journal: from the instant the migration starts (under
    the corpus lock, where the copy's start event is also recorded on the
    serving stream), every in-place write is recorded at its write site
    with the device tensors it wrote (and, sharded, its global positions),
    and replayed in order onto the new buffers after the bulk copy of every
    block, by global row onto the new owner shard. Every write is an
    idempotent row write (``_apply_op``), so whatever the copy caught, the
    replay leaves each row with its last written value. Stream order, per
    device: the copy waits for the start event; a journal entry carries
    events recorded on the serving streams after its write was enqueued,
    and the side streams wait for them before replaying (the entry's
    tensors are marked as used there); the swap makes the serving streams
    wait for the side streams, replays the tail there, and marks the new
    buffers as used on the serving streams. Compaction and restore
    renumber rows and CANCEL the migration."""

    def __init__(self, corpus: "CorpusIndex", new_cap: int):
        self.corpus = corpus
        self.new_cap = int(new_cap)
        self.journal: "deque" = deque()
        self.ready = threading.Event()
        self.cancelled = False
        self.swapped = False
        # set when the journal has entries to replay, or the thread is to end
        self._wake = threading.Event()
        self._apply_lock = threading.Lock()
        # the new layout: the six arrays, or {shard: the six} when sharded
        self.bufs = None
        self._sharded = corpus.mesh is not None
        # taken under the corpus lock by ``start_migration``: the live
        # arrays per shard (written in place until the swap or a cancel),
        # their rows a shard, and the point of each serving stream the copy
        # must not overtake
        self._src = dict(corpus.local_shards())
        self._old_rows = corpus.shard_rows
        self.new_rows = self.new_cap // corpus.n_shards
        devices = {bufs[0].device for bufs in self._src.values()}
        self._streams = {dev: torch.cuda.Stream(dev)
                         for dev in sorted(devices, key=str) if dev.type == "cuda"}
        self._cuda = bool(self._streams)
        self._start_events = self._mark() if self._cuda else None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"growth-migrate-{corpus.name}",
        )

    def _mark(self):
        """An event at the current end of each device's serving stream."""
        marks = []
        for dev in self._streams:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            marks.append(ev)
        return marks

    def _wait(self, marks) -> None:
        for stream in self._streams.values():
            for ev in marks:
                stream.wait_event(ev)

    def _on_side_stream(self):
        stack = contextlib.ExitStack()
        for stream in self._streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _sync(self) -> None:
        for stream in self._streams.values():
            stream.synchronize()

    def _apply(self, op: str, args: Tuple, pos) -> None:
        if self._sharded:
            _apply_sharded(self.bufs, self.new_rows, op, args, pos)
        else:
            _apply_op(self.bufs, op, args)

    def start(self) -> None:
        self._thread.start()

    def cancel(self) -> None:
        self.cancelled = True
        self._wake.set()

    # -- journal (called under corpus.lock at each write site) ----------
    def journal_op(self, op: str, args: Tuple, pos=None) -> None:
        if not self.cancelled:
            self.journal.append(
                (op, args, pos, self._mark() if self._cuda else None))
            self._wake.set()

    # -- background thread ------------------------------------------------
    def _alloc_new(self):
        """The new layout, empty, with the rows the copy overwrites left
        uninitialised: the old layout's rows ``[0, old capacity)``."""
        c = self.corpus
        if not self._sharded:
            (rows,) = {b[0].shape[0] for b in self._src.values()}
            return tuple(c._alloc_array(attr, self.new_cap, fill_from=rows)
                         for attr in DEVICE_ARRAYS)
        old_cap = self._old_rows * c.n_shards
        new = {}
        for t in self._src:
            head = min(max(old_cap - t * self.new_rows, 0), self.new_rows)
            new[t] = [c._alloc_array(attr, self.new_rows, fill_from=head,
                                     device=c.shard_devices[t])
                      for attr in DEVICE_ARRAYS]
        return new

    def _copy(self, bufs) -> None:
        """Every old row into the new layout, block by block: each (old
        shard, new shard) pair whose global rows overlap moves one block."""
        if not self._sharded:
            (src,) = self._src.values()
            for new, old in zip(bufs, src):
                new[:old.shape[0]].copy_(old)
            return
        old_rows, new_rows = self._old_rows, self.new_rows
        for t, dst in bufs.items():
            for s, src in self._src.items():
                a = max(t * new_rows, s * old_rows)
                b = min((t + 1) * new_rows, (s + 1) * old_rows)
                if a >= b:
                    continue
                for new, old in zip(dst, src):
                    new[a - t * new_rows:b - t * new_rows].copy_(
                        old[a - s * old_rows:b - s * old_rows])

    def _run(self) -> None:
        c = self.corpus
        try:
            with self._on_side_stream():
                with events.timed("index.migration_alloc", corpus=c.name,
                                  cap=self.new_cap):
                    bufs = self._alloc_new()
                    self._sync()
                with events.timed("index.migration_copy", corpus=c.name):
                    if self._cuda:
                        self._wait(self._start_events)
                    self._copy(bufs)
                    self._sync()
            if self.cancelled:
                return
            self.bufs = bufs
            self.ready.set()
            events.record("index.migration_ready", corpus=c.name,
                          cap=self.new_cap)
            # replay as writes arrive; asleep otherwise (a corpus may sit
            # ready for its swap for a long time)
            while not self.cancelled and not self.swapped:
                self._wake.wait()
                self._wake.clear()
                while self._apply_some(limit=32):
                    pass
        except Exception:  # logged; growth falls back to the synchronous path
            logger.exception("index.migration_failed corpus=%s", c.name)
            self.cancelled = True

    def _apply_some(self, limit: int) -> int:
        n = 0
        with self._apply_lock, self._on_side_stream():
            while self.journal and n < limit and not self.swapped:
                op, args, pos, written = self.journal.popleft()
                if written is not None:
                    self._wait(written)
                    for t in args:
                        if isinstance(t, torch.Tensor):
                            for stream in self._streams.values():
                                if t.device == stream.device:
                                    t.record_stream(stream)
                self._apply(op, args, pos)
                n += 1
        return n

    # -- swap (called under corpus.lock) ---------------------------------
    def finalize(self):
        """Drain the journal tail onto the new buffers, on the serving
        streams, and hand them over. The caller holds the corpus lock, so
        no new journal entries can appear."""
        with self._apply_lock:
            self.swapped = True
            self._wake.set()
            if self._cuda:
                replayed = []
                for stream in self._streams.values():
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    replayed.append(ev)
                shards = self.bufs.values() if self._sharded else [self.bufs]
                for dev in self._streams:
                    serving = torch.cuda.current_stream(dev)
                    for ev in replayed:
                        serving.wait_event(ev)
                    for bufs in shards:
                        for t in bufs:
                            if t.device == dev:
                                t.record_stream(serving)
            while self.journal:
                op, args, pos, _written = self.journal.popleft()
                self._apply(op, args, pos)
            return self.bufs


class CorpusIndex:
    """One document class (chunks or artifact_chunks) on one device, or
    row-sharded over a mesh's ``data`` axis (``mesh``)."""

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
        mesh: Optional[Mesh] = None,
    ):
        if emb_dtype not in _EMB_DTYPES:
            raise ValueError(
                f"index embedding dtype {emb_dtype!r}: the port stores "
                f"{sorted(_EMB_DTYPES)}"
            )
        self.name = name
        self.mesh = mesh
        # shards this process holds: {global shard: [the six arrays]}
        self._shards: Dict[int, List[torch.Tensor]] = {}
        self.n_shards = sharded_mod.data_shards(mesh) if mesh is not None else 1
        # {data shard: its device} of the shards this process holds, each
        # once (a model axis replicates the rows: ``Mesh.local_shards``)
        self.shard_devices = mesh.local_shards() if mesh is not None else {}
        if mesh is not None:
            # merges, staging and derived state live on the first shard's
            # device of this process
            device = next(iter(self.shard_devices.values()))
        self.device = device
        self.dim = dim
        self.lex_dim = lex_dim
        self.tech_slots = tech_slots
        self.capacity = max(8, capacity)
        if mesh is not None:
            if self.capacity % self.n_shards:
                raise ValueError(
                    f"{name}: capacity {self.capacity} does not divide the "
                    f"mesh's data axis ({self.n_shards})")
            # on CUDA each shard's rows round up to K1's block, as growth's
            # do: the reported capacity may exceed the JAX package's
            self.capacity = self._shard_cap(self.capacity)
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
        self._ivf_rebuild_warned = False
        # bumped whenever row positions are renumbered (load_state,
        # compaction): an IVF
        # build that started before must not install its stale buckets
        self._pos_gen = 0
        # Cold tier (core/coldtier.py): rows past max_device_rows spill to
        # host memory, scanned in streamed blocks by the same lane program
        # and lane-merged before RRF.
        self.max_device_rows = int(settings.index_max_device_rows or 0)
        self.cold: Optional[ColdTier] = None
        if self.max_device_rows:
            if mesh is not None:
                raise RuntimeError(
                    "INDEX_MAX_DEVICE_ROWS and MESH_SHAPE are mutually "
                    "exclusive: shard the corpus over the mesh OR spill "
                    "to the host cold tier, not both"
                )
            if _multiprocess():
                raise RuntimeError(
                    "INDEX_MAX_DEVICE_ROWS is single-process only (cold-"
                    "tier ops are not mirrored over the op-log); use the "
                    "data mesh for multi-host scale"
                )
        # active background growth (GrowthMigration) or None; started by
        # the manager's growth planner once the corpus nears its capacity
        self._migration: Optional[GrowthMigration] = None
        # set by DeviceIndexManager: fires after each insert
        self._on_insert = None
        # set by DeviceIndexManager: (corpus, need) -> next capacity, a
        # doubling when the device has room, a fractional step when only
        # that fits (core/prewarm.plan_next_capacity), and the SAME
        # capacity a running migration is heading for
        self._grow_planner = None

    def _array_spec(self, attr: str, rows: int):
        return {
            "emb": ((rows, self.dim), self.emb_dtype),
            "lex": ((rows, self.lex_dim), torch.int8),
            "tech": ((rows, self.tech_slots), torch.int32),
            "call_idx": ((rows,), torch.int32),
            "started": ((rows,), torch.int32),
            "has_emb": ((rows,), torch.bool),
        }[attr]

    def _alloc_array(self, attr: str, cap: int,
                     fill_from: int = 0, device=None) -> torch.Tensor:
        """One empty device array of ``cap`` rows: zeros, and ``started``
        all ``INT32_MIN`` (no row valid). Rows below ``fill_from`` are left
        uninitialised for a caller that overwrites them."""
        shape, dtype = self._array_spec(attr, cap)
        device = self.device if device is None else device
        fill = INT32_MIN if attr == "started" else 0
        if fill_from:
            out = torch.empty(shape, dtype=dtype, device=device)
            out[fill_from:].fill_(fill)
            return out
        return torch.full(shape, fill, dtype=dtype, device=device)

    def _alloc_arrays(self, cap: int) -> Tuple[torch.Tensor, ...]:
        return tuple(self._alloc_array(attr, cap) for attr in DEVICE_ARRAYS)

    def _alloc_shards(self, cap: int) -> Dict[int, List[torch.Tensor]]:
        """This process's shards of a layout of ``cap`` rows, empty."""
        rows = cap // self.n_shards
        return {s: [self._alloc_array(attr, rows, device=dev)
                    for attr in DEVICE_ARRAYS]
                for s, dev in self.shard_devices.items()}

    def _alloc_device(self, cap: int) -> None:
        if self.mesh is not None:
            self._shards = self._alloc_shards(cap)
            (self.emb, self.lex, self.tech, self.call_idx, self.started,
             self.has_emb) = (None,) * len(DEVICE_ARRAYS)
            return
        (self.emb, self.lex, self.tech, self.call_idx, self.started,
         self.has_emb) = self._alloc_arrays(cap)

    def device_arrays(self) -> Tuple[torch.Tensor, ...]:
        if self.mesh is not None:
            raise RuntimeError(
                f"{self.name} is row-sharded: its arrays are per shard "
                "(local_shards())")
        return (self.emb, self.lex, self.tech, self.call_idx, self.started,
                self.has_emb)

    # -- row sharding -------------------------------------------------------
    @property
    def shard_rows(self) -> int:
        return self.capacity // self.n_shards

    def local_shards(self) -> List[Tuple[int, Tuple[torch.Tensor, ...]]]:
        """[(global shard, its six arrays)] of the shards this process holds
        (the whole corpus as shard 0 when unsharded)."""
        if self.mesh is None:
            return [(0, self.device_arrays())]
        return [(s, tuple(bufs)) for s, bufs in sorted(self._shards.items())]

    def _shard_cap(self, cap: int) -> int:
        """``cap`` rounded up to a layout the mesh can shard: a multiple of
        the shard count, and on CUDA of K1's block per shard."""
        if self.mesh is None:
            return cap
        from ..ops.fused_scan import BLOCK_ROWS

        unit = self.n_shards * (BLOCK_ROWS if any(
            dev.type == "cuda" for dev in self.shard_devices.values()) else 1)
        return -(-cap // unit) * unit

    def _emit(self, op: str, statics: Optional[Dict] = None,
              arrays: Optional[Dict] = None) -> None:
        """Mirror a device op to the gang's followers (leader only)."""
        if _oplog is not None:
            _oplog.emit(op, {"corpus": self.name, **(statics or {})}, arrays)

    def _relayout(self, cap: int, src: np.ndarray) -> None:
        """Replace the shards with a layout of ``cap`` rows whose row ``j``
        holds the current row ``src[j]`` (``src`` ascending): growth keeps
        every row (``src`` = 0..count-1), compaction keeps the live ones.
        Each (old shard, new shard) pair moves one block; in a gang every
        process holding the new shard takes the block, from its own old
        shard when it holds that too, else from the old shard's owner
        (every process walks the same pairs in the same order)."""
        from ..parallel import mesh as mesh_mod

        old, old_rows = self._shards, self.shard_rows
        new_rows = cap // self.n_shards
        new = self._alloc_shards(cap)
        mesh, rank = self.mesh, self.mesh.rank
        src = np.asarray(src, dtype=np.int64)
        for t in range(self.n_shards):
            t0, t1 = t * new_rows, min((t + 1) * new_rows, src.shape[0])
            takers = mesh.shard_holders(t)
            for s in range(self.n_shards):
                a = max(t0, int(np.searchsorted(src, s * old_rows)))
                b = min(t1, int(np.searchsorted(src, (s + 1) * old_rows)))
                if a >= b:
                    continue
                owner = mesh.shard_holders(s)[0]
                remote = [r for r in takers if s not in mesh.held_shards(r)]
                if s in old:
                    local = src[a:b] - s * old_rows
                    if local[-1] - local[0] == b - a - 1:
                        block = [buf[int(local[0]):int(local[-1]) + 1]
                                 for buf in old[s]]
                    else:
                        idx = torch.from_numpy(local).to(old[s][0].device)
                        block = [buf.index_select(0, idx) for buf in old[s]]
                    if rank == owner:
                        for r in remote:
                            for piece in block:
                                mesh_mod.send_to(piece, r)
                    if t not in new:
                        continue
                elif t in new:
                    block = [mesh_mod.recv_from(
                        *self._array_spec(attr, b - a), self.shard_devices[t],
                        owner) for attr in DEVICE_ARRAYS]
                else:
                    continue
                for buf, piece in zip(new[t], block):
                    buf[a - t0:b - t0].copy_(piece)
        self._shards = new
        self.capacity = cap

    def _gather_rows(self, attr: str, n: int) -> Optional[torch.Tensor]:
        """The first ``n`` rows of one array, whole, on this process's
        device; in a gang on the leader only (each shard's owner sends its
        rows to it unless the leader holds the shard, and the others get
        None)."""
        from ..parallel import mesh as mesh_mod

        if self.mesh is None:
            return getattr(self, attr)[:n]
        i = DEVICE_ARRAYS.index(attr)
        rank, rows = self.mesh.rank, self.shard_rows
        parts = []
        for s in range(self.n_shards):
            m = min(rows, n - s * rows)
            if m <= 0:
                break
            if s in self._shards and rank == 0:
                parts.append(self._shards[s][i][:m].to(self.device))
            elif rank == 0:
                parts.append(mesh_mod.recv_from(
                    *self._array_spec(attr, m), self.device,
                    self.mesh.shard_holders(s)[0]))
            elif rank == self.mesh.shard_holders(s)[0] and \
                    0 not in self.mesh.shard_holders(s):
                mesh_mod.send_to(self._shards[s][i][:m], 0)
        if rank != 0:
            return None
        if not parts:
            return self._alloc_array(attr, 0)
        return torch.cat(parts) if len(parts) > 1 else parts[0].clone()

    @property
    def avgdl(self) -> float:
        return (self.dl_sum / self.count) if self.count else 0.0

    @property
    def live_count(self) -> int:
        """Live rows across BOTH tiers — idf/avgdl and planner estimates
        are corpus-wide so hot and cold scoring agree."""
        cold = self.cold.live_count if self.cold is not None else 0
        return self.count - self.tombstones + cold

    @property
    def cold_rows(self) -> int:
        """Rows the cold tier holds (tombstoned ones included)."""
        return self.cold.count if self.cold is not None else 0

    def _encode_emb_host(self, rows) -> torch.Tensor:
        """Host rows -> storage-dtype tensor, on the host (a tensor already
        in the storage dtype passes through where it is). int8 storage
        quantizes unit vectors as round(x*127) (the dense lane restores the
        scale); bf16 rows from a JAX checkpoint (ml_dtypes bfloat16) are
        reinterpreted through int16, never cast; f32 rows round to bf16."""
        if isinstance(rows, torch.Tensor):
            if rows.dtype == self.emb_dtype:
                return rows
            rows = rows.float().cpu().numpy()
        rows = np.asarray(rows)
        if self.emb_dtype == torch.int8:
            if rows.dtype != np.int8:
                rows = np.clip(
                    np.rint(rows.astype(np.float32) * 127.0), -127, 127
                ).astype(np.int8)
            return _from_host(rows)
        if rows.dtype.name == "bfloat16" and rows.dtype.itemsize == 2:
            return _from_host(rows.view(np.int16)).view(torch.bfloat16)
        return _from_host(rows.astype(np.float32, copy=False)).to(torch.bfloat16)

    def _encode_emb(self, rows: np.ndarray) -> torch.Tensor:
        """``_encode_emb_host`` on the device. A tensor (a checkpoint's
        decoded bf16 rows) passes through when it is in the storage
        dtype."""
        return self._encode_emb_host(rows).to(self.device)

    def _put(self, arr, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=dtype)
        return _from_host(arr).to(device=self.device, dtype=dtype)

    # -- growth ---------------------------------------------------------
    def _grow_to(self, cap: int) -> None:
        """Reallocate at ``cap`` rows and copy the rows over; sharded, the
        rows move to the shards of the new layout (contiguous blocks of
        ``cap``): in a gang across processes too."""
        with events.timed("index.grow", corpus=self.name,
                          old_cap=int(self.capacity), cap=int(cap)):
            self._emit("grow", {"cap": int(cap)})
            if self.mesh is not None:
                self._relayout(cap, np.arange(self.count))
            else:
                old = self.device_arrays()
                self.capacity = cap
                self._alloc_device(cap)
                for new, prev in zip(self.device_arrays(), old):
                    new[: prev.shape[0]].copy_(prev)
            self._grow_host_mirrors(cap)

    def _grow_host_mirrors(self, cap: int) -> None:
        with events.timed("index.grow_mirrors", corpus=self.name, cap=int(cap)):
            for attr in HOST_MIRRORS:
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
        mig = self._migration
        if mig is not None:
            if (mig.ready.is_set() and not mig.cancelled
                    and mig.new_cap >= need):
                with events.timed("index.growth_swap", corpus=self.name,
                                  cap=mig.new_cap):
                    bufs = mig.finalize()
                    if self.mesh is not None:
                        self._shards = bufs
                    else:
                        (self.emb, self.lex, self.tech, self.call_idx,
                         self.started, self.has_emb) = bufs
                    self.capacity = mig.new_cap
                    self._grow_host_mirrors(mig.new_cap)
                self._migration = None
                logger.info(
                    "index.growth_swapped corpus=%s cap=%s (background "
                    "migration; serving never waited on the copy)",
                    self.name, mig.new_cap,
                )
                return
            # not ready / target too small: pay the synchronous growth
            mig.cancel()
            self._migration = None
            logger.warning(
                "index.migration_not_ready corpus=%s need=%s target=%s "
                "ready=%s — falling back to synchronous growth",
                self.name, need, mig.new_cap, mig.ready.is_set(),
            )
        if self._grow_planner is not None:
            cap = int(self._grow_planner(self, need))
        else:
            cap = self.capacity
            while cap < need:
                cap *= 2
        self._grow_to(self._shard_cap(max(cap, need)))

    def start_migration(self, new_cap: int) -> bool:
        """Begin background growth toward ``new_cap`` (rounded to a layout
        the mesh shards; idempotent). One process only, row-sharded or not:
        a gang mirrors "grow" synchronously over the op-log. Hot tier only:
        a corpus with a cold tier caps its device rows."""
        if (_multiprocess() or self.max_device_rows
                or not settings.growth_migration_enabled):
            return False
        new_cap = self._shard_cap(int(new_cap))
        with self.lock:
            if new_cap <= self.capacity:
                return False
            mig = self._migration
            if mig is not None:
                if mig.new_cap >= new_cap and not mig.cancelled:
                    return False  # already migrating there
                mig.cancel()
            self._migration = GrowthMigration(self, new_cap)
            self._migration.start()
            events.record("index.migration_start", corpus=self.name,
                          cap=int(new_cap))
            return True

    def _cancel_migration_locked(self) -> None:
        """Row positions are being renumbered/reloaded (compaction,
        restore): a migration's copied rows and journal are stale."""
        if self._migration is not None:
            self._migration.cancel()
            self._migration = None

    def _write(self, op: str, args: Tuple,
               pos: Optional[np.ndarray] = None) -> None:
        """One in-place row write (``_apply_op``) on the live arrays,
        journaled for a running growth migration. Caller holds the lock.
        Sharded, each row lands in the shard that owns its global position
        (``pos``: the host positions of a scatter or a tombstone); rows of
        shards another process holds are that process's to write."""
        if self.mesh is not None:
            _apply_sharded(self._shards, self.shard_rows, op, args, pos)
        else:
            _apply_op(self.device_arrays(), op, args)
        mig = self._migration
        if mig is not None:
            mig.journal_op(op, args, pos)

    # -- ingest -----------------------------------------------------------
    def insert(self, rows: Sequence[DocRow]) -> None:
        if not rows:
            return
        # a cold tier that these rows would outgrow gets its larger arrays
        # here, off the lock that every dispatch takes
        cold_spare = (self.cold.spare_arrays(len(rows))
                      if self.cold is not None else None)
        with self.lock:
            with events.timed("index.insert", corpus=self.name,
                              rows=len(rows)):
                self._insert_locked(rows, cold_spare)
        self._maybe_schedule_ivf_rebuild()
        if self._on_insert is not None:
            self._on_insert()

    def _cold_tier(self) -> ColdTier:
        if self.cold is None:
            self.cold = ColdTier(
                dim=self.dim, lex_dim=self.lex_dim,
                tech_slots=self.tech_slots, emb_dtype=self.emb_dtype,
                device=self.device,
            )
            logger.warning(
                "%s: device-row cap %s reached — new rows spill to the "
                "host cold tier (core/coldtier.py; scanned per batch in "
                "%s-row blocks)",
                self.name, self.max_device_rows,
                int(settings.cold_block_rows),
            )
        return self.cold

    def _present(self, doc_id: int) -> bool:
        if int(doc_id) in self._id_to_pos:
            return True
        return self.cold is not None and self.cold.contains(doc_id)

    def _cold_insert_locked(self, rows: Sequence[DocRow], spare=None) -> None:
        tier = self._cold_tier()
        tier.insert(rows, self._encode_emb, spare)
        for r in rows:
            self.doc_freq[r.lex_touched] += 1
            self.dl_sum += r.lex_dl

    def _insert_locked(self, rows: Sequence[DocRow], cold_spare=None) -> None:
        # a row already present (same doc_id) is a no-op: a syncer and a
        # local ingest may race to insert the same committed row
        rows = [r for r in rows if not self._present(r.doc_id)]
        if self.deleted_ids:
            # a row tombstoned here can only reappear through a stale sync
            # or rebuild read that raced the store delete: refuse it
            rows = [r for r in rows if int(r.doc_id) not in self.deleted_ids]
        if not rows:
            return
        if self.max_device_rows:
            take = min(len(rows), max(0, self.max_device_rows - self.count))
            # ensure_capacity reserves the POW2-PADDED slab: at a cap that
            # equals the allocated capacity, a padded tail slab would
            # otherwise DOUBLE the device arrays past max_device_rows, the
            # limit that exists because device memory is full. Shrink the
            # hot intake until its padding fits the existing allocation;
            # the remainder spills to the cold tier like any over-cap rows.
            if self.capacity >= self.max_device_rows:
                while take and self.count + _next_pow2(take) > self.capacity:
                    take = min(take - 1, _next_pow2(take) // 2)
            if len(rows) > take:
                self._cold_insert_locked(rows[take:], cold_spare)
                rows = rows[:take]
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
        self._write_slab(start, start + n, {
            "emb": self._encode_emb_host(emb),
            "lex": np.stack([r.lex_sig for r in rows]).astype(np.int8),
            "tech": np.stack([r.tech for r in rows]).astype(np.int32),
            "call": np.array([r.call_seq for r in rows], dtype=np.int32),
            "started": np.array([r.started_sec for r in rows], dtype=np.int32),
            "has": has,
        })
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

    def _write_slab(self, start: int, count_after: int,
                    slab: Dict[str, object]) -> None:
        """Write rows ``[start, start + m)`` from host arrays (``emb`` in the
        storage dtype, the op-log's "write_slabs" payload): mirrored to the
        gang, then uploaded and written. Caller holds the lock."""
        self._emit("write_slabs", {"start": int(start),
                                   "count_after": int(count_after)}, slab)
        self._write("write_slabs", (
            start,
            self._encode_emb(slab["emb"]),
            self._put(slab["lex"], torch.int8),
            self._put(slab["tech"], torch.int32),
            self._put(slab["call"], torch.int32),
            self._put(slab["started"], torch.int32),
            self._put(slab["has"], torch.bool),
        ))

    def _scatter(self, op: str, pos: np.ndarray, vals=None) -> None:
        """A row scatter (or, without ``vals``, a tombstone) at host
        positions: mirrored to the gang, then written. Caller holds the
        lock."""
        pos = np.asarray(pos)
        arrays = {"pos": pos.astype(np.int32)}
        if vals is not None:
            arrays["vals"] = vals
        self._emit(op, None, arrays)
        idx = self._put(pos.astype(np.int64), torch.int64)
        if vals is None:
            self._write(op, (idx,), pos)
        elif op == "scatter_emb":
            self._write(op, (idx, self._encode_emb(vals)), pos)
        else:
            dtype = torch.int8 if op == "scatter_lex" else torch.int32
            self._write(op, (idx, self._put(vals, dtype)), pos)

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
            vectors = np.asarray(vectors, dtype=np.float32)
            cold_n = 0
            if self.cold is not None:
                cold_pos = self.cold.positions(doc_ids)
                cmask = cold_pos >= 0
                if cmask.any():
                    cold_n = self.cold.set_embeddings(
                        cold_pos[cmask], vectors[cmask], self._encode_emb)
            pos = self.position_of(doc_ids)
            keep = pos >= 0
            if not keep.any():
                return cold_n
            pos = pos[keep]
            self._scatter("scatter_emb", pos,
                          self._encode_emb_host(vectors[keep]))
            self.emb_rows += int((~self.h_has_emb[pos]).sum())
            self.h_has_emb[pos] = True
            return int(pos.shape[0]) + cold_n

    def contains(self, doc_ids: Sequence[int]) -> np.ndarray:
        """Presence of each id in EITHER tier (the syncer and ``reconcile``
        ask this instead of ``position_of``, which is hot-tier positional)."""
        with self.lock:
            return np.array([self._present(d) for d in doc_ids], dtype=bool)

    def _live_positions(self, doc_ids: Sequence[int], rows: np.ndarray,
                        positions: Optional[np.ndarray] = None):
        """(host positions, rows) of the ids this corpus holds live."""
        pos = positions if positions is not None else self.position_of(doc_ids)
        keep = pos >= 0
        return pos[keep], rows[keep]

    def set_tech(self, doc_ids: Sequence[int], tech_rows: np.ndarray) -> int:
        """Replace the tech-token slots of existing rows (tech-token
        backfill after lexicon changes): one scatter. -> rows written."""
        with self.lock:
            tech_rows = np.asarray(tech_rows, dtype=np.int32)
            cold_n = 0
            if self.cold is not None:
                cold_pos = self.cold.positions(doc_ids)
                cmask = cold_pos >= 0
                if cmask.any():
                    cold_n = self.cold.set_tech(
                        cold_pos[cmask], tech_rows[cmask])
            pos, vals = self._live_positions(doc_ids, tech_rows)
            if pos.size:
                self._scatter("scatter_tech", pos, vals)
            return int(pos.size) + cold_n

    def set_lex(
        self, doc_ids: Sequence[int], lex_rows: np.ndarray,
        positions: Optional[np.ndarray] = None,
    ) -> int:
        """Replace the lexical signatures of existing rows (a re-featurize
        under another layout): a pure row scatter; the caller rebuilds the
        df table with ``replace_doc_freq`` once every row is rewritten.
        ``positions`` skips the id lookup (-1 = not live)."""
        with self.lock:
            pos, vals = self._live_positions(
                doc_ids, np.asarray(lex_rows, dtype=np.int8), positions)
            if pos.size:
                self._scatter("scatter_lex", pos, vals)
            return int(pos.size)

    def set_lex_ids(
        self, doc_ids: Sequence[int], lex_rows: np.ndarray
    ) -> np.ndarray:
        """``set_lex`` by doc id across BOTH tiers -> the per-id live mask
        (a re-featurize rebuilds df over every live row, hot or cold, from
        it)."""
        with self.lock, events.timed("index.set_lex_ids", corpus=self.name,
                                     rows=len(doc_ids)):
            pos = self.position_of(doc_ids)
            self.set_lex(doc_ids, lex_rows, positions=pos)
            live = pos >= 0
            if self.cold is not None:
                cold_pos = self.cold.positions(doc_ids)
                cmask = cold_pos >= 0
                if cmask.any():
                    self.cold.set_lex(
                        cold_pos[cmask],
                        np.asarray(lex_rows, dtype=np.int8)[cmask])
                live = live | cmask
            return live

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
            cold_n = 0
            if self.cold is not None:
                cold_n = self._cold_delete_locked(doc_ids, lex_sigs, lex_dls)
            pos_all = self.position_of(doc_ids)
            # unknown ids and repeats of one id count once
            _uniq, first = np.unique(pos_all, return_index=True)
            keep = np.zeros(pos_all.shape[0], dtype=bool)
            keep[first] = True
            keep &= pos_all >= 0
            if not keep.any():
                return cold_n
            pos = pos_all[keep]
            self._scatter("tombstone", pos)
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
            return int(pos.shape[0]) + cold_n

    def _cold_delete_locked(self, doc_ids, lex_sigs, lex_dls) -> int:
        """Tombstone the ids the cold tier holds (repeats of one id count
        once) and shed their share of the corpus-wide lexical stats."""
        cold_pos = self.cold.positions(doc_ids)
        _uniq, first = np.unique(cold_pos, return_index=True)
        uniq_idx = [int(i) for i in np.sort(first) if cold_pos[i] >= 0]
        if not uniq_idx:
            return 0
        sigs = ([lex_sigs[i] for i in uniq_idx]
                if lex_sigs is not None else None)
        dls = [lex_dls[i] for i in uniq_idx] if lex_dls is not None else None
        cold_n = self.cold.tombstone(cold_pos[uniq_idx], sigs, dls)
        for sig in sigs or ():
            if sig is not None:
                touched = np.flatnonzero(sig)
                self.doc_freq[touched] = np.maximum(
                    self.doc_freq[touched] - 1, 0)
        for dl in dls or ():
            self.dl_sum = max(self.dl_sum - int(dl or 0), 0)
        return cold_n

    def maybe_compact(self, threshold_frac: float = 0.25) -> bool:
        """Compact once tombstones reach a quarter of the rows (and at
        least 64): bounded wasted device memory and scan work for a
        one-time gather of the live rows."""
        compacted = False
        with self.lock:
            if self.cold is not None and self.cold.tombstones >= max(
                    int(self.cold.count * threshold_frac), 64):
                self.cold.compact()
                compacted = True
            if self.tombstones >= max(int(self.count * threshold_frac), 64):
                self.compact()
                compacted = True
            return compacted

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
            cap = self._shard_cap(max(_next_pow2(max(out_rows, 8)),
                                      int(settings.index_initial_capacity)))
            self._emit("compact", {"out_rows": out_rows, "cap": int(cap)},
                       {"live": live.astype(np.int32)})
            self.apply_compact_device(live, out_rows, cap)
            for attr in HOST_MIRRORS:
                old = getattr(self, attr)
                mirror = np.zeros(cap, dtype=old.dtype)
                if attr == "h_started":
                    mirror[:] = INT32_MIN
                mirror[:out_rows] = old[live]
                setattr(self, attr, mirror)
            self._id_to_pos = {
                int(d): p for p, d in enumerate(self.h_ids[:out_rows])}
            self.emb_rows = int(self.h_has_emb[:out_rows].sum())
            self.tombstones = 0

    def apply_compact_device(self, live: np.ndarray, out_rows: int,
                             cap: int) -> None:
        """The device side of compaction: the rows ``live[:out_rows]``
        (ascending) packed to the front of arrays of ``cap`` rows; the IVF
        index is dropped and ``_pos_gen`` moves. The one implementation the
        leader (``compact``) and a gang's followers (the op-log's
        "compact") run. Unsharded, each array is gathered straight into the
        front of its new allocation and the old one released before the
        next is allocated, so the peak is the old arrays plus the largest
        new one; sharded, the rows move to the new layout's shards."""
        live = np.asarray(live)[:out_rows].astype(np.int64)
        if self.mesh is not None:
            self._relayout(cap, live)
        else:
            take = self._put(live, torch.int64)
            for attr in DEVICE_ARRAYS:
                dst = self._alloc_array(attr, cap)
                torch.index_select(getattr(self, attr), 0, take,
                                   out=dst[:out_rows])
                setattr(self, attr, dst)
            self.capacity = cap
        self.count = out_rows
        self.ivf = None
        self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
        self._cancel_migration_locked()
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
            # the cold rows are compacted in place, so their share is
            # counted under the lock
            cold_est = (
                self.cold.estimate(allowed_calls, date_min, date_max,
                                   require_embedding, unfiltered)
                if self.cold is not None else 0)
            if n == 0:
                return cold_est
            if unfiltered:
                hot = (self.emb_rows if require_embedding
                       else self.count - self.tombstones)
                return hot + cold_est
            started = self.h_started[:n]
            call = self.h_call[:n]
            has_emb = self.h_has_emb[:n]
        mask = (started >= date_min) & (started <= date_max)
        if allowed_calls is not None:
            mask &= allowed_calls[call]
        if require_embedding:
            mask &= has_emb
        return int(mask.sum()) + cold_est

    # -- state carried across packages (checkpoint payload) ----------------
    def _hot_lexical_stats(self) -> Tuple[np.ndarray, int]:
        """(doc_freq, dl_sum) of the hot tier alone. A checkpoint holds the
        HOT tier only: the cold tier's share of the lexical stats is
        subtracted, and the startup reconcile re-adds it when the cold rows
        re-insert from the store."""
        doc_freq = self.doc_freq.copy()
        dl_sum = self.dl_sum
        if self.cold is not None and self.cold.count:
            logger.warning(
                "%s: checkpoint snapshots the HOT tier only — %s cold-tier "
                "rows rebuild from the store at startup (sync.reconcile)",
                self.name, self.cold.count,
            )
            doc_freq = np.maximum(doc_freq - self.cold.df, 0)
            dl_sum = max(dl_sum - self.cold.dl_sum, 0)
        return doc_freq, dl_sum

    def _scalar_state(self, c: int) -> Dict[str, np.ndarray]:
        doc_freq, dl_sum = self._hot_lexical_stats()
        return {
            "ids": self.h_ids[:c].copy(),
            "call": self.h_call[:c].copy(),
            "started": self.h_started[:c].copy(),
            "has_emb": self.h_has_emb[:c].copy(),
            "doc_freq": doc_freq,
            "dl_sum": np.array([dl_sum], dtype=np.int64),
        }

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The JAX package's ``state_arrays`` dict (hot tier). bf16
        embeddings widen to f32 (exact; numpy has no bf16) and round back
        exactly on load; the checkpoint moves the 2-byte pattern instead
        (``checkpoint_arrays``)."""
        with self.lock:
            self._single_process_only("state_arrays")
            c = self.count
            emb = self._gather_rows("emb", c)
            # copies, never views: on the CPU ``_to_host`` shares the live
            # tensor's memory, which later writes change in place
            return {
                "emb": _to_host(emb.clone() if emb.dtype == torch.int8
                                else emb.float()),
                "lex": _to_host(self._gather_rows("lex", c).clone()),
                "tech": _to_host(self._gather_rows("tech", c).clone()),
                **self._scalar_state(c),
            }

    def _single_process_only(self, what: str) -> None:
        if _multiprocess():
            raise RuntimeError(
                f"{self.name}.{what}: the device arrays span processes; a "
                "gang saves through core/checkpoint.save_index (format v3, "
                "each process writing its own row blocks)")

    def checkpoint_arrays(self) -> Dict[str, np.ndarray]:
        """``state_arrays`` for ``core/checkpoint.save_index``: the rows in
        their storage dtype, bf16 as its uint16 bit pattern (reinterpreted
        through int16; never widened), int8 as it is. On CUDA the three row
        arrays are copied into pinned host memory allocated before the lock
        is taken; under the lock the copies are only enqueued (writers
        queue behind them on the same stream, so the snapshot is
        consistent), and the wait for them happens after the lock is
        released. The ``index.checkpoint_snapshot`` span is the time the
        lock was held, ``index.checkpoint_pinned_alloc`` the allocation
        before it."""
        cuda = self.device.type == "cuda"

        def host_buffers(c: int) -> Dict[str, torch.Tensor]:
            out = {}
            for attr in ("emb", "lex", "tech"):
                shape, dtype = self._array_spec(attr, c)
                out[attr] = torch.empty(shape, dtype=dtype, pin_memory=True)
            return out

        bufs = None
        if cuda:
            # pinning gigabytes takes about a second, during which the
            # device takes no new work from any thread: timed on its own
            with events.timed("index.checkpoint_pinned_alloc", corpus=self.name):
                bufs = host_buffers(self.count)
        with self.lock:
            self._single_process_only("checkpoint_arrays")
            t0 = time.monotonic()
            c = self.count
            if cuda:
                if bufs["lex"].shape[0] != c:
                    bufs = host_buffers(c)   # rows came or went meanwhile
                rows = self.shard_rows
                for s, arrays in self.local_shards():
                    m = min(rows, c - s * rows)
                    for attr, host in bufs.items():
                        if m > 0:
                            host[s * rows:s * rows + m].copy_(
                                arrays[DEVICE_ARRAYS.index(attr)][:m],
                                non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(torch.cuda.current_stream(self.device))
            else:
                bufs = {attr: self._gather_rows(attr, c).clone()
                        for attr in ("emb", "lex", "tech")}
            out = self._scalar_state(c)
            events.record("index.checkpoint_snapshot",
                          time.monotonic() - t0, corpus=self.name, rows=c)
        if cuda:
            copied.synchronize()
        emb = bufs["emb"]
        if emb.dtype == torch.bfloat16:
            emb = emb.view(torch.int16)
        emb = emb.numpy()
        out["emb"] = emb.view(np.uint16) if emb.dtype == np.int16 else emb
        out["lex"] = bufs["lex"].numpy()
        out["tech"] = bufs["tech"].numpy()
        return out

    def load_state(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install a ``state_arrays`` dict — from this package or from the
        JAX package's ``CorpusIndex.state_arrays()``."""
        rows = {k: arrays[k] for k in
                ("emb", "lex", "tech", "ids", "call", "started", "has_emb")}
        self.load_state_streaming(
            [rows], arrays["doc_freq"], int(arrays["dl_sum"][0]),
            int(arrays["ids"].shape[0]))

    def load_state_streaming(
        self,
        shards: Iterable[Dict[str, np.ndarray]],
        doc_freq: np.ndarray,
        dl_sum: int,
        total_rows: int,
    ) -> None:
        """Streaming restore: one slab write per shard as each arrives, so
        the read of shard i+1 (``core/checkpoint._shard_stream`` prefetches
        on a thread) overlaps the upload of shard i and the host never holds
        the whole corpus. Shards arrive in row order with the keys of
        ``checkpoint.ROW_KEYS``; ``emb`` is f32, int8, or a bf16 tensor."""
        with self.lock:
            n = int(total_rows)
            self.count = 0
            # checkpoints are hot-tier-only: cold rows rebuild from the
            # store via the startup reconcile (they spill again past the cap)
            self.cold = None
            # row positions change: derived IVF state is invalid
            self.ivf = None
            self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
            self._cancel_migration_locked()
            self._pos_gen += 1
            cap = self._shard_cap(max(self.capacity, _next_pow2(max(n, 8))))
            self.capacity = cap
            self._emit("alloc", {"cap": int(cap)})
            self._alloc_device(cap)
            self.h_ids = np.zeros(cap, dtype=np.int64)
            self.h_call = np.zeros(cap, dtype=np.int32)
            self.h_started = np.full(cap, INT32_MIN, dtype=np.int32)
            self.h_has_emb = np.zeros(cap, dtype=bool)
            off = 0
            for shard in shards:
                m = int(shard["ids"].shape[0])
                if m == 0:
                    continue
                if off + m > n:
                    raise ValueError(
                        f"{self.name}: checkpoint shards carry more than "
                        f"the {n} rows meta says")
                call = shard["call"].astype(np.int32)
                started = shard["started"].astype(np.int32)
                has = shard["has_emb"].astype(bool)
                self._write_slab(off, off + m, {
                    "emb": self._encode_emb_host(shard["emb"]),
                    "lex": shard["lex"].astype(np.int8, copy=False),
                    "tech": shard["tech"].astype(np.int32, copy=False),
                    "call": call, "started": started, "has": has,
                })
                self.h_ids[off:off + m] = shard["ids"]
                self.h_call[off:off + m] = call
                self.h_started[off:off + m] = started
                self.h_has_emb[off:off + m] = has
                off += m
            if off != n:
                raise ValueError(
                    f"{self.name}: checkpoint shards carried {off} rows, "
                    f"meta says {n}")
            self.doc_freq = np.asarray(doc_freq).astype(np.int64)
            self.dl_sum = int(dl_sum)
            started = self.h_started[:n]
            # tombstoned rows restore as tombstones: their ids must not
            # resolve (a re-delete would double-count, a backfill would
            # write into a dead row)
            self._id_to_pos = {
                int(d): p for p, d in enumerate(self.h_ids[:n])
                if started[p] != INT32_MIN
            }
            self.emb_rows = int(self.h_has_emb[:n].sum())
            self.tombstones = int((started == INT32_MIN).sum())
            self.count = n

    # -- IVF dense index ----------------------------------------------------
    def _ivf_append_overflow(self, positions: np.ndarray) -> None:
        self._ivf_overflow_host = np.concatenate(
            [self._ivf_overflow_host, positions.astype(np.int32)])
        padded = _padded_overflow(self._ivf_overflow_host)
        # the overflow tail is an input of every process's probed query:
        # a gang's followers take the leader's
        self._emit("ivf_overflow", {"count": len(self._ivf_overflow_host)},
                   {"padded": padded})
        self.ivf = dataclasses.replace(
            self.ivf,
            overflow=self._put(padded, torch.int32),
            overflow_count=len(self._ivf_overflow_host),
        )

    def gang_set_ivf_overflow(self, padded: np.ndarray, count: int) -> None:
        """A follower's side of "ivf_overflow" (parallel/oplog._apply)."""
        with self.lock:
            padded = np.asarray(padded, dtype=np.int32)
            self._ivf_overflow_host = padded[:count].copy()
            self.ivf = dataclasses.replace(
                self.ivf, overflow=self._put(padded, torch.int32),
                overflow_count=int(count))

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
        ran (``_pos_gen`` moved) aborts the build. A sharded corpus reads
        every shard's rows into the one k-means (the same build as the
        unsharded index's). In a gang the build is one mirrored op
        ("build_ivf") that holds the shared lock throughout: the leader
        gathers the rows and clusters them, and every process installs the
        leader's centroids and assignments (``gang_build_install_ivf``)."""
        if _multiprocess():
            with self.lock:
                if self.count == 0:
                    raise RuntimeError(
                        f"{self.name}: empty corpus, nothing to build")
                n = self.count
                clusters, probe = self._ivf_plan(n, n_clusters, nprobe)
                self._emit("build_ivf", {"n": int(n), "clusters": int(clusters),
                                         "nprobe": int(probe), "seed": int(seed)})
                return self.gang_build_install_ivf(n, clusters, probe, int(seed))
        with self.lock:
            if self.count == 0:
                raise RuntimeError(f"{self.name}: empty corpus, nothing to build")
            n = self.count
            pos_gen = self._pos_gen
            snapshot = self._gather_rows("emb", n)
            if self.mesh is None:
                snapshot = snapshot.clone()
        clusters, probe = self._ivf_plan(n, n_clusters, nprobe)
        centroids, assign = self._kmeans(snapshot, clusters, seed)
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

    def _kmeans(self, snapshot: torch.Tensor, clusters: int, seed: int):
        if self.emb_dtype == torch.int8:
            # k-means runs in float space (float centroids cast back to int8
            # degenerate); the probed scan widens int8 rows and rescales
            snapshot = snapshot.float() / 127.0
        gen = torch.Generator(device=snapshot.device)
        gen.manual_seed(int(seed))
        return kmeans(snapshot, n_clusters=clusters, iters=10, generator=gen)

    def gang_build_install_ivf(self, n: int, clusters: int, probe: int,
                               seed: int) -> IvfState:
        """The gang's IVF build: the leader (rank 0) gathers the first
        ``n`` rows from every process and runs the k-means; the centroids
        and assignments are broadcast, and every process packs the same
        buckets. The leader calls this inside ``build_ivf`` (after emitting
        "build_ivf"), the followers from the op-log. A CUDA k-means sums in
        no fixed order, so the processes take the leader's result rather
        than each clustering alone."""
        from ..parallel import mesh as mesh_mod

        with self.lock:
            snapshot = self._gather_rows("emb", n)
            centroids = assign = None
            if snapshot is not None:
                centroids, assign = self._kmeans(snapshot, clusters, seed)
            del snapshot
            if _multiprocess():
                centroids = mesh_mod.broadcast(
                    centroids, (clusters, self.dim), torch.float32, self.device, 0)
                assign = mesh_mod.broadcast(assign, (n,), torch.int32, self.device, 0)
            bucket_cap = max(8, int(2.0 * n / clusters))
            buckets_np, overflow_np = build_buckets(
                assign.cpu().numpy(), clusters, bucket_cap)
            self._ivf_overflow_host = overflow_np.astype(np.int32)
            self.ivf = IvfState(
                centroids=centroids,
                buckets=self._put(buckets_np, torch.int32),
                overflow=self._put(_padded_overflow(self._ivf_overflow_host),
                                   torch.int32),
                overflow_count=len(self._ivf_overflow_host),
                built_count=int(n),
                n_clusters=int(clusters),
                nprobe=int(probe),
            )
            return self.ivf

    def load_ivf_state(self, state) -> None:
        """Install an IVF state carried from elsewhere — the JAX index's
        ``IvfState``, or another index's of this package (any object with
        its fields) — over the current rows, as ``load_state`` carries the
        rows, so both packages (and a sharded and an unsharded index) can
        serve the same IVF."""
        with self.lock:
            count = int(state.overflow_count)
            overflow = _np(state.overflow).astype(np.int32)
            self._ivf_overflow_host = overflow[:count].copy()
            self.ivf = IvfState(
                centroids=self._put(_np(state.centroids).astype(np.float32),
                                    torch.float32),
                buckets=self._put(_np(state.buckets), torch.int32),
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
            if _multiprocess() and not settings.dense_ivf_auto_rebuild_multihost:
                # a gang build is a mirrored program that holds the shared
                # lock for the whole k-means: fired from the insert path it
                # would pause /retrieve on the leader. Operators rebuild
                # explicitly (scripts/build_ivf) or opt in.
                if not self._ivf_rebuild_warned:
                    self._ivf_rebuild_warned = True
                    logger.warning(
                        "ivf.auto_rebuild_standdown corpus=%s overflow=%d "
                        "built=%d: a gang build blocks serving for the "
                        "k-means; run scripts/build_ivf or set "
                        "DENSE_IVF_AUTO_REBUILD_MULTIHOST=1",
                        self.name, state.overflow_count, state.built_count)
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
            k = min(k, self.capacity)
            if self.mesh is not None:
                if _multiprocess():
                    self._emit("query_ivf", {"statics": {"k": int(k)}}, {
                        "q_emb": _np(q_emb).astype(np.float32),
                        "allowed": _np(allowed_calls).astype(bool),
                        "dmin": _np(date_min).astype(np.int32),
                        "dmax": _np(date_max).astype(np.int32)})
                return sharded_mod.ivf_lanes(
                    self, state, self._put(q_emb, torch.float32),
                    self._put(allowed_calls, torch.bool),
                    self._put(date_min, torch.int32),
                    self._put(date_max, torch.int32), k=k)
            mask = filter_mask(
                self.call_idx, self.started, self._put(allowed_calls, torch.bool),
                self._put(date_min, torch.int32), self._put(date_max, torch.int32))
            return ivf_topk(
                self._put(q_emb, torch.float32), self.emb, state.centroids,
                state.buckets, state.overflow, mask & self.has_emb[None, :],
                k=k, nprobe=state.nprobe)

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
            statics = {"k_dense": min(k_dense, self.capacity),
                       "k_lex": min(k_lex, self.capacity),
                       "k_tech": min(k_tech, self.capacity),
                       "dense_mode": dense_mode, "dense_enabled": dense_enabled}
            queries = {
                "q_emb": _np(q_emb).astype(np.float32),
                "q_lex": _np(q_lex).astype(np.float32),
                "q_tech": _np(q_tech).astype(np.int32),
                "allowed": _np(allowed_calls).astype(bool),
                "dmin": _np(date_min).astype(np.int32),
                "dmax": _np(date_max).astype(np.int32)}
            if _multiprocess():
                self._emit("query_single", {"statics": statics}, queries)
            out = self.run_single_query(queries, statics)
            host = {lane: (_to_host(v), _to_host(p)) for lane, (v, p) in out.items()}
            return self.postprocess_lanes(host, batch)

    def run_single_query(self, queries: Dict[str, np.ndarray],
                         statics: Dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """This corpus's three lanes on the device (``query``'s program; a
        gang's followers run it for the op-log's "query_single")."""
        put = self._put
        args = (put(queries["q_emb"], torch.float32),
                put(queries["q_lex"], torch.float32),
                put(queries["q_tech"], torch.int32),
                put(queries["allowed"], torch.bool),
                put(queries["dmin"], torch.int32),
                put(queries["dmax"], torch.int32))
        if self.mesh is not None:
            return sharded_mod.single_lanes(self, *args, **statics)
        return _lanes_one_corpus(*self.device_arrays(), *args, **statics)

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
    # the program's output itself, kept until collect when the readback is
    # not prefetched (READBACK_PREFETCH_ENABLED off); flat_host is then None
    flat_out: Optional[torch.Tensor] = None
    done: Optional[object] = None       # torch.cuda.Event or None
    sig: Optional[QuerySignature] = None
    served_chunk_mode: Optional[str] = None
    extra_dense: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    chunk_snap: Tuple[Optional[np.ndarray], int] = (None, 0)
    artifact_snap: Tuple[Optional[np.ndarray], int] = (None, 0)
    batch: int = 0
    ready: Optional[Tuple[Dict, Dict]] = None
    # in-flight cold-tier block scans per corpus (core/coldtier.py), merged
    # at collect, and the lane widths the caller asked for
    cold_chunks: list = dataclasses.field(default_factory=list)
    cold_artifacts: list = dataclasses.field(default_factory=list)
    cold_ks: Optional[Tuple[Tuple[int, int, int], Tuple[int, int, int]]] = None
    # while the event ring is on, on the single-card packed path: the
    # fields of the ``index.dispatch`` event that ``collect_packed``
    # records, and on CUDA the timing event recorded before the upload
    # (``done`` then times too)
    trace: Optional[Dict] = None


class DeviceIndexManager:
    """Both corpora on one device (or row-sharded over a mesh), plus the
    call-registry capacity that sizes the filter bitmaps.

    ``mesh`` (default: ``MESH_SHAPE``, any axes, over every visible card,
    the CPU repeated when the index lives on the CPU, or in a gang this
    process's device once per position it holds) shards both corpora's
    rows over its ``data`` axis and replicates them over the others;
    ``INDEX_INITIAL_CAPACITY`` must divide by the ``data`` size."""

    def __init__(self, device: DeviceLike, mesh: Optional[Mesh] = None) -> None:
        self.device = resolve_device(device)
        cap = int(settings.index_initial_capacity)
        if mesh is None and settings.mesh_shape.strip():
            mesh = make_mesh(settings.mesh_shape, device=self.device)
        self.mesh = mesh
        if mesh is not None:
            data_rows = sharded_mod.data_shards(mesh)
            if cap % max(data_rows, 1):
                raise ValueError(
                    f"INDEX_INITIAL_CAPACITY {cap} must divide the mesh's "
                    f"data axis ({data_rows})"
                )
        kwargs = dict(
            dim=int(settings.embeddings_dim),
            lex_dim=int(settings.lexical_dim),
            tech_slots=int(settings.tech_hash_slots),
            capacity=cap,
            device=self.device,
            emb_dtype=settings.index_embedding_dtype,
            mesh=mesh,
        )
        self.chunks = CorpusIndex("chunks", **kwargs)
        self.artifacts = CorpusIndex("artifact_chunks", **kwargs)
        if _multiprocess():
            # the op-log is a valid serialization of the leader's device
            # order only if no two leader threads interleave their
            # emit -> enqueue windows: under a gang both corpora share ONE
            # lock (single process keeps one each, for more concurrency)
            self.artifacts.lock = self.chunks.lock
        self.call_capacity = 256
        from .prewarm import GrowthPrewarmer

        # plans the next capacity of a corpus that nears its own and starts
        # the background migration toward it (core/prewarm.py)
        self.prewarmer = GrowthPrewarmer(self)
        for corpus in (self.chunks, self.artifacts):
            corpus._on_insert = self.prewarmer.maybe_prewarm
            corpus._grow_planner = self.prewarmer.growth_cap

    def cancel_migrations(self) -> None:
        """Cancel both corpora's background growth: a migration's thread
        holds its corpus and both buffer sets until a swap or a cancel, so
        an index that is dropped must cancel it to free them."""
        for corpus in (self.chunks, self.artifacts):
            with corpus.lock:
                corpus._cancel_migration_locked()

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
            if _multiprocess():
                raise RuntimeError(
                    "multi-process serving dispatches through "
                    "query_both_packed_async (mirrored over the op-log); the "
                    "unpacked dual-corpus path is single-process only")
            chunk_mode, ivf_dense = self._resolve_chunk_dense(
                chunk_mode, dense_enabled, q_emb, allowed_calls, date_min,
                date_max, chunk_ks[0])
            put = self.chunks._put
            queries = (
                put(q_emb if dense_enabled
                    else np.zeros((batch, self.chunks.dim), np.float32),
                    torch.float32),
                put(chunk_q_lex, torch.float32),
                put(artifact_q_lex, torch.float32),
                put(q_tech, torch.int32),
                put(allowed_calls, torch.bool),
                put(date_min, torch.int32),
                put(date_max, torch.int32),
            )
            chunk_ks = _clamp_ks(chunk_ks, self.chunks.capacity)
            artifact_ks = _clamp_ks(artifact_ks, self.artifacts.capacity)
            if self.mesh is not None:
                q_emb_t, c_lex, a_lex, *rest = queries
                chunks_raw, artifacts_raw = (
                    sharded_mod.single_lanes(
                        corpus, q_emb_t, q_lex, *rest, k_dense=ks[0],
                        k_lex=ks[1], k_tech=ks[2], dense_mode=mode,
                        dense_enabled=dense_enabled)
                    for corpus, q_lex, ks, mode in (
                        (self.chunks, c_lex, chunk_ks, chunk_mode),
                        (self.artifacts, a_lex, artifact_ks, artifact_mode)))
            else:
                chunks_raw, artifacts_raw = dual_corpus_retrieve(
                    self.chunks.device_arrays(),
                    self.artifacts.device_arrays(),
                    *queries,
                    chunk_ks=chunk_ks, artifact_ks=artifact_ks,
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

    def query_both_packed(
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
    ) -> Tuple[Dict, Dict]:
        """The /retrieve hot path, blocking form: dispatch + collect."""
        return self.collect_packed(self.query_both_packed_async(
            q_emb, q_lex_feats, q_tech, allowed_calls, date_min, date_max,
            chunk_ks=chunk_ks, artifact_ks=artifact_ks,
            chunk_mode=chunk_mode, artifact_mode=artifact_mode,
            recall_target=recall_target,
        ))

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
        copy is enqueued into pinned memory behind the program (with
        ``READBACK_PREFETCH_ENABLED`` off, ``collect_packed`` requests it),
        and ``collect_packed`` waits for it. A chunks ``"ivf"`` plan runs the
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
            ready = self._merge_cold_ready(
                ready, q_emb, q_lex_feats, q_tech, allowed_calls, date_min,
                date_max, chunk_ks, artifact_ks, chunk_mode, artifact_mode,
                batch)
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
        trace = None
        if events.enabled() and self.mesh is None:
            trace = dict(batch=batch, chunk_mode=chunk_mode,
                         artifact_mode=artifact_mode, dense=dense_enabled,
                         width=int(q_tech.shape[1]),
                         nonzero=int(np.count_nonzero(q_tech)))
            if self.device.type == "cuda":
                trace["start"] = torch.cuda.Event(enable_timing=True)
                trace["start"].record(torch.cuda.current_stream(self.device))
        # uploads that reference no corpus buffer are staged outside the
        # locks: the packed batch, and the IVF dispatch's inputs
        d_packed = _stage(packed, self.device)
        ivf_inputs = (q_emb, allowed_calls, date_min, date_max)
        if dense_enabled and chunk_mode == "ivf":
            ivf_inputs = tuple(_stage(a, self.device) for a in ivf_inputs)
        with self.chunks.lock, self.artifacts.lock:
            chunk_mode, ivf_dense = self._resolve_chunk_dense(
                chunk_mode, dense_enabled, *ivf_inputs, chunk_ks[0])
            # device RRF needs every lane in the packed program and every
            # candidate in the hot tier: with the IVF dense lane in its own
            # dispatch ("none"), or a cold tier holding rows (its lanes
            # merge on the host before RRF), the caller merges on the host
            fuse_rrf = bool(
                fuse_rrf and chunk_mode != "none"
                and not self.chunks.cold_rows and not self.artifacts.cold_rows)
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
            statics = dict(
                batch=batch, emb_dim=sig.emb_dim, q_feats=F,
                tech_q=sig.tech_q, n_calls=sig.n_calls,
                chunk_ks=sig.chunk_ks, artifact_ks=sig.artifact_ks,
                chunk_mode=chunk_mode, artifact_mode=artifact_mode,
                dense_enabled=dense_enabled, fuse_rrf=sig.fuse_rrf,
            )
            k1_counts = None
            if self.mesh is not None:
                if _oplog is not None:
                    _oplog.emit("query_packed",
                                {"corpus": "chunks", "statics": statics},
                                {"packed": packed})
                flat = sharded_mod.packed_query(
                    self.chunks, self.artifacts, d_packed, **statics)
            else:
                if trace is not None and self.device.type == "cuda":
                    # K1's own counts, copied in stream order around the
                    # program (and the cold tier's scans), under the locks
                    k1_counts = fused_scan.counters(self.device).clone()
                flat = dual_corpus_retrieve_packed(
                    self.chunks.device_arrays(), self.artifacts.device_arrays(),
                    d_packed, **statics)
            # snapshot the host mirrors while the positions are current
            chunk_snap = (self.chunks.h_ids, self.chunks.count)
            artifact_snap = (self.artifacts.h_ids, self.artifacts.count)
            # cold tier: enqueue the block scans behind the hot program,
            # still under the locks (a cold-tier writer waits for the block
            # copies before it touches the rows)
            cold_chunks, cold_artifacts = [], []
            if self.chunks.cold_rows or self.artifacts.cold_rows:
                # the queries as the hot program unpacked them (f16 on the
                # wire), so both tiers score with the same values
                q = _unpack(
                    d_packed, batch=batch, dim=sig.emb_dim, q_feats=F,
                    tech_q=sig.tech_q, n_calls=sig.n_calls)
                cold_chunks, cold_artifacts = self._dispatch_cold_locked(
                    q["q_emb"] if dense_enabled else None,
                    _densify(q["cb"], q["cv"], self.chunks.lex_dim),
                    _densify(q["ab"], q["av"], self.artifacts.lex_dim),
                    q["tech"], q["allowed"], q["dmin"], q["dmax"],
                    chunk_ks, artifact_ks, chunk_mode, artifact_mode)
            if k1_counts is not None:
                trace["k1_counts"] = _to_pinned(torch.stack(
                    [k1_counts, fused_scan.counters(self.device)]))
        # READBACK_PREFETCH_ENABLED: the readback rides behind the program
        # from here (on CUDA the pinned D2H copies); off, the dispatch keeps
        # the program's output and ``collect_packed`` requests the readback
        flat_host = flat_out = None
        if not settings.readback_prefetch_enabled:
            flat_out = flat
        elif flat.is_cuda:
            flat_host = _to_pinned(flat)
            if ivf_dense is not None:
                ivf_dense = tuple(_to_pinned(t) for t in ivf_dense)
        else:
            flat_host = flat
        done = None
        if flat.is_cuda:
            done = torch.cuda.Event(enable_timing=trace is not None)
            done.record(torch.cuda.current_stream(flat.device))
        self.prewarmer.note_batch(batch)
        return PackedDispatch(trace=trace,
            flat_host=flat_host, flat_out=flat_out, done=done, sig=sig,
            served_chunk_mode="ivf" if chunk_mode == "none" else chunk_mode,
            extra_dense=ivf_dense, chunk_snap=chunk_snap,
            artifact_snap=artifact_snap, batch=batch,
            cold_chunks=cold_chunks, cold_artifacts=cold_artifacts,
            cold_ks=(chunk_ks, artifact_ks),
        )

    def _dispatch_cold_locked(
        self, q_emb, chunk_q_lex, artifact_q_lex, q_tech, allowed_calls,
        date_min, date_max, chunk_ks, artifact_ks, chunk_mode, artifact_mode,
    ) -> Tuple[list, list]:
        """Enqueue cold-tier block scans for corpora with spilled rows
        (caller holds both corpus locks). The queries are tensors on the
        index's device, the very ones the hot program scored with, and the
        lexical vectors carry the corpus-wide df and live count (hot +
        cold): a cold row scores exactly as it would in the hot tier."""
        out: List[list] = []
        for corpus, q_lex, ks, mode in (
            (self.chunks, chunk_q_lex, chunk_ks, chunk_mode),
            (self.artifacts, artifact_q_lex, artifact_ks, artifact_mode),
        ):
            if not corpus.cold_rows:
                out.append([])
                continue
            out.append(corpus.cold.dispatch(
                q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
                ks=ks, dense_mode=mode,
                block_rows=int(settings.cold_block_rows),
            ))
        return out[0], out[1]

    def _merge_cold(self, rects, cold_chunks, cold_artifacts, chunk_ks,
                    artifact_ks, batch):
        """Lane-merge dispatched cold blocks into the hot tier's rectangular
        lanes (the dispatch's event has been waited for)."""
        merged = []
        for corpus, rect, blocks, ks in (
            (self.chunks, rects[0], cold_chunks, chunk_ks),
            (self.artifacts, rects[1], cold_artifacts, artifact_ks),
        ):
            if blocks:
                rect = merge_rect_lanes(
                    rect, collect_cold(corpus, blocks, batch),
                    {"dense": ks[0], "lex": ks[1], "tech": ks[2]})
            merged.append(rect)
        return tuple(merged)

    def _merge_cold_ready(
        self, ready, q_emb, q_lex_feats, q_tech, allowed_calls, date_min,
        date_max, chunk_ks, artifact_ks, chunk_mode, artifact_mode, batch,
    ):
        """Synchronous cold merge for the blocking cold-start path, which
        scores the hot rows with f32 queries from the host: so here."""
        if not self.chunks.cold_rows and not self.artifacts.cold_rows:
            return ready
        put = self.chunks._put
        with self.chunks.lock, self.artifacts.lock:
            q_lex = [
                put(np.stack([_dense_query_vector(f, corpus)
                              for f in q_lex_feats]), torch.float32)
                for corpus in (self.chunks, self.artifacts)]
            cold_chunks, cold_artifacts = self._dispatch_cold_locked(
                put(q_emb, torch.float32) if q_emb is not None else None,
                *q_lex, put(q_tech, torch.int32),
                put(allowed_calls, torch.bool),
                put(np.asarray(date_min, np.int32), torch.int32),
                put(np.asarray(date_max, np.int32), torch.int32),
                chunk_ks, artifact_ks, chunk_mode, artifact_mode)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._merge_cold(ready, cold_chunks, cold_artifacts,
                                chunk_ks, artifact_ks, batch)

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
        if disp.trace is not None:
            w0 = time.perf_counter()
        if disp.flat_out is not None:
            # dispatched with READBACK_PREFETCH_ENABLED off: the readback
            # is requested here, as the JAX package's collect requests it
            flat, disp.flat_out = disp.flat_out, None
            if flat.is_cuda:
                extra = list(disp.extra_dense or ())
                flat, *extra = _read_back([flat] + extra, disp.done)
                if disp.extra_dense is not None:
                    disp.extra_dense = tuple(extra)
            disp.flat_host = flat
        elif disp.done is not None:
            disp.done.synchronize()
        if disp.trace is not None:
            _record_dispatch(disp, time.perf_counter() - w0)
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
        rects = (
            self.chunks.postprocess_lanes(chunks_np, disp.batch, *disp.chunk_snap),
            self.artifacts.postprocess_lanes(
                artifacts_np, disp.batch, *disp.artifact_snap),
        )
        if disp.cold_chunks or disp.cold_artifacts:
            rects = self._merge_cold(rects, disp.cold_chunks,
                                     disp.cold_artifacts, *disp.cold_ks,
                                     disp.batch)
        return rects


def _record_dispatch(disp: PackedDispatch, wait_s: float) -> None:
    """The ring's ``index.dispatch`` event of a dispatch whose output is
    on the host: ``wait_s``, the seconds ``collect_packed`` blocked for
    it; on CUDA ``device_s``, the stream's seconds from before the packed
    batch's upload to the readback (the program, and any wait in it for
    the host to enqueue the rest); the dispatch's batch, plan modes, dense
    flag, tech width and nonzero tech columns; on CUDA K1's own count of the
    lexical pieces it issued a K slab over the program's launches
    (``lex_pieces``) and their route (``lex_route``: ``fp16``, ``bf16`` or
    ``mixed``), read with the dispatch's readback."""
    fields = dict(disp.trace)
    start = fields.pop("start", None)
    if start is not None:
        fields["device_s"] = round(start.elapsed_time(disp.done) / 1e3, 6)
    k1_counts = fields.pop("k1_counts", None)
    if k1_counts is not None:
        before, after = k1_counts.tolist()
        bf16, fp16, pieces, slabs = (a - b for a, b in zip(after, before))
        if slabs:
            fields["lex_pieces"] = pieces / slabs
            fields["lex_route"] = "mixed" if bf16 and fp16 else "bf16" if bf16 else "fp16"
    events.record("index.dispatch", wait_s=round(wait_s, 6), **fields)


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
        if _index is not None:
            _index.cancel_migrations()
        _index = None
    # the active lexical vocab belongs to the (store, index) pair; a fresh
    # index must not inherit a previous corpus's head layout
    from ..ingest import featurize

    featurize.set_active_vocab(None, 0)
