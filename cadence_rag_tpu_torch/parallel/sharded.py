"""Corpus-sharded retrieval over the mesh's ``data`` axis.

Counterpart of ``cadence_rag_tpu/parallel/sharded.py``. When the corpus
outgrows one card its rows shard across the mesh in contiguous blocks
(shard ``i`` owns rows ``[i*N/d, (i+1)*N/d)``); each shard scans its block
with the same lane code as the unsharded index, its top-k candidates get
global positions (``local + shard*rows``), and one gather of every shard's
candidates is merged by a top-k over them: O(shards * k) bytes cross
devices or processes, never a score plane. Queries are replicated.

The merge keeps ``lax.top_k``'s order: candidates are concatenated in shard
order and ranked value first, lowest concatenated index first among equal
values, so ties go to the lowest global row (each shard's list is already
in that order). K1's candidates and the ``ann`` lane's answer are the
unsharded index's when each shard's rows are a multiple of K1's 1024-row
block: its strided 8-row groups are then the unsharded groups. On CUDA a
shard of another size raises instead of answering differently.

Shards are the mesh's ``data`` positions; a ``model`` axis replicates
them (each data shard's positions along ``model`` hold the same rows), and
a process computes each data shard it holds once (``Mesh.local_shards``),
so the answers are those of the same ``data:N`` mesh without the model
axis, bit for bit.

The gather: in one process, a concatenation on the first shard's device;
across processes (the op-log gang, ``parallel/oplog.py``), one
``torch.distributed`` all-gather per dispatch of every lane's candidates
packed into one int64 block (``mesh.all_gather``), of which one copy of
each shard is kept: its owner's, the lowest process holding it.

- ``sharded_dense_topk`` / ``sharded_multi_lane``: the JAX module's API, on
  global row arrays that this function blocks over the mesh; each shard
  runs the exact lanes (``ops/topk``, ``ops/lexical``, ``ops/techlane``;
  on CUDA the tech lane is kernel K3);
- ``corpus_lanes`` / ``packed_query`` / ``ivf_lanes``: the index's
  dispatch over a ``CorpusIndex``'s own shards (``core/index.py``): the
  packed program's lanes (K1 and K3 on CUDA), then the unsharded program's
  own RRF and flatten, and the IVF dense lane.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.fused import _lanes_one_corpus
from ..kernels import build
from ..ops.fused_scan import BLOCK_ROWS
from ..ops.lexical import lexical_topk
from ..ops.masks import filter_mask
from ..ops.tech_keys import tech_topk_keys
from ..ops.topk import (
    LOW_MASK, dense_scores, masked_topk_exact, sortable_i32,
    topk_lowest_index_first,
)
from . import mesh as mesh_mod

SHARD_ROWS_RULE = (
    "{name}: each shard holds {rows} rows; on CUDA a shard's rows must be a "
    "multiple of K1's {block}-row block, so that its strided 8-row groups "
    "are the unsharded index's (the index rounds its shards up to it)")

# K1 and K3 launches of the index path, per corpus and shard, added by the
# kernels' wrappers where they launch (``kernels/build.count_launch``):
# {(corpus, shard): Counter({"fused_scan": n, "tech_topk": n})}
launches_by_shard: Dict[Tuple[str, int], collections.Counter] = (
    collections.defaultdict(collections.Counter))

Part = Dict[str, Tuple[torch.Tensor, ...]]


def data_shards(mesh, axis: str = "data") -> int:
    """The mesh's row shards: the size of ``axis``. Every other axis (the
    ``model`` axis) replicates the rows."""
    return mesh.axis_size(axis)


# -- gather and merge -----------------------------------------------------------
def _cols(t: torch.Tensor) -> torch.Tensor:
    """(B, w) f32 / int32 / int64 -> (B, w) int64 carrying the same bits."""
    if t.dtype == torch.float32:
        t = t.contiguous().view(torch.int32)
    return t.to(torch.int64)


def _uncols(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return t.to(torch.int32).view(torch.float32)
    return t.to(dtype)


def gather_parts(local: Sequence[Tuple[int, Part]], mesh) -> List[Part]:
    """Every data shard's part, in shard order: this process's own, plus
    (in a gang) the others' from one all-gather of one packed int64 block.
    A shard held by several processes (replicas along ``model``) is taken
    from its owner, the lowest of them; a process that holds fewer shards
    than another pads its block."""
    local = sorted(local, key=lambda sp: sp[0])
    n_shards = mesh.n_shards if mesh is not None else 1
    if mesh_mod.gang_world() == 1:
        if [s for s, _p in local] != list(range(n_shards)):
            raise RuntimeError(
                f"shards {[s for s, _p in local]} of {n_shards}: a process "
                "outside a gang must hold every shard")
        return [p for _s, p in local]
    held = [mesh.held_shards(r) for r in range(mesh_mod.gang_world())]
    if [s for s, _p in local] != held[mesh.rank]:
        raise RuntimeError(f"shards {[s for s, _p in local]}: this process "
                           f"holds {held[mesh.rank]}")
    spec = [(key, [(t.dtype, t.shape[1]) for t in tensors])
            for key, tensors in local[0][1].items()]
    cols = [torch.cat([_cols(t) for key, _ in spec for t in part[key]], dim=1)
            for _s, part in local]
    width = cols[0].shape[1]
    pad = max(map(len, held)) - len(local)
    if pad:
        cols.append(cols[0].new_zeros((cols[0].shape[0], pad * width)))
    gathered = mesh_mod.all_gather(torch.cat(cols, dim=1))
    parts: List[Part] = []
    for s in range(n_shards):
        owner = mesh.shard_holders(s)[0]
        off = held[owner].index(s) * width
        got = gathered[owner]
        part = {}
        for key, fields in spec:
            tensors = []
            for dtype, w in fields:
                tensors.append(_uncols(got[:, off:off + w], dtype))
                off += w
            part[key] = tuple(tensors)
        parts.append(part)
    return parts


def _merge_gathered(
    vals: Sequence[torch.Tensor], pos: Sequence[torch.Tensor], k: int,
    tie: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over every shard's (B, k_s) candidates (global positions), in
    shard order. Equal values go to the lowest concatenated index, or with
    ``tie`` (per-candidate int64 keys, lowest first) to the lowest key."""
    all_vals = torch.cat(list(vals), dim=1)
    all_pos = torch.cat(list(pos), dim=1)
    k = min(k, all_vals.shape[1])
    if tie is None:
        top_vals, idx = topk_lowest_index_first(all_vals, k)
    else:
        keys = (sortable_i32(all_vals.float()).to(torch.int64) << 32) | (
            LOW_MASK - torch.cat(list(tie), dim=1))
        _, idx = torch.topk(keys, k, dim=1, largest=True, sorted=True)
        top_vals = torch.gather(all_vals, 1, idx)
    return top_vals, torch.gather(all_pos, 1, idx)


def merge_parts(parts: Sequence[Part], ks: Dict[str, int]) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{lane: merged (vals, positions)} for each lane of ``ks``."""
    out = {}
    for lane, k in ks.items():
        if lane not in parts[0]:
            continue
        fields = [p[lane] for p in parts]
        tie = [f[2] for f in fields] if len(fields[0]) > 2 else None
        out[lane] = _merge_gathered([f[0] for f in fields], [f[1] for f in fields],
                                    k, tie)
    return out


def _globalize(lanes, row0: int, device) -> Part:
    return {lane: (v.to(device), (p.to(torch.int64) + row0).to(device))
            for lane, (v, p) in lanes.items()}


class _OnDevice:
    """Copies of the replicated query tensors, one per device."""

    def __init__(self, **tensors):
        self._src = tensors
        self._by_dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def on(self, device: torch.device) -> Dict[str, torch.Tensor]:
        if device not in self._by_dev:
            self._by_dev[device] = {k: (v.to(device) if v is not None else None)
                                    for k, v in self._src.items()}
        return self._by_dev[device]


# -- the JAX module's API ----------------------------------------------------------
def _local_all_lanes(emb, lex_w, tech, call_idx, started, has_emb,
                     q_emb, q_lex, q_tech, allowed, date_min, date_max,
                     *, k_dense, k_lex, k_tech) -> Part:
    rows = emb.shape[0]
    mask = filter_mask(call_idx, started, allowed, date_min, date_max)
    # the dense lane requires a present embedding (`embedding IS NOT NULL`)
    return {
        "dense": masked_topk_exact(dense_scores(q_emb, emb),
                                   mask & has_emb[None, :], min(k_dense, rows)),
        "lex": lexical_topk(q_lex, lex_w, mask, min(k_lex, rows)),
        "tech": tech_topk_keys(tech, started, q_tech, mask, min(k_tech, rows)),
    }


def _blocks(mesh, rows_arrays, axis):
    d = data_shards(mesh, axis)
    n = rows_arrays[0].shape[0]
    if n % d:
        raise ValueError(f"{n} rows do not divide the mesh's {axis} axis ({d})")
    rows = n // d
    for s, dev in mesh.local_shards().items():
        yield s, rows, tuple(a[s * rows:(s + 1) * rows].to(dev) for a in rows_arrays)


def _merge_device(mesh) -> torch.device:
    return next(iter(mesh.local_shards().values()))


def sharded_multi_lane(
    mesh, emb, lex_w, tech, call_idx, started_sec, has_emb,
    q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
    *, k_dense: int, k_lex: int, k_tech: int, axis: str = "data",
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """All three lanes over a corpus blocked on ``axis``: each shard runs the
    exact lanes, the per-lane candidates are gathered and re-selected.
    -> {"dense"|"lex"|"tech": (scores, GLOBAL positions)} on this process's
    first device. In a gang every process passes the same global arrays
    and keeps only its own blocks."""
    queries = _OnDevice(q_emb=q_emb, q_lex=q_lex, q_tech=q_tech,
                        allowed=allowed_calls, dmin=date_min, dmax=date_max)
    merge_dev = _merge_device(mesh)
    local = []
    for s, rows, arrays in _blocks(
            mesh, (emb, lex_w, tech, call_idx, started_sec, has_emb), axis):
        q = queries.on(arrays[0].device)
        part = _local_all_lanes(
            *arrays, q["q_emb"], q["q_lex"], q["q_tech"], q["allowed"],
            q["dmin"], q["dmax"], k_dense=k_dense, k_lex=k_lex, k_tech=k_tech)
        local.append((s, _globalize(part, s * rows, merge_dev)))
    parts = gather_parts(local, mesh)
    return merge_parts(parts, {"dense": k_dense, "lex": k_lex, "tech": k_tech})


def sharded_dense_topk(
    mesh, emb, call_idx, started_sec, q_emb, allowed_calls, date_min,
    date_max, k: int, axis: str = "data", has_emb=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of the exact dense lane over a corpus blocked on
    ``axis`` -> (scores (B, k), global positions (B, k)). ``has_emb`` marks
    rows with an embedding (None: every row)."""
    if has_emb is None:
        has_emb = torch.ones(emb.shape[0], dtype=torch.bool, device=emb.device)
    queries = _OnDevice(q_emb=q_emb, allowed=allowed_calls, dmin=date_min,
                        dmax=date_max)
    merge_dev = _merge_device(mesh)
    local = []
    for s, rows, (e, c, st, h) in _blocks(mesh, (emb, call_idx, started_sec, has_emb),
                                          axis):
        q = queries.on(e.device)
        mask = filter_mask(c, st, q["allowed"], q["dmin"], q["dmax"]) & h[None, :]
        part = {"dense": masked_topk_exact(dense_scores(q["q_emb"], e), mask,
                                           min(k, rows))}
        local.append((s, _globalize(part, s * rows, merge_dev)))
    parts = gather_parts(local, mesh)
    return merge_parts(parts, {"dense": k})["dense"]


# -- the index's dispatch ------------------------------------------------------------
def _check_shard_rows(name: str, device: torch.device, rows: int) -> None:
    if device.type == "cuda" and rows % BLOCK_ROWS:
        raise ValueError(SHARD_ROWS_RULE.format(name=name, rows=rows,
                                                block=BLOCK_ROWS))


def corpus_lanes(
    name: str, shards: Sequence[Tuple[int, Sequence[torch.Tensor]]],
    shard_rows: int, queries: _OnDevice, merge_device: torch.device,
    *, k_dense: int, k_lex: int, k_tech: int, dense_mode: str,
    dense_enabled: bool,
) -> List[Tuple[int, Part]]:
    """One corpus's lanes (``ops/fused._lanes_one_corpus``: K1 and K3 on
    CUDA) on each of this process's shards -> [(shard, lanes with global
    positions on ``merge_device``)]; ``queries`` holds q_emb, q_lex, q_tech,
    allowed, dmin, dmax."""
    out = []
    for s, arrays in shards:
        dev = arrays[0].device
        _check_shard_rows(name, dev, shard_rows)
        q = queries.on(dev)
        token = build.shard_tally.set(launches_by_shard[(name, s)])
        try:
            lanes = _lanes_one_corpus(
                *arrays, q["q_emb"], q["q_lex"], q["q_tech"], q["allowed"],
                q["dmin"], q["dmax"], k_dense=min(k_dense, shard_rows),
                k_lex=min(k_lex, shard_rows), k_tech=min(k_tech, shard_rows),
                dense_mode=dense_mode, dense_enabled=dense_enabled)
        finally:
            build.shard_tally.reset(token)
        out.append((s, _globalize(lanes, s * shard_rows, merge_device)))
    return out


def _ks(ks: Tuple[int, int, int]) -> Dict[str, int]:
    return {"lex": ks[1], "tech": ks[2], "dense": ks[0]}


def packed_lanes(
    chunks, artifacts, packed: torch.Tensor, *, batch: int, emb_dim: int,
    q_feats: int, tech_q: int, n_calls: int,
    chunk_ks: Tuple[int, int, int], artifact_ks: Tuple[int, int, int],
    chunk_mode: str, artifact_mode: str, dense_enabled: bool,
) -> List[Tuple[int, Part]]:
    """The first half of ``packed_query``: unpack on ``packed``'s device and
    run both corpora's lanes on each of this process's shards -> [(shard,
    {"c/<lane>" | "a/<lane>": (vals, global positions)})]."""
    from ..ops.pack import _densify, _unpack

    dev = packed.device
    q = _unpack(packed, batch=batch, dim=emb_dim, q_feats=q_feats,
                tech_q=tech_q, n_calls=n_calls)
    q_emb = q["q_emb"]
    if not dense_enabled:
        q_emb = torch.zeros((batch, chunks.dim), dtype=torch.float32, device=dev)
    elif emb_dim != chunks.dim:
        raise ValueError(f"query dim {emb_dim} != corpus dim {chunks.dim}")
    common = dict(q_emb=q_emb, q_tech=q["tech"], allowed=q["allowed"],
                  dmin=q["dmin"], dmax=q["dmax"])
    local: Dict[int, Part] = collections.defaultdict(dict)
    for tag, corpus, q_lex, ks, mode in (
        ("c", chunks, _densify(q["cb"], q["cv"], chunks.lex_dim), chunk_ks, chunk_mode),
        ("a", artifacts, _densify(q["ab"], q["av"], artifacts.lex_dim),
         artifact_ks, artifact_mode),
    ):
        for s, lanes in corpus_lanes(
                corpus.name, corpus.local_shards(), corpus.shard_rows,
                _OnDevice(q_lex=q_lex, **common), dev,
                k_dense=ks[0], k_lex=ks[1], k_tech=ks[2], dense_mode=mode,
                dense_enabled=dense_enabled):
            local[s].update({f"{tag}/{lane}": v for lane, v in lanes.items()})
    return sorted(local.items())


def packed_merge(
    local: Sequence[Tuple[int, Part]], mesh, *,
    chunk_ks: Tuple[int, int, int], artifact_ks: Tuple[int, int, int],
    fuse_rrf: bool,
) -> torch.Tensor:
    """The second half: one gather of both corpora's candidates, each lane
    merged to its k, then the unsharded program's own device RRF and
    flatten -> the flat output in the unsharded layout."""
    from ..ops.fusion import rrf_fuse_lanes_device
    from ..ops.pack import LANE_ORDER, _flatten_lanes, _flatten_merged

    parts = gather_parts(local, mesh)
    outs = []
    for tag, ks in (("c", chunk_ks), ("a", artifact_ks)):
        mine = [{key[2:]: v for key, v in p.items() if key.startswith(tag + "/")}
                for p in parts]
        outs.append(merge_parts(mine, _ks(ks)))
    if fuse_rrf:
        return _flatten_merged(rrf_fuse_lanes_device(outs[0], LANE_ORDER),
                               rrf_fuse_lanes_device(outs[1], LANE_ORDER))
    return _flatten_lanes(outs[0], outs[1])


def packed_query(
    chunks, artifacts, packed: torch.Tensor, *, batch: int, emb_dim: int,
    q_feats: int, tech_q: int, n_calls: int,
    chunk_ks: Tuple[int, int, int], artifact_ks: Tuple[int, int, int],
    chunk_mode: str, artifact_mode: str, dense_enabled: bool, fuse_rrf: bool,
) -> torch.Tensor:
    """``ops/pack.dual_corpus_retrieve_packed`` over two sharded corpora
    (``CorpusIndex``es): each shard's lanes (``packed_lanes``), then the
    merge, RRF and flatten (``packed_merge``): the flat output is the
    unsharded layout, which ``collect_packed`` reads unchanged."""
    local = packed_lanes(
        chunks, artifacts, packed, batch=batch, emb_dim=emb_dim,
        q_feats=q_feats, tech_q=tech_q, n_calls=n_calls, chunk_ks=chunk_ks,
        artifact_ks=artifact_ks, chunk_mode=chunk_mode,
        artifact_mode=artifact_mode, dense_enabled=dense_enabled)
    return packed_merge(local, chunks.mesh, chunk_ks=chunk_ks,
                        artifact_ks=artifact_ks, fuse_rrf=fuse_rrf)


def single_lanes(
    corpus, q_emb, q_lex, q_tech, allowed, dmin, dmax, *, k_dense: int,
    k_lex: int, k_tech: int, dense_mode: str, dense_enabled: bool,
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """One sharded corpus's three lanes (the cold-start path), merged."""
    local = corpus_lanes(
        corpus.name, corpus.local_shards(), corpus.shard_rows,
        _OnDevice(q_emb=q_emb, q_lex=q_lex, q_tech=q_tech, allowed=allowed,
                  dmin=dmin, dmax=dmax), corpus.device,
        k_dense=k_dense, k_lex=k_lex, k_tech=k_tech, dense_mode=dense_mode,
        dense_enabled=dense_enabled)
    return merge_parts(gather_parts(local, corpus.mesh),
                       {"lex": k_lex, "tech": k_tech, "dense": k_dense})


def ivf_lanes(
    corpus, state, q_emb, allowed, dmin, dmax, *, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IVF dense lane over a sharded corpus: every shard probes the same
    clusters with the unsharded candidate layout and scores only the
    candidates it owns (the others masked), so each row's score is the
    unsharded gather's; the merge breaks ties by candidate index, as the
    unsharded top-k does. -> (scores (B, k), global positions, -1 = none)."""
    from ..ops.ivf import ivf_shard_topk

    queries = _OnDevice(q_emb=q_emb, allowed=allowed, dmin=dmin, dmax=dmax,
                        centroids=state.centroids, buckets=state.buckets,
                        overflow=state.overflow)
    local = []
    for s, arrays in corpus.local_shards():
        emb, _lex, _tech, call_idx, started, has_emb = arrays
        q = queries.on(emb.device)
        mask = filter_mask(call_idx, started, q["allowed"], q["dmin"],
                           q["dmax"]) & has_emb[None, :]
        vals, pos, idx = ivf_shard_topk(
            q["q_emb"], emb, q["centroids"], q["buckets"], q["overflow"], mask,
            k=k, nprobe=state.nprobe, row0=s * corpus.shard_rows)
        local.append((s, {"dense": tuple(t.to(corpus.device) for t in (vals, pos, idx))}))
    return merge_parts(gather_parts(local, corpus.mesh), {"dense": k})["dense"]
