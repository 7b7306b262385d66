"""Packed query transfer: one byte buffer in, one flat int32 buffer out.

Counterpart of ``cadence_rag_tpu/ops/pack.py``. The host packs a batch into
one uint8 buffer (q_emb as f16, each corpus's lexical query as sparse
(uint16 bucket, f16 value) pairs, tech hashes i32, the call bitmap u8,
date bounds i32); the device program unpacks it, densifies the lexical
queries by scatter-add, runs both corpora's lanes and returns ONE (B, total)
int32 buffer — per-lane (scores bitcast, positions) blocks, or the
device-fused RRF blocks. ``pack_queries``, ``sparse_lex_rows``,
``lane_layout`` and the ``unflatten_*`` host inverses are numpy and
byte-identical to the JAX package's; the layout is ``pack.py:41-164``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cadence_rag_tpu.ops.hashing import LEX_QUANT_SCALE

from .fused import dual_corpus_retrieve
from .fusion import rrf_fuse_lanes_device

# fixed sparse width for query lexical features (word + trigram buckets)
DEFAULT_F = 256

# flat-output lane order per corpus (the insertion order of
# fused._lanes_one_corpus)
LANE_ORDER = ("lex", "tech", "dense")


def lane_layout(
    chunk_ks: Tuple[int, int, int],
    artifact_ks: Tuple[int, int, int],
    chunk_mode: str,
    artifact_mode: str,
    dense_enabled: bool,
):
    """[(corpus, lane, k)] in flat-buffer column order (each lane: k score
    cols + k position cols); dense is present iff it ran in-program."""
    layout = []
    for corpus, ks, mode in (
        ("chunks", chunk_ks, chunk_mode),
        ("artifacts", artifact_ks, artifact_mode),
    ):
        layout.append((corpus, "lex", ks[1]))
        layout.append((corpus, "tech", ks[2]))
        if dense_enabled and mode != "none":
            layout.append((corpus, "dense", ks[0]))
    return layout


def _flatten_lanes(chunks_out, artifacts_out) -> torch.Tensor:
    """All lane outputs -> ONE (B, total) int32 tensor (f32 scores bitcast)."""
    parts = []
    for out in (chunks_out, artifacts_out):
        for name in LANE_ORDER:
            if name not in out:
                continue
            scores, pos = out[name]
            parts.append(scores.float().contiguous().view(torch.int32))
            parts.append(pos.to(torch.int32))
    return torch.cat(parts, dim=1)


def unflatten_lanes(
    flat: np.ndarray, *,
    chunk_ks: Tuple[int, int, int], artifact_ks: Tuple[int, int, int],
    chunk_mode: str, artifact_mode: str, dense_enabled: bool,
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]],
           Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """Host inverse of ``_flatten_lanes``: per-corpus {lane: (f32 scores,
    i32 positions)} views."""
    flat = np.ascontiguousarray(flat)
    flat_f = flat.view(np.float32)
    chunks: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    artifacts: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    off = 0
    for corpus, lane, k in lane_layout(
        chunk_ks, artifact_ks, chunk_mode, artifact_mode, dense_enabled
    ):
        scores = flat_f[:, off:off + k]
        pos = flat[:, off + k:off + 2 * k]
        off += 2 * k
        (chunks if corpus == "chunks" else artifacts)[lane] = (scores, pos)
    if off != flat.shape[1]:
        raise ValueError(
            f"flat lane buffer has {flat.shape[1]} cols, layout expects {off}"
        )
    return chunks, artifacts


def merged_width(ks: Tuple[int, int, int], mode: str, dense_enabled: bool) -> int:
    """Total RRF candidate slots per corpus row (sum of lane widths)."""
    k = ks[1] + ks[2]
    if dense_enabled and mode != "none":
        k += ks[0]
    return k


def _flatten_merged(chunks_merged, artifacts_merged) -> torch.Tensor:
    """Device-fused RRF outputs -> ONE (B, total) int32 tensor. Per corpus:
    [fused bitcast (B,K) | positions (B,K) | lane masks (B,K) | count (B,1)]."""
    parts = []
    for pos, fused, masks, counts in (chunks_merged, artifacts_merged):
        parts.append(fused.contiguous().view(torch.int32))
        parts.append(pos)
        parts.append(masks)
        parts.append(counts[:, None])
    return torch.cat(parts, dim=1)


def unflatten_merged(
    flat: np.ndarray, *,
    chunk_ks: Tuple[int, int, int], artifact_ks: Tuple[int, int, int],
    chunk_mode: str, artifact_mode: str, dense_enabled: bool,
) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]]:
    """Host inverse of ``_flatten_merged``: per corpus (fused f32 (B,K),
    positions i32 (B,K), masks i32 (B,K), counts (B,))."""
    flat = np.ascontiguousarray(flat)
    flat_f = flat.view(np.float32)
    out = []
    off = 0
    for ks, mode in ((chunk_ks, chunk_mode), (artifact_ks, artifact_mode)):
        K = merged_width(ks, mode, dense_enabled)
        fused = flat_f[:, off:off + K]
        pos = flat[:, off + K:off + 2 * K]
        masks = flat[:, off + 2 * K:off + 3 * K]
        counts = flat[:, off + 3 * K]
        off += 3 * K + 1
        out.append((fused, pos, masks, counts))
    if off != flat.shape[1]:
        raise ValueError(
            f"flat merged buffer has {flat.shape[1]} cols, layout expects {off}"
        )
    return out[0], out[1]


def sparse_lex_rows(
    feats_list, doc_freq: np.ndarray, n_docs: int, F: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-plan (buckets, signs, tfs) -> padded (B, F) uint16 buckets +
    (B, F) f16 values with the corpus's idf applied; rows over F keep their
    F largest-|value| features."""
    if doc_freq.shape[0] > 65536:
        raise ValueError(
            f"lexical_dim {doc_freq.shape[0]} exceeds the uint16 sparse "
            "transport (max 65536); widen the bucket dtype first"
        )
    batch = len(feats_list)
    buckets_out = np.zeros((batch, F), dtype=np.uint16)
    values_out = np.zeros((batch, F), dtype=np.float16)
    if n_docs <= 0 or batch == 0:
        return buckets_out, values_out
    sizes = np.fromiter((f[0].size for f in feats_list), dtype=np.int64,
                        count=batch)
    if not sizes.any():
        return buckets_out, values_out
    flat_b = np.concatenate([f[0] for f in feats_list])
    flat_s = np.concatenate([f[1] for f in feats_list])
    flat_t = np.concatenate([f[2] for f in feats_list])
    df = doc_freq[flat_b].astype(np.float32)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    flat_v = (flat_s * idf * flat_t) / LEX_QUANT_SCALE

    starts = np.concatenate(([0], np.cumsum(sizes)))
    if not (sizes > F).any():
        rows = np.repeat(np.arange(batch), sizes)
        cols = np.arange(int(sizes.sum())) - np.repeat(starts[:-1], sizes)
        buckets_out[rows, cols] = flat_b.astype(np.uint16)
        values_out[rows, cols] = flat_v.astype(np.float16)
        return buckets_out, values_out
    for i in range(batch):
        s, e = starts[i], starts[i + 1]
        if sizes[i] > F:
            keep = np.argsort(-np.abs(flat_v[s:e]))[:F]
            buckets_out[i] = flat_b[s:e][keep].astype(np.uint16)
            values_out[i] = flat_v[s:e][keep].astype(np.float16)
        else:
            buckets_out[i, :sizes[i]] = flat_b[s:e].astype(np.uint16)
            values_out[i, :sizes[i]] = flat_v[s:e].astype(np.float16)
    return buckets_out, values_out


def pack_queries(
    q_emb: Optional[np.ndarray],                  # (B, dim) f32 or None
    chunk_lex: Tuple[np.ndarray, np.ndarray],     # (B,F) u16, (B,F) f16
    artifact_lex: Tuple[np.ndarray, np.ndarray],
    q_tech: np.ndarray,                           # (B, Q) int32
    allowed: np.ndarray,                          # (B, C) bool
    date_min: np.ndarray,                         # (B,) int32
    date_max: np.ndarray,                         # (B,) int32
) -> np.ndarray:
    """-> one contiguous uint8 buffer (layout mirrored by ``_unpack``)."""
    batch = q_tech.shape[0]
    if q_emb is None:
        q_emb = np.zeros((batch, 1), dtype=np.float32)
    parts = [
        np.ascontiguousarray(q_emb.astype(np.float16)).view(np.uint8).ravel(),
        np.ascontiguousarray(chunk_lex[0]).view(np.uint8).ravel(),
        np.ascontiguousarray(chunk_lex[1]).view(np.uint8).ravel(),
        np.ascontiguousarray(artifact_lex[0]).view(np.uint8).ravel(),
        np.ascontiguousarray(artifact_lex[1]).view(np.uint8).ravel(),
        np.ascontiguousarray(q_tech.astype(np.int32)).view(np.uint8).ravel(),
        np.ascontiguousarray(allowed).view(np.uint8).ravel(),
        np.ascontiguousarray(date_min.astype(np.int32)).view(np.uint8).ravel(),
        np.ascontiguousarray(date_max.astype(np.int32)).view(np.uint8).ravel(),
    ]
    return np.concatenate(parts)


def _bitcast(raw: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """uint8 slice -> typed tensor. The slice may start at any byte offset
    (with dense off the q_emb slot is B*2 bytes, the call bitmap B*C), and
    ``Tensor.view(dtype)`` needs an offset aligned to the element size, so
    the bytes are copied into fresh storage first (the buffer is ~300 KB)."""
    return raw.clone().view(dtype).reshape(shape)


def _unpack(packed: torch.Tensor, *, batch, dim, q_feats, tech_q, n_calls):
    """Static-offset slicing of the ``pack_queries`` layout."""
    sizes = {
        "q_emb": batch * dim * 2,
        "cb": batch * q_feats * 2, "cv": batch * q_feats * 2,
        "ab": batch * q_feats * 2, "av": batch * q_feats * 2,
        "tech": batch * tech_q * 4,
        "allowed": batch * n_calls,
        "dmin": batch * 4, "dmax": batch * 4,
    }
    total = sum(sizes.values())
    if packed.numel() != total:
        raise ValueError(f"packed buffer has {packed.numel()} bytes, layout expects {total}")
    views = {}
    off = 0
    for name, size in sizes.items():
        views[name] = packed[off:off + size]
        off += size

    def buckets(raw):  # uint16 transport -> int64 indices
        return _bitcast(raw, (batch, q_feats), torch.int16).to(torch.int64) & 0xFFFF

    return {
        "q_emb": _bitcast(views["q_emb"], (batch, dim), torch.float16).float(),
        "cb": buckets(views["cb"]),
        "cv": _bitcast(views["cv"], (batch, q_feats), torch.float16).float(),
        "ab": buckets(views["ab"]),
        "av": _bitcast(views["av"], (batch, q_feats), torch.float16).float(),
        "tech": _bitcast(views["tech"], (batch, tech_q), torch.int32),
        "allowed": views["allowed"].reshape(batch, n_calls) != 0,
        "dmin": _bitcast(views["dmin"], (batch,), torch.int32),
        "dmax": _bitcast(views["dmax"], (batch,), torch.int32),
    }


def _densify(buckets: torch.Tensor, values: torch.Tensor, lex_dim: int) -> torch.Tensor:
    """(B, F) sparse -> (B, lex_dim) f32 by scatter-ADD: a query whose
    features share a bucket sums them, as the host's np.add.at does
    (padding slots carry value 0, an additive no-op)."""
    dense = torch.zeros((buckets.shape[0], lex_dim), dtype=torch.float32,
                        device=values.device)
    return dense.scatter_add_(1, buckets, values)


def dual_corpus_retrieve_packed(
    chunk_arrays: Tuple[torch.Tensor, ...],
    artifact_arrays: Tuple[torch.Tensor, ...],
    packed: torch.Tensor,                  # (bytes,) uint8 on the device
    *,
    batch: int,
    emb_dim: int,                          # 1 when dense is disabled
    q_feats: int,
    tech_q: int,
    n_calls: int,
    chunk_ks: Tuple[int, int, int],
    artifact_ks: Tuple[int, int, int],
    chunk_mode: str = "exact",
    artifact_mode: str = "exact",
    dense_enabled: bool = True,
    fuse_rrf: bool = False,
) -> torch.Tensor:
    """The /retrieve device program: unpack, both corpora's six lanes, and
    ONE flat int32 output (per-lane blocks, or with ``fuse_rrf`` the
    device-fused RRF blocks; ``unflatten_lanes`` / ``unflatten_merged``
    are the host inverses)."""
    q = _unpack(packed, batch=batch, dim=emb_dim, q_feats=q_feats,
                tech_q=tech_q, n_calls=n_calls)
    q_emb = q["q_emb"]
    if dense_enabled:
        dim = chunk_arrays[0].shape[1]
        if emb_dim != dim:
            raise ValueError(f"query dim {emb_dim} != corpus dim {dim}")
    else:
        q_emb = torch.zeros((batch, chunk_arrays[0].shape[1]),
                            dtype=torch.float32, device=packed.device)
    outs = dual_corpus_retrieve(
        chunk_arrays, artifact_arrays, q_emb,
        _densify(q["cb"], q["cv"], chunk_arrays[1].shape[1]),
        _densify(q["ab"], q["av"], artifact_arrays[1].shape[1]),
        q["tech"], q["allowed"], q["dmin"], q["dmax"],
        chunk_ks=chunk_ks, artifact_ks=artifact_ks, chunk_mode=chunk_mode,
        artifact_mode=artifact_mode, dense_enabled=dense_enabled,
    )
    if fuse_rrf:
        return _flatten_merged(rrf_fuse_lanes_device(outs[0], LANE_ORDER),
                               rrf_fuse_lanes_device(outs[1], LANE_ORDER))
    return _flatten_lanes(outs[0], outs[1])
