"""Multi-process lockstep serving: the device-index op-log.

Counterpart of ``cadence_rag_tpu/parallel/oplog.py``. When the mesh spans
processes, every process must run the same collectives in the same order:
a gather that one process enters alone waits forever. A serving system
has to make that order out of an arbitrary request stream.

- Process 0 (the leader) runs the HTTP server, the SQLite store and the
  whole engine. Host work (featurizing, planning, RRF, packs, store reads)
  happens on the leader only.
- Followers mirror the DEVICE INDEX only: every device op the leader
  performs (slab write, growth, tombstone, embedding / tech / lexical
  scatter, restore allocation, compaction, IVF build and overflow, query
  dispatch, the gang checkpoint) goes over a TCP op-log (length-prefixed
  JSON header + npz payload) and each follower replays it, in order, on
  the shards it holds. The leader emits under the corpus lock (one lock
  for both corpora in a gang: ``core/index.DeviceIndexManager``) and before
  the device work, so TCP order is the leader's own order.
- A query op carries its inputs; each process scans its shards and the
  candidates meet in one ``torch.distributed`` all-gather
  (``parallel/sharded.py``); the leader keeps the merged answer.

Wire format (``_send_msg`` / ``_recv_msg``): the JAX package's, byte for
byte: ``<II`` (JSON length, npz length), the JSON ``{"op", "statics"}``,
then an npz of each array as uint8 bytes with ``__meta__`` recording its
dtype and shape. bf16 has no numpy dtype: the port sends a bf16 tensor's
2-byte pattern under the dtype name "bfloat16" (what ml_dtypes writes) and
reads "bfloat16" back as a ``torch.bfloat16`` tensor.

A follower that loses the leader (EOF without "shutdown") raises, so its
process exits nonzero; the leader's next emit after a follower is gone
raises the gang error. The handshake: a follower's first 32 bytes are a
sha256 over a purpose tag and the shared token (``DIST_OPLOG_TOKEN``, or
one derived from the coordinator address, which turns away stray
connections; a real secret is needed against an adversary).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_HDR = struct.Struct("<II")  # (json_len, npz_len)


def _handshake_digest(token: str) -> bytes:
    return hashlib.sha256(b"cadence-oplog-v1\x00" + token.encode()).digest()


def default_token() -> str:
    from ..config import settings

    return settings.dist_oplog_token.strip() or (
        "derived:" + settings.dist_coordinator.strip()
    )


# the leader's log (one gang per process)
_leader: Optional["LeaderOpLog"] = None


# -- wire format -----------------------------------------------------------
def _as_bytes(value):
    """-> (dtype name, shape, uint8 bytes) of a numpy array or a tensor."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy().view(np.uint8).reshape(-1)
        value = t.numpy()
    v = np.ascontiguousarray(value)
    return str(v.dtype), list(v.shape), v.view(np.uint8).reshape(-1)


def _send_msg(sock: socket.socket, op: str, statics: Dict, arrays: Dict) -> int:
    header = json.dumps({"op": op, "statics": statics}).encode()
    if arrays:
        buf = io.BytesIO()
        packed, meta = {}, {}
        for k, v in arrays.items():
            dtype, shape, raw = _as_bytes(v)
            meta[k] = (dtype, shape)
            packed[k] = raw
        packed["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(buf, **packed)
        blob = buf.getvalue()
    else:
        blob = b""
    sock.sendall(_HDR.pack(len(header), len(blob)) + header + blob)
    return len(blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("op-log closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    """-> (op, statics, {name: numpy array, or a torch.bfloat16 tensor})"""
    jlen, blen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    header = json.loads(_recv_exact(sock, jlen))
    arrays: Dict[str, object] = {}
    if blen:
        with np.load(io.BytesIO(_recv_exact(sock, blen))) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            for k, (dtype, shape) in meta.items():
                raw = data[k]
                if dtype == "bfloat16":
                    arrays[k] = torch.from_numpy(
                        raw.copy().view(np.int16)).view(torch.bfloat16).reshape(shape)
                else:
                    arrays[k] = raw.view(np.dtype(dtype)).reshape(shape)
    return header["op"], header["statics"], arrays


# -- leader ----------------------------------------------------------------
class LeaderOpLog:
    """Accepts the followers' connections and broadcasts device ops in
    order. ``emit`` is called under the corpus lock at each device-op site
    (``core/index.py``); the send lock keeps concurrent emitters whole."""

    def __init__(self, port: int, n_followers: int, timeout_s: float = 120.0,
                 bind_host: str = "127.0.0.1", token: str = ""):
        self._send_lock = threading.Lock()
        self._socks = []
        self.bytes_sent = 0
        expected = _handshake_digest(token or default_token())
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((bind_host, port))
        srv.listen(n_followers)
        deadline = time.monotonic() + timeout_s
        # accept until n_followers AUTHENTICATE: a peer that fails the
        # handshake is dropped and takes no follower slot
        while len(self._socks) < n_followers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                srv.close()
                raise TimeoutError(
                    f"op-log: {len(self._socks)}/{n_followers} followers "
                    f"authenticated within {timeout_s}s")
            srv.settimeout(remaining)
            conn, addr = srv.accept()
            try:
                conn.settimeout(10.0)
                hello = _recv_exact(conn, len(expected))
            except (OSError, ConnectionError):
                conn.close()
                continue
            if hello != expected:
                logger.warning("oplog.follower_rejected addr=%s", addr)
                conn.close()
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks.append(conn)
            logger.info("oplog.follower_connected addr=%s", addr)
        srv.close()

    def emit(self, op: str, statics: Optional[Dict] = None,
             arrays: Optional[Dict] = None) -> None:
        with self._send_lock:
            for sock in self._socks:
                try:
                    self.bytes_sent += _send_msg(sock, op, statics or {},
                                                 arrays or {})
                except OSError as exc:
                    # the next collective would wait forever: fail fast
                    raise RuntimeError(
                        "op-log follower lost mid-serving; the multi-host "
                        "gang must be restarted") from exc

    def shutdown(self) -> None:
        try:
            self.emit("shutdown")
        except (OSError, RuntimeError):  # follower already gone
            pass
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass


# -- the ops that run on every process -------------------------------------
def _statics(st: Dict) -> Dict:
    out = dict(st)
    for key in ("chunk_ks", "artifact_ks"):
        if key in out:
            out[key] = tuple(out[key])
    return out


def packed_query(manager, packed, statics: Dict) -> torch.Tensor:
    """The packed dual-corpus program over the manager's shards (leader and
    followers): each process scans its shards, the gather merges."""
    from ..core.index import _stage
    from . import sharded

    return sharded.packed_query(
        manager.chunks, manager.artifacts,
        _stage(np.asarray(packed), manager.device), **_statics(statics))


def single_query(corpus, queries: Dict, statics: Dict):
    """One corpus's lanes (the cold-start fallback)."""
    return corpus.run_single_query(queries, statics)


def ivf_query(corpus, state, q_emb, allowed, dmin, dmax, statics: Dict):
    """The IVF dense dispatch: every shard probes, the gather merges."""
    from . import sharded

    put = corpus._put
    return sharded.ivf_lanes(
        corpus, state, put(q_emb, torch.float32), put(allowed, torch.bool),
        put(dmin, torch.int32), put(dmax, torch.int32), k=int(statics["k"]))


def ivf_build_gang(corpus, statics: Dict):
    """The gang's IVF build (``CorpusIndex.gang_build_install_ivf``)."""
    return corpus.gang_build_install_ivf(
        int(statics["n"]), int(statics["clusters"]), int(statics["nprobe"]),
        int(statics["seed"]))


# -- lifecycle -------------------------------------------------------------
def install_leader(manager, port: int, n_followers: int,
                   bind_host: str = "127.0.0.1", token: str = "") -> None:
    """Process 0: wait for the gang's followers, then mirror every device op
    (before any index mutation, the startup rebuild from the store
    included)."""
    global _leader
    from ..core import index as index_mod

    _leader = LeaderOpLog(port, n_followers, bind_host=bind_host, token=token)
    index_mod.set_oplog(_leader)
    import atexit

    atexit.register(_leader.shutdown)
    logger.info("oplog.leader_ready followers=%s port=%s", n_followers, port)


def leader() -> Optional[LeaderOpLog]:
    return _leader


def uninstall_leader() -> None:
    """Shut the log down and stop mirroring (the chip script's gang phase
    and the tests end a gang inside a process that goes on)."""
    global _leader
    from ..core import index as index_mod

    if _leader is not None:
        _leader.shutdown()
    index_mod.set_oplog(None)
    _leader = None


# -- follower --------------------------------------------------------------
def _connect(host: str, port: int, timeout_s: float, token: str = "") -> socket.socket:
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(_handshake_digest(token or default_token()))
            sock.settimeout(None)
            return sock
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.2)


def _apply(manager, op: str, st: Dict, arrays: Dict) -> None:
    """Replay one op on this process's shards."""
    if op == "query_packed":
        packed_query(manager, arrays["packed"], st["statics"])
        return
    corpus = manager.corpus(st["corpus"])
    if op == "grow":
        corpus._grow_to(int(st["cap"]))
    elif op == "compact":
        corpus.apply_compact_device(arrays["live"], int(st["out_rows"]),
                                    int(st["cap"]))
    elif op == "checkpoint_shards":
        from ..core.checkpoint import write_local_heavy_shards

        write_local_heavy_shards(corpus, st["path"], int(st["generation"]),
                                 int(st["count"]))
    elif op == "alloc":
        corpus.count = 0
        corpus.capacity = int(st["cap"])
        corpus.ivf = None
        corpus._alloc_device(corpus.capacity)
    elif op == "build_ivf":
        ivf_build_gang(corpus, st)
    elif op == "ivf_overflow":
        corpus.gang_set_ivf_overflow(arrays["padded"], int(st["count"]))
    elif op == "query_ivf":
        ivf_query(corpus, corpus.ivf, arrays["q_emb"], arrays["allowed"],
                  arrays["dmin"], arrays["dmax"], st["statics"])
    elif op == "query_single":
        single_query(corpus, arrays, st["statics"])
    elif op == "write_slabs":
        corpus._write("write_slabs", (
            int(st["start"]),
            corpus._encode_emb(arrays["emb"]),
            corpus._put(arrays["lex"], torch.int8),
            corpus._put(arrays["tech"], torch.int32),
            corpus._put(arrays["call"], torch.int32),
            corpus._put(arrays["started"], torch.int32),
            corpus._put(arrays["has"], torch.bool),
        ))
        corpus.count = int(st["count_after"])
    elif op in ("tombstone", "scatter_emb", "scatter_tech", "scatter_lex"):
        pos = np.asarray(arrays["pos"]).astype(np.int64)
        idx = corpus._put(pos, torch.int64)
        if op == "tombstone":
            corpus._write(op, (idx,), pos)
        elif op == "scatter_emb":
            corpus._write(op, (idx, corpus._encode_emb(arrays["vals"])), pos)
        else:
            dtype = torch.int8 if op == "scatter_lex" else torch.int32
            corpus._write(op, (idx, corpus._put(arrays["vals"], dtype)), pos)
    else:
        raise ValueError(f"unknown op-log op {op!r}")


def follower_main(manager, host: str, port: int,
                  connect_timeout_s: float = 120.0) -> int:
    """Non-leader processes: apply the leader's device ops until
    "shutdown" (-> the count applied). Losing the leader without one
    raises: the follower exits nonzero. Called from serve startup
    (``serve/api.py``) in place of the HTTP server."""
    sock = _connect(host, port, connect_timeout_s)
    logger.info("oplog.follower_loop host=%s port=%s", host, port)
    applied = 0
    try:
        while True:
            try:
                op, st, arrays = _recv_msg(sock)
            except ConnectionError as exc:
                raise RuntimeError(
                    f"op-log: the leader went away without a shutdown after "
                    f"{applied} ops; the gang must be restarted") from exc
            if op == "shutdown":
                from .sharded import launches_by_shard

                logger.info("oplog.shutdown applied=%s shard_launches=%s", applied,
                            json.dumps({f"{c}/{s}": dict(t) for (c, s), t
                                        in sorted(launches_by_shard.items())}))
                return applied
            with manager.chunks.lock:
                _apply(manager, op, st, arrays)
            applied += 1
    finally:
        try:
            sock.close()
        except OSError:
            pass
