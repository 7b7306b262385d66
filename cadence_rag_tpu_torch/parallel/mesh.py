"""Device meshes and the process gang.

Counterpart of ``cadence_rag_tpu/parallel/mesh.py``. Mesh axes: ``data``
shards the corpus (document rows of the index arrays), the axis that grows
with corpus size, and the batch of the models' forward and training step;
``model`` shards the in-process encoders' weights (Megatron tensor
parallelism, ``parallel/tensor.py``). The index's rows are replicated over
``model``: a data shard is the group of positions that share a ``data``
index (``shard_positions``), and one process computes each shard it holds
once, on the device of its lowest position there (``local_shards``).

A ``Mesh`` is a plain record: the named axes, one device per position
(row-major over the axes, in the spec's order, so ``model:2,data:2`` is
JAX's mesh of that spec) and the process that holds each position. A
device may repeat: two positions can share one card (or the CPU), the way
the JAX tests give one host eight virtual CPU devices.

The gang: when ``DIST_COORDINATOR`` names a coordinator, every process
calls ``init_gang`` before it touches the index. It joins a ``gloo``
process group at ``tcp://<coordinator>``, and the processes exchange their
host names and card counts over it (``plan_gang``): a process takes card
``local_rank % cards``, its local rank being its place among the processes
of its host. Before anything else runs the gang picks its collectives'
backend from that topology: ``nccl`` (a group of its own over every
process) when every process owns a card of its own, on one host or many,
else ``gloo``: processes that share a card (NCCL refuses two ranks on one
device) or run on the CPU. Over ``gloo`` the collectives carry CPU copies
of the (small) candidate blocks, while each shard's scan stays on its
card. In a gang, ``make_mesh`` spans every process: each contributes the
devices it holds, and process ``p`` holds positions ``[p*L, (p+1)*L)``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Mesh:
    axes: Tuple[Tuple[str, int], ...]
    devices: Tuple[torch.device, ...]     # one per position, row-major
    processes: Tuple[int, ...]            # the process holding each position
    rank: int = 0                         # this process

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_positions(self) -> List[int]:
        """Positions this process holds, in order."""
        return [i for i, p in enumerate(self.processes) if p == self.rank]

    # -- axis arithmetic ------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        """The size of ``axis`` (1 when the mesh has no such axis)."""
        return self.shape.get(axis, 1)

    def _stride(self, axis: str) -> int:
        names = [name for name, _size in self.axes]
        return math.prod(size for _name, size in self.axes[names.index(axis) + 1:])

    def axis_index(self, pos: int, axis: str) -> int:
        """Position ``pos``'s index along ``axis`` (0 without the axis)."""
        if axis not in self.shape:
            return 0
        return (pos // self._stride(axis)) % self.shape[axis]

    def group(self, pos: int, axis: str) -> List[int]:
        """The positions that differ from ``pos`` only along ``axis``, in
        that axis's order: the group a collective over ``axis`` spans."""
        if axis not in self.shape:
            return [pos]
        stride = self._stride(axis)
        first = pos - self.axis_index(pos, axis) * stride
        return [first + i * stride for i in range(self.shape[axis])]

    def model_group(self, pos: int) -> List[int]:
        """``pos``'s group along ``model``: the positions that hold the
        other shards of its weights (one ``data`` index)."""
        return self.group(pos, "model")

    def data_group(self, pos: int) -> List[int]:
        """``pos``'s group along ``data``: the positions that hold the same
        weight shard and the other slices of the batch (and rows)."""
        return self.group(pos, "data")

    # -- the index's data shards ------------------------------------------------
    @property
    def n_shards(self) -> int:
        """Row shards: the ``data`` size, whatever the other axes."""
        return self.axis_size("data")

    def shard_positions(self, shard: int) -> List[int]:
        """The positions of data shard ``shard``: its replicas along every
        other axis, ascending."""
        return [pos for pos in range(self.size)
                if self.axis_index(pos, "data") == shard]

    def shard_holders(self, shard: int) -> List[int]:
        """The processes holding a replica of ``shard``, ascending; the
        first is its owner (the copy a gather and a save keep)."""
        return sorted({self.processes[pos] for pos in self.shard_positions(shard)})

    def held_shards(self, process: int) -> List[int]:
        """The data shards ``process`` holds, ascending."""
        return sorted({self.axis_index(pos, "data")
                       for pos, p in enumerate(self.processes) if p == process})

    def local_shards(self) -> Dict[int, torch.device]:
        """{data shard: device} of the shards this process holds, each once,
        on the device of its lowest position in this process."""
        out: Dict[int, torch.device] = {}
        for pos in self.local_positions():
            out.setdefault(self.axis_index(pos, "data"), self.devices[pos])
        return dict(sorted(out.items()))


def parse_mesh_shape(spec: str) -> List[Tuple[str, int]]:
    """"data:4,model:2" -> [("data", 4), ("model", 2)]."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        out.append((name.strip(), int(size)))
    return out


def visible_cards() -> List[torch.device]:
    """Every visible card (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    spec: Optional[str] = None,
    devices: Optional[Sequence] = None,
    *,
    device="cuda",
) -> Mesh:
    """A mesh of ``spec`` (default: one ``data`` axis over every device)
    over ``devices``, this process's (a device may repeat). By default they
    are every visible card when ``device`` (the index's) is a card outside a
    gang, a spec wider than the cards raising; else ``device`` once per
    position this process holds: the CPU, or in a gang this process's own
    device, the spec dividing evenly over the gang's processes. In a gang
    the mesh spans every process."""
    world, rank = gang_world(), gang_rank()
    axes = parse_mesh_shape(spec) if spec else None
    total = math.prod(size for _name, size in axes) if axes else None
    dev = torch.device(device)
    if devices is not None:
        local = [torch.device(d) for d in devices]
    elif dev.type == "cuda" and world == 1:
        local = visible_cards()
    else:
        if total is not None and total % world:
            raise ValueError(
                f"mesh {dict(axes)} ({total} shards) does not divide over the "
                f"gang's {world} processes")
        local = [dev] * (total // world if total is not None else 1)
    have = len(local) * world
    if axes is None:
        axes = [("data", have)]
        total = have
    if total != have:
        raise ValueError(f"mesh {dict(axes)} needs {total} devices, have {have}")
    return Mesh(
        axes=tuple(axes),
        devices=tuple(local) * world,
        processes=tuple(p for p in range(world) for _ in local),
        rank=rank,
    )


# -- the gang -----------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Gang:
    backend: str            # "nccl" or "gloo": the collectives' backend
    rank: int
    world: int
    device: torch.device    # this process's device
    group: Any = None       # the nccl group (None: the default gloo group)


_gang: Optional[Gang] = None


def gang() -> Optional[Gang]:
    return _gang


def gang_world() -> int:
    return _gang.world if _gang is not None else 1


def gang_rank() -> int:
    return _gang.rank if _gang is not None else 0


def plan_gang(hosts: Sequence[str], cards: Sequence[int]) -> Tuple[str, List[int]]:
    """The gang's backend and each process's card, from every process's
    host name and visible card count (0 on the CPU), in rank order. A
    process's card is its local rank (its place among its host's processes)
    modulo its host's cards; ``nccl`` when no host runs more processes than
    it has cards, else ``gloo``. -> (backend, card per process, -1 on the
    CPU)"""
    local_rank: List[int] = []
    per_host: Dict[str, int] = collections.Counter()
    for host in hosts:
        local_rank.append(per_host[host])
        per_host[host] += 1
    own = all(per_host[host] <= n for host, n in zip(hosts, cards))
    return ("nccl" if own else "gloo",
            [r % n if n else -1 for r, n in zip(local_rank, cards)])


def init_gang(coordinator: str, n_processes: int, process_id: int,
              device="cuda") -> Gang:
    """Join the process group at ``tcp://coordinator`` as ``process_id`` of
    ``n_processes``, take this process's card and the gang's backend
    (``plan_gang``) -> the gang"""
    global _gang
    import torch.distributed as dist

    if _gang is not None:
        raise RuntimeError("this process already joined a gang")
    if n_processes < 1 or not 0 <= process_id < n_processes:
        raise ValueError(
            f"process {process_id} of {n_processes}: DIST_NUM_PROCESSES and "
            "DIST_PROCESS_ID must name this process in the gang")
    dev = torch.device(device)
    cards = 0
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device cuda requested but torch.cuda.is_available() is False")
        cards = torch.cuda.device_count()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=n_processes, rank=process_id)
    topology: List[Any] = [None] * n_processes
    dist.all_gather_object(topology, (socket.gethostname(), cards))
    hosts = [host for host, _n in topology]
    backend, card = plan_gang(hosts, [n for _host, n in topology])
    if cards:
        dev = torch.device("cuda", card[process_id])
        torch.cuda.set_device(dev)
    group = dist.new_group(backend="nccl") if backend == "nccl" else None
    logger.info(
        "parallel.gang backend=%s process=%s/%s device=%s cards=%s hosts=%s (%s)",
        backend, process_id, n_processes, dev, cards, len(set(hosts)),
        "a card per process" if backend == "nccl"
        else "processes share a card" if cards else "cpu")
    _gang = Gang(backend=backend, rank=process_id, world=n_processes, device=dev,
                 group=group)
    return _gang


def leave_gang() -> None:
    """Destroy the process group (tests, and the chip script's gang phase)."""
    global _gang
    if _gang is None:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    _gang = None


# -- collectives ----------------------------------------------------------------
# gloo moves CPU tensors; bf16 and bool travel as 2- and 1-byte integers
def _wire(t: torch.Tensor) -> torch.Tensor:
    if _gang.backend == "gloo" and t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t


def _unwire(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    if dtype in (torch.bfloat16, torch.bool):
        t = t.view(dtype)
    return t.to(device)


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (same shape and dtype on each), in rank order,
    on ``t``'s device."""
    if _gang is None or _gang.world == 1:
        return [t]
    import torch.distributed as dist

    send = _wire(t.contiguous())
    out = [torch.empty_like(send) for _ in range(_gang.world)]
    dist.all_gather(out, send, group=_gang.group)
    return [_unwire(o, t.dtype, t.device) for o in out]


def send_to(t: torch.Tensor, dst: int) -> None:
    import torch.distributed as dist

    dist.send(_wire(t.contiguous()), dst, group=_gang.group)


def recv_from(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    import torch.distributed as dist

    probe = torch.empty(shape, dtype=dtype,
                        device=device if _gang.backend == "nccl" else "cpu")
    buf = _wire(probe)
    dist.recv(buf, src, group=_gang.group)
    return _unwire(buf, dtype, device)


def broadcast(t: Optional[torch.Tensor], shape, dtype: torch.dtype, device,
              src: int) -> torch.Tensor:
    """``t`` of process ``src`` on every process (the others pass None)."""
    import torch.distributed as dist

    if _gang.rank == src:
        buf = _wire(t.contiguous())
    else:
        buf = _wire(torch.empty(shape, dtype=dtype,
                                device=device if _gang.backend == "nccl" else "cpu"))
    dist.broadcast(buf, src, group=_gang.group)
    return t if _gang.rank == src else _unwire(buf, dtype, device)
