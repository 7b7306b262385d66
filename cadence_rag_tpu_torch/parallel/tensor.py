"""The ``model`` mesh axis in one process: tensor-parallel weights and the
collectives between the positions that hold them.

JAX shards the models' weights with ``NamedSharding``s and GSPMD inserts the
collectives. The port has no compiler to insert them, so a model that runs
tensor-parallel calls them itself. A sharded tensor is one tensor per mesh
position (``{position: tensor}``), on that position's device; a weight is
held once per (model index, device), so positions that share a card and a
model index share one tensor. Every collective here is a plain
differentiable torch op (``sum``, ``cat``, ``.to(device)``): one autograd
graph spans every position, and each collective's backward is its
transpose by construction (an all-reduce's is a copy of the cotangent to
every position, an all-gather's a slice of it). A model axis across
processes is not needed: the JAX package uses it only in a one-process
mesh (``dryrun_multichip``, its tests).

- ``Layout``: how one weight lies over the ``model`` axis: replicated, or
  the ranges of one dimension that model index ``m`` holds (contiguous
  pieces, JAX's ``P(..., "model", ...)``; a fused weight's pieces; the
  key/value heads a position's query heads use, replicated where the
  model axis is wider than the key/value heads);
- ``ShardedParams``: every position's shards of a model's weights, cut
  from the whole weights (``shard``) or made shard by shard (``fill``:
  weights born sharded), gathered back (``gather``), with the gradient and
  optimizer plumbing of a dp+tp step (``sync_grads``, ``leaves``);
- ``all_reduce`` / ``all_gather`` / ``replicate`` / ``move``: the
  collectives over a group of positions, taken in position order on the
  group's first device and copied once to each other device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class Layout:
    """``dim`` None: replicated. Else ``ranges[m]``: the ranges of
    dimension ``dim`` that model index ``m`` holds, concatenated in order.
    Ranges of two model indices may overlap (a replicated key/value
    head): their values are the same weight's."""
    dim: Optional[int] = None
    ranges: Tuple[Ranges, ...] = ()

    @property
    def replicated(self) -> bool:
        return self.dim is None

    def block(self, shape: Sequence[int], m: int) -> List[Tuple[slice, ...]]:
        """Model index ``m``'s blocks of a weight of ``shape``: one tuple of
        slices per range (the whole weight when replicated)."""
        whole = tuple(slice(0, n) for n in shape)
        if self.replicated:
            return [whole]
        return [whole[:self.dim] + (slice(a, b),) + whole[self.dim + 1:]
                for a, b in self.ranges[m]]

    def take(self, whole: torch.Tensor, m: int) -> torch.Tensor:
        """Model index ``m``'s shard of ``whole``."""
        if self.replicated:
            return whole
        pieces = [whole.narrow(self.dim, a, b - a) for a, b in self.ranges[m]]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=self.dim)

    def put(self, shards: Sequence[torch.Tensor], size: int) -> torch.Tensor:
        """The whole weight (``size`` along ``dim``) from every model
        index's shard, in order."""
        if self.replicated:
            return shards[0]
        shape = list(shards[0].shape)
        shape[self.dim] = size
        out = shards[0].new_empty(shape)
        for shard, ranges in zip(shards, self.ranges):
            off = 0
            for a, b in ranges:
                out.narrow(self.dim, a, b - a).copy_(
                    shard.narrow(self.dim, off, b - a))
                off += b - a
        return out


def split(size: int, dim: int, n: int, pieces: int = 1) -> Layout:
    """``dim`` of ``size`` in ``n`` contiguous shards; with ``pieces``, the
    dimension is ``pieces`` equal parts (a fused weight) and each part is
    split so: shard ``m`` holds part ``j``'s ``m``-th piece for every
    ``j``."""
    part = size // pieces
    if size % pieces or part % n:
        raise ValueError(f"{size} columns in {pieces} parts do not split "
                         f"over a model axis of {n}")
    w = part // n
    return Layout(dim, tuple(
        tuple((j * part + m * w, j * part + (m + 1) * w) for j in range(pieces))
        for m in range(n)))


# -- collectives --------------------------------------------------------------------
def move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (itself when it is there already)."""
    return t if t.device == device else t.to(device)


def replicate(t: torch.Tensor, mesh, positions: Sequence[int]
              ) -> Dict[int, torch.Tensor]:
    """``t`` on each position's device, one copy per distinct device."""
    by_dev: Dict[torch.device, torch.Tensor] = {}
    out = {}
    for pos in positions:
        dev = mesh.devices[pos]
        if dev not in by_dev:
            by_dev[dev] = move(t, dev)
        out[pos] = by_dev[dev]
    return out


def all_reduce(parts: Mapping[int, torch.Tensor], mesh) -> Dict[int, torch.Tensor]:
    """The sum of a group's parts ({position: tensor}) on every position of
    the group: summed in position order on the first position's device."""
    order = sorted(parts)
    dev = mesh.devices[order[0]]
    total = None
    for pos in order:
        part = move(parts[pos], dev)
        total = part if total is None else total + part
    return replicate(total, mesh, order)


def all_gather(parts: Mapping[int, torch.Tensor], mesh, dim: int
               ) -> Dict[int, torch.Tensor]:
    """The concatenation of a group's parts along ``dim``, in position order,
    on every position of the group."""
    order = sorted(parts)
    dev = mesh.devices[order[0]]
    whole = torch.cat([move(parts[pos], dev) for pos in order], dim=dim)
    return replicate(whole, mesh, order)


def each(xs: Mapping[int, torch.Tensor], fn) -> Dict[int, torch.Tensor]:
    """``fn(position, x)`` once per distinct tensor of a replicated
    {position: tensor} (positions on one device share it, as ``replicate``
    and the collectives leave them)."""
    done: Dict[int, torch.Tensor] = {}
    out = {}
    for pos, x in xs.items():
        if id(x) not in done:
            done[id(x)] = fn(pos, x)
        out[pos] = done[id(x)]
    return out


def vocab_rows(table: torch.Tensor, first: int, token_ids: torch.Tensor
               ) -> torch.Tensor:
    """A vocab shard's rows (the table's rows ``first ..``) for
    ``token_ids``; ids it does not hold give zeros. Summed over the model
    axis this is every id's row exactly: one shard holds it, the others add
    zeros (the masked lookup GSPMD makes of a vocab-sharded gather)."""
    local = token_ids - first
    held = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(held[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))


# -- a model's shards -----------------------------------------------------------------
LeafKey = Tuple[str, int, torch.device]


class ShardedParams:
    """Every position's shards of a model's weights over ``mesh``: one
    tensor per (name, model index, device), replicated leaves under model
    index 0. ``at(pos)`` is a position's {name: tensor}."""

    def __init__(self, mesh, layouts: Mapping[str, Layout],
                 shapes: Mapping[str, Tuple[int, ...]]):
        self.mesh = mesh
        self.layouts = dict(layouts)
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.tensors: Dict[LeafKey, torch.Tensor] = {}

    def _key(self, name: str, pos: int) -> LeafKey:
        m = 0 if self.layouts[name].replicated else self.mesh.axis_index(pos, "model")
        return name, m, self.mesh.devices[pos]

    def at(self, pos: int) -> Dict[str, torch.Tensor]:
        return {name: self.tensors[self._key(name, pos)] for name in self.layouts}

    def fill(self, make: Callable[[str, int, torch.device], torch.Tensor]) -> "ShardedParams":
        """Each leaf from ``make(name, model index, device)``, once per key."""
        for pos in range(self.mesh.size):
            for name in self.layouts:
                key = self._key(name, pos)
                if key not in self.tensors:
                    self.tensors[key] = make(*key)
        return self

    @classmethod
    def shard(cls, mesh, layouts, whole: Mapping[str, torch.Tensor]) -> "ShardedParams":
        """Each position's shards of the whole weights ``whole``."""
        out = cls(mesh, layouts, {n: t.shape for n, t in whole.items()})
        return out.fill(lambda name, m, dev: layouts[name].take(
            whole[name].detach(), m).to(dev, copy=True).contiguous())

    def gather(self, tensors: Optional[Mapping[LeafKey, torch.Tensor]] = None,
               device=None) -> Dict[str, torch.Tensor]:
        """{name: the whole weight} (or of ``tensors``, e.g. gradients,
        keyed as these leaves), on ``device`` (default: the first
        position's)."""
        tensors = self.tensors if tensors is None else tensors
        device = self.mesh.devices[0] if device is None else torch.device(device)
        out = {}
        for name, layout in self.layouts.items():
            shards = [move(tensors[self._key(name, pos)].detach(), device)
                      for pos in self.mesh.model_group(0)]
            size = None if layout.replicated else self.shapes[name][layout.dim]
            out[name] = layout.put(shards, size)
        return out

    def leaves(self) -> Dict[str, torch.Tensor]:
        """{"name@m@device": tensor} of every held tensor (the optimizer's
        per-shard view: AdamW runs on each shard as it lies)."""
        return {f"{n}@{m}@{d}": t for (n, m, d), t in self.tensors.items()}

    def requires_grad_(self, on: bool = True) -> "ShardedParams":
        for t in self.tensors.values():
            t.requires_grad_(on)
        return self

    def nbytes(self, pos: int) -> int:
        """The bytes position ``pos`` holds."""
        return sum(t.numel() * t.element_size() for t in self.at(pos).values())

    def sync_grads(self, grads: Mapping[LeafKey, Optional[torch.Tensor]]
                   ) -> Dict[LeafKey, Optional[torch.Tensor]]:
        """The gradient of each leaf as its copies on other devices see it:
        the sum over every copy of one (name, model index). A copy that
        positions share on one device already has its positions' sum from
        autograd; copies on distinct devices (a data group over several
        cards) are summed here, in device order, and each gets the sum."""
        copies: Dict[Tuple[str, int], List[LeafKey]] = {}
        for key in self.tensors:
            copies.setdefault(key[:2], []).append(key)
        out: Dict[LeafKey, Optional[torch.Tensor]] = dict(grads)
        for keys in copies.values():
            if len(keys) == 1:
                continue
            got = [grads.get(k) for k in keys]
            if all(g is None for g in got):
                continue
            dev = keys[0][2]
            total = None
            for g in got:
                if g is not None:
                    total = move(g, dev) if total is None else total + move(g, dev)
            for k in keys:
                out[k] = move(total, k[2])
        return out
