"""JAX's default random numbers (threefry2x32, partitionable), in torch.

The JAX package draws every model's initial weights from ``jax.random``, and
the tuned embedder's artifact does not store its frozen bag head: loading
regenerates it from ``PRNGKey(init_seed)``. A ``torch.Generator`` cannot
reproduce those numbers, so this module computes them as JAX does
(``jax_threefry_partitionable`` on, the default): the same keys, the same
32-bit words, bit for bit, and the same uniform and normal floats.

The 32-bit words live in int64 tensors masked to 32 bits, so the same code
runs on the CPU and on the card; a large draw is computed in chunks of the
flat index (``normal(..., out=)``), on the device of ``out``.

Keys are int64 tensors of shape ``(..., 2)`` on the CPU, as
``jax.random.PRNGKey``/``split`` give them (uint32 pairs).

Floats: the uniform's bits are JAX's (8 random bits for bf16, whose mantissa
has 7). The normal is ``sqrt(2) * erfinv(u)`` with XLA's f32 polynomial for
``erfinv`` (Giles). XLA contracts each multiply-add into one fused
multiply-add; here it is taken in f64 and rounded once to f32, which gives
the same float (bf16 arithmetic rounds each op, as XLA's does). ``log1p`` is torch's, which may differ from XLA's in the
last bit, so an f32 normal agrees with JAX's to within a few f32 ulps. A
bf16 normal is one of 128 values, each rounded to bf16 from that f32 result.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# flat elements per chunk of a large draw: a handful of int64 temporaries
# of this size are alive at once (256 MiB each)
CHUNK = 1 << 25

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit mode: the seed is taken mod
    2**32 and the high word is 0) -> int64 (2,)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def _key_words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.reshape(-1).tolist()
    if len(k) != 2:
        raise ValueError(f"a key is two 32-bit words, got shape {tuple(key.shape)}")
    return int(k[0]) & MASK, int(k[1]) & MASK


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the counter words ``x0``/``x1``
    (int64 tensors holding uint32 values) under the key ``(k1, k2)``.
    Works in place on ``x0`` and ``x1``; -> the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0.add_(ks[0]).bitwise_and_(MASK)
    x1.add_(ks[1]).bitwise_and_(MASK)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(tmp).bitwise_and_(MASK)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def _counter(start: int, count: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit flat iota ``start .. start+count`` as (hi, lo) words."""
    flat = torch.arange(start, start + count, dtype=torch.int64, device=device)
    return flat >> 32, flat & MASK


Block = Tuple[slice, ...]


def _block_shape(shape: Tuple[int, ...], block: Block) -> Tuple[int, ...]:
    return tuple(len(range(*sl.indices(n))) for sl, n in zip(block, shape))


def block_indices(shape: Shape, block: Block, start: int, count: int,
                  device) -> torch.Tensor:
    """The flat indices, in the whole array of ``shape``, of the elements
    ``start .. start+count`` (row-major) of its sub-array ``block`` (one
    slice per dimension, step 1) -> int64 (count,)."""
    shape = _shape(shape)
    bounds = [sl.indices(n) for sl, n in zip(block, shape)]
    if len(bounds) != len(shape) or any(step != 1 for _a, _b, step in bounds):
        raise ValueError(f"a block is one step-1 slice per dimension of {shape}")
    sub = _block_shape(shape, block)
    local = torch.arange(start, start + count, dtype=torch.int64, device=device)
    flat = torch.zeros_like(local)
    stride = 1
    for dim in reversed(range(len(shape))):
        coord = local % sub[dim] if sub[dim] else local
        local = local // max(sub[dim], 1)
        flat += (coord + bounds[dim][0]) * stride
        stride *= shape[dim]
    return flat


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: the fold-like split over the shape's
    iota -> int64 (*shape, 2) keys."""
    shape = _shape(num)
    k1, k2 = _key_words(key)
    hi, lo = _counter(0, math.prod(shape), "cpu")
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1).reshape(*shape, 2)


def _bits_flat(k1: int, k2: int, start: int, count: int, device) -> torch.Tensor:
    hi, lo = _counter(start, count, device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1.bitwise_xor_(b2)


def bits_at(k1: int, k2: int, flat: torch.Tensor) -> torch.Tensor:
    """The partitionable draw's 32 bits at the flat indices ``flat`` (any
    set, on any device): element ``i`` of a draw is the hash of the 64-bit
    counter ``i`` alone, so a slice of it needs no other element."""
    b1, b2 = threefry2x32(k1, k2, flat >> 32, flat & MASK)
    return b1.bitwise_xor_(b2)


def bits(key: torch.Tensor, shape: Shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` -> int64 of that shape."""
    shape = _shape(shape)
    k1, k2 = _key_words(key)
    return _bits_flat(k1, k2, 0, math.prod(shape), device).reshape(shape)


# XLA's erfinv for f32 (Giles' single-precision approximation): a degree-8
# polynomial in w = -log1p(-x*x), one set of coefficients for w < 5 and one
# for the tails
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (the product of two f32 values is
    exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``, op by op, on an f32 tensor."""
    w = torch.log1p(-(x * x)).neg_()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32),
                           torch.tensor(_ERFINV_GE5[i], dtype=torch.float32))
    p = coef(0).to(x.device).expand_as(x)
    for i in range(1, 9):
        p = _fma(p, w, coef(i).to(x.device))
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def _unit_floats(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Random bits -> floats in [0, 1) with JAX's mantissa trick (f32 takes
    the top 23 of 32 bits, bf16 the top 7 of its 8)."""
    if dtype == torch.float32:
        f = (raw >> 9) | 0x3F800000
        return f.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.bfloat16:
        f = ((raw & 0xFF) >> 1) | 0x3F80
        return f.to(torch.int16).view(torch.bfloat16) - 1.0
    raise TypeError(f"unsupported dtype {dtype}")


def _uniform_from_bits(raw: torch.Tensor, dtype: torch.dtype,
                       minval: float, maxval: float) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=dtype, device=raw.device)
    hi = torch.tensor(maxval, dtype=dtype, device=raw.device)
    floats = _unit_floats(raw, dtype)
    # XLA fuses the f32 multiply-add; bf16 arithmetic rounds each op
    u = (_fma(floats, hi - lo, lo) if dtype == torch.float32
         else floats * (hi - lo) + lo)
    return torch.maximum(lo, u)


def uniform(key: torch.Tensor, shape: Shape, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0, device="cpu"
            ) -> torch.Tensor:
    """``jax.random.uniform`` for f32 and bf16."""
    shape = _shape(shape)
    k1, k2 = _key_words(key)
    raw = _bits_flat(k1, k2, 0, math.prod(shape), device)
    return _uniform_from_bits(raw, dtype, minval, maxval).reshape(shape)


def _lowest_above_minus_one(dtype: torch.dtype) -> float:
    return float(torch.nextafter(torch.tensor(-1.0, dtype=torch.float32),
                                 torch.tensor(0.0)).item()) \
        if dtype == torch.float32 else -1.0 + 2.0 ** -8


def _normal_from_bits(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    u = _uniform_from_bits(raw, dtype, _lowest_above_minus_one(dtype), 1.0)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=raw.device)
    if dtype == torch.float32:
        return sqrt2 * erfinv_f32(u)
    return sqrt2 * erfinv_f32(u.float()).to(dtype)


def bf16_normal_table(device="cpu") -> torch.Tensor:
    """The 128 values a bf16 normal can take, indexed by the top 7 of its 8
    random bits."""
    return _normal_from_bits(torch.arange(0, 256, 2, dtype=torch.int64,
                                          device=device), torch.bfloat16)


def normal(key: torch.Tensor, shape: Shape, dtype=torch.float32,
           device="cpu", *, out: Optional[torch.Tensor] = None,
           scale: Optional[float] = None,
           index: Optional[Block] = None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for f32 and bf16, computed in
    chunks of ``CHUNK`` flat elements on ``device`` (or into ``out``, whose
    device and dtype then rule). With ``scale``, each value is multiplied
    by ``scale`` in ``dtype`` (``normal(...) * scale`` in JAX, the scalar
    taking the array's dtype). With ``index`` (one step-1 slice per
    dimension) only that block of the draw is made, of the block's shape:
    ``normal(key, shape)[index]`` without the whole array anywhere, as
    JAX's ``init_params(shardings=)`` makes each device's shard."""
    shape = _shape(shape)
    whole = shape
    if index is not None:
        shape = _block_shape(whole, tuple(index))
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, not {shape}")
    dtype = out.dtype
    k1, k2 = _key_words(key)
    flat = out.view(-1)
    table = bf16_normal_table(out.device) if dtype == torch.bfloat16 else None
    scale_t = (torch.tensor(scale, dtype=dtype, device=out.device)
               if scale is not None else None)
    for start in range(0, flat.numel(), CHUNK):
        count = min(CHUNK, flat.numel() - start)
        if index is None:
            raw = _bits_flat(k1, k2, start, count, out.device)
        else:
            raw = bits_at(k1, k2, block_indices(whole, tuple(index), start,
                                                count, out.device))
        if table is not None:
            vals = table[(raw & 0xFF) >> 1]
        else:
            vals = _normal_from_bits(raw, dtype)
        if scale_t is not None:
            vals = vals * scale_t
        flat[start:start + count] = vals
        del raw, vals
    return out
