"""Counter-based key streams, bit for bit those of ``jax.random``.

The JAX reference draws every random number of Algorithm 1 from threefry
keys: the per-round keys (``driver.run_experiment``), the per-worker
compressor keys (``flecs._worker_messages``), the sketch
(``sketch.sketch``) and the dither uniforms (``compressors._dither``).  This
module reproduces those streams exactly, so the port's masks, sketches and
compressor outputs compare element for element with the reference.

What is reproduced is ``jax.random`` with ``jax_threefry_partitionable``
on (the default of the JAX releases the reference runs on):

* a key is the pair of uint32 words ``key_data(jax.random.key(seed))``,
  ``[0, seed]``; here an int64 tensor ``[..., 2]`` holding uint32 values
  (uint32 arithmetic is done in int64 and masked to 32 bits: ``torch.uint32``
  lacks most operators);
* element ``i`` of ``bits(key, shape)`` is ``y0 ^ y1`` of
  ``threefry2x32(key, (i >> 32, i & 0xffffffff))`` over the row-major flat
  index ``i``;
* ``split(key, n)[i]`` is the pair ``threefry2x32(key, (0, i))``;
* ``fold_in(key, d)`` is the pair ``threefry2x32(key, (0, d))``;
* ``uniform`` is ``bitcast((bits >> 9) | 0x3F800000) - 1``, scaled to
  [minval, maxval) as ``max(minval, u * (maxval - minval) + minval)``;
* ``normal`` is ``sqrt(2) * erfinv`` of a uniform on (-1, 1): exact up to
  the erfinv, which is held to a few ulps (see :func:`erfinv`).

Every function takes keys with leading batch dimensions (one key per row)
and works on CPU and CUDA tensors alike; results lie on the key's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as ``jax.random``
    runs it.  All arguments are int64 tensors of uint32 values that
    broadcast together; returns the two output words (new tensors: the
    rounds run in place on copies of x0 and x1)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(_MASK)
    x1 = (x1 + ks[1]).bitwise_and_(_MASK)
    if x0.shape != x1.shape:
        x0, x1 = (t.contiguous() for t in torch.broadcast_tensors(x0, x1))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            high = x1 >> (32 - r)                     # x1 = rotl(x1, r) ^ x0
            x1.bitwise_left_shift_(r).bitwise_and_(_MASK)
            x1.bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The key data of ``jax.random.key(seed)``: int64 ``[0, seed]``."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64,
                        device=resolve_device(device))


#: Counters drawn per pass of :func:`_draw`, by device type: the int64
#: temporaries of a pass stay in the CPU's caches, and on the card a pass
#: over a 254 M-element leaf holds 0.1 GB a temporary instead of 2 GB.
_CHUNK = {"cpu": 1 << 20, "cuda": 1 << 24}


def _counters(key: torch.Tensor, lo: int, hi: int):
    """Threefry over the flat counters lo..hi-1 for every key row: returns
    (y0, y1) of shape ``key.shape[:-1] + (hi - lo,)``."""
    idx = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], idx >> 32,
                        idx & _MASK)


def _draw(key: torch.Tensor, count: int, dtype, finish,
          start: int = 0) -> torch.Tensor:
    """``finish(y0 ^ y1)`` over the flat counters start..start+count-1 of
    every key row, as a ``key.shape[:-1] + (count,)`` tensor of ``dtype``,
    computed in passes of ``_CHUNK`` counters (the result does not depend
    on it)."""
    out = torch.empty(key.shape[:-1] + (count,), dtype=dtype,
                      device=key.device)
    step = _CHUNK[key.device.type]
    for lo in range(0, count, step):
        hi = min(count, lo + step)
        y0, y1 = _counters(key, start + lo, start + hi)
        out[..., lo:hi] = finish(y0.bitwise_xor_(y1))
    return out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` -> ``[..., num, 2]``."""
    y0, y1 = _counters(key, 0, num)
    return torch.stack((y0, y1), dim=-1)


def split_at(key: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``split(key, N)`` for any N above them, without the
    other rows: the pair ``threefry2x32(key, (id >> 32, id & 0xffffffff))``
    of each id.  ``key`` [..., 2] and ``ids`` (int) broadcast as ``key[...,
    None, :]`` against ``ids``: keys [G, 2] with ids [n] or [G, n] give
    [G, n, 2].  For ids below 2**32 this is ``fold_in(key, id)`` too."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=key.device)
    k = key.unsqueeze(-2)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], ids >> 32, ids & _MASK)
    return torch.stack((y0, y1), dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: mix an integer (or an int tensor that
    broadcasts against the key's batch dimensions) into the key."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & _MASK)
    return torch.stack((y0, y1), dim=-1)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (uint32): int64 ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    out = _draw(key, math.prod(shape), torch.int64, lambda b: b)
    return out.reshape(key.shape[:-1] + shape)


def _uniform_flat(key: torch.Tensor, start: int, count: int, minval=0.0,
                  maxval=1.0) -> torch.Tensor:
    """``uniform``'s draws at the flat counters start..start+count-1: each
    element depends on its counter alone."""

    def finish(b):
        mant = b.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
        return mant.to(torch.int32).view(torch.float32) - 1.0

    out = _draw(key, count, torch.float32, finish, start)
    if minval == 0.0 and maxval == 1.0:
        return out
    f32 = dict(dtype=torch.float32, device=key.device)
    lo, hi = torch.tensor(minval, **f32), torch.tensor(maxval, **f32)
    scaled = (out.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def uniform(key: torch.Tensor, shape=(), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` on [minval, maxval), float32: the floats on
    [0, 1) scaled as JAX scales them, ``max(minval, floats * (maxval -
    minval) + minval)``, where XLA fuses the product and the sum into one
    float32 fma: here taken in float64 and rounded once, which is that fma
    while the product and minval lie within 29 binary orders of each
    other (on [0, 1) the floats themselves)."""
    shape = tuple(shape)
    out = _uniform_flat(key, 0, math.prod(shape), minval, maxval)
    return out.reshape(key.shape[:-1] + shape)


#: Giles' single-precision erfinv ("Approximating the erfinv function",
#: 2010), the polynomial XLA evaluates for ``lax.erf_inv`` in float32:
#: coefficients for w < 5 and for w >= 5, highest degree first.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Float32 erfinv by XLA's polynomial, in its order of operations.

    ``torch.erfinv`` differs from XLA's by up to ~90 ulps; this one agrees
    to within a few ulps (the rest is XLA's own ``log1p``, which is not
    reproduced), and bit for bit on ~95% of ``normal``'s draws."""
    w = -torch.log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for lo, hi in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = torch.where(small, lo, hi) + p * w
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def _normal_flat(key: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """``normal``'s draws at the flat counters start..start+count-1."""
    u = _uniform_flat(key, start, count,
                      minval=-(1 - 2**-24))          # nextafter(-1, 0)
    return erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32,
                                    device=key.device)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``sqrt(2) * erfinv(u)`` with u
    uniform on (nextafter(-1, 0), 1), scaled as ``jax.random.uniform``
    scales it (``max(lo, floats * (hi - lo) + lo)``).

    The uniforms are the reference's bit for bit; ``erfinv`` holds the
    result to within a few ulps of the reference (relative error below
    5e-7, ``tests/test_torch_random.py``)."""
    shape = tuple(shape)
    out = _normal_flat(key, 0, math.prod(shape))
    return out.reshape(key.shape[:-1] + shape)


#: Elements of a leaf :func:`normal_cast` draws a slice, by device type.
_SLICE = {"cpu": 1 << 22, "cuda": 1 << 26}


def normal_cast(key: torch.Tensor, shape, dtype, finish=None) -> torch.Tensor:
    """``finish(normal(key, shape)).to(dtype)`` (a [2] key), drawn a slice
    of the flat counter range at a time (``_SLICE`` elements) and cast
    slice by slice: element i depends only on counter i and ``finish`` is
    elementwise, so the result is the whole-leaf draw's, without the whole
    leaf in float32 and the draw's temporaries beside it (a [256, 7168,
    2048] expert leaf is 15 GB in float32).  On the CPU, torch takes the
    last few elements of a loop through ``log1p``'s scalar path, which may
    differ from its vector path in the last ulp: where the slices and the
    whole leaf put an element apart, it may differ by that."""
    shape = tuple(shape)
    count = math.prod(shape)
    out = torch.empty(count, dtype=dtype, device=key.device)
    step = _SLICE[key.device.type]
    for lo in range(0, count, step):
        hi = min(count, lo + step)
        z = _normal_flat(key, lo, hi - lo)
        out[lo:hi] = (z if finish is None else finish(z)).to(dtype)
    return out.reshape(shape)


def bernoulli(key: torch.Tensor, p=0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform < p`` (p in float32), bool."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


def rademacher(key: torch.Tensor, shape=(),
               dtype=torch.float32) -> torch.Tensor:
    """``jax.random.rademacher``: ``2 * bernoulli(key, 0.5) - 1``."""
    return (2 * bernoulli(key, 0.5, shape).to(dtype) - 1).to(dtype)


def _int32_wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 values as the int32 they wrap to."""
    return ((v + 2**31) & _MASK) - 2**31


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` (int32, the reference's default dtype):
    ``key.shape[:-1] + shape`` int64 values in [minval, maxval).

    As JAX draws it: ``k1, k2 = split(key)``, ``higher = bits(k1)``,
    ``lower = bits(k2)``, ``span = maxval - minval`` (1 where maxval <=
    minval), ``mult = (2**16 % span)**2 % span`` and the value
    ``minval + ((higher % span) * mult + lower % span) % span``, every
    product and sum wrapping in uint32 (masked here, as the module's int64
    arithmetic is).  minval and maxval are ints or int tensors that
    broadcast against the result, clipped to int32 as JAX clips them."""
    shape = tuple(shape)
    k1, k2 = split(key, 2).unbind(dim=-2)
    higher, lower = bits(k1, shape), bits(k2, shape)
    i32 = dict(min=-2**31, max=2**31 - 1)
    lo = torch.as_tensor(minval, dtype=torch.int64,
                         device=key.device).clamp(**i32)
    hi = torch.as_tensor(maxval, dtype=torch.int64,
                         device=key.device).clamp(**i32)
    span = torch.where(hi <= lo, 1, (hi - lo) & _MASK)
    mult = (65536 % span) * (65536 % span) & _MASK
    mult = mult % span
    offset = ((higher % span) * mult) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return _int32_wrap(lo + offset)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of ``arange(n)``
    per key row, int64 ``key.shape[:-1] + (n,)``.

    JAX's ``_shuffle``: ``ceil(3·ln(max(1, n)) / ln(2**32 - 1))`` rounds
    (float64), each splitting ``key, subkey = split(key)`` and sorting the
    array stably by ``bits(subkey, (n,))``.  One round below n = 1,626, two
    from there, three from n = 2,642,281."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(rounds):
        key, sub = split(key, 2).unbind(dim=-2)
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()


def choice(key: torch.Tensor, n: int, shape=(), replace: bool = True,
           p=None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` from ``arange(n)``:
    ``permutation(key, n)[:m]`` without replacement (m the draws of
    ``shape``), ``randint(key, shape, 0, n)`` with it.  int64
    ``key.shape[:-1] + shape``."""
    if p is not None:
        raise NotImplementedError(
            "choice(p=...) is not ported: the JAX package never draws a "
            "weighted choice")
    shape = tuple(shape)
    m = math.prod(shape)
    if n <= 0 and m:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if replace:
        return randint(key, shape, 0, n)
    if m > n:
        raise ValueError(
            f"Cannot take a larger sample (size {m}) than population (size "
            f"{n}) when 'replace=False'")
    perm = permutation(key, n)[..., :m]
    return perm.reshape(key.shape[:-1] + shape)
