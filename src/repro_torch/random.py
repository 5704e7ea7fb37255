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
* ``uniform`` is ``bitcast((bits >> 9) | 0x3F800000) - 1``.

Every function takes keys with leading batch dimensions (one key per row)
and works on CPU and CUDA tensors alike; results lie on the key's device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as ``jax.random``
    runs it.  All arguments are int64 tensors of uint32 values that
    broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The key data of ``jax.random.key(seed)``: int64 ``[0, seed]``."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64,
                        device=resolve_device(device))


def _counters(key: torch.Tensor, count: int):
    """Threefry over the flat counters 0..count-1 for every key row:
    returns (y0, y1) of shape ``key.shape[:-1] + (count,)``."""
    idx = torch.arange(count, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], idx >> 32,
                        idx & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` -> ``[..., num, 2]``."""
    y0, y1 = _counters(key, num)
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
    y0, y1 = _counters(key, math.prod(shape))
    return (y0 ^ y1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform`` on [0, 1), float32."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p=0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform < p`` (p in float32), bool."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


def rademacher(key: torch.Tensor, shape=(),
               dtype=torch.float32) -> torch.Tensor:
    """``jax.random.rademacher``: ``2 * bernoulli(key, 0.5) - 1``."""
    return (2 * bernoulli(key, 0.5, shape).to(dtype) - 1).to(dtype)
