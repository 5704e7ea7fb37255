"""Plain PyTorch version of the int8 dither codec (counterpart of
``repro.kernels.dither.ref``): the CPU path of ``ops.py`` and the oracle the
card's kernels are held to.

Q(x): per-block ∞-norm random dithering to s levels, an int8 level per
element and a float32 scale per block of ``block_rows`` rows, bit for bit
the reference's given the same uniforms.
"""
from __future__ import annotations

import torch

from repro_torch import random


def to_int8(v: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int8 conversion, which the reference's
    ``astype(jnp.int8)`` compiles to: NaN -> 0, then saturation to
    [-128, 127].  ``torch``'s ``.to(torch.int8)`` wraps instead
    (300 -> 44), and levels pass 127 whenever s > 127."""
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return v.clamp(-128.0, 127.0).to(torch.int8)


def dither_encode_ref(x, u, s, block_rows: int):
    """x, u: [R, C] (u uniform on [0, 1), float32; x float32 or bfloat16);
    returns (levels int8 [R, C], scale float32 [R // block_rows])."""
    R, C = x.shape
    nb = R // block_rows
    xb = x.reshape(nb, block_rows, C).float()
    norm = torch.amax(xb.abs(), dim=(1, 2))
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    y = xb / norm[:, None, None] * s
    lo = torch.floor(y)
    ub = u.reshape(nb, block_rows, C)
    levels = to_int8(lo + (ub < (y - lo)).float())
    return levels.reshape(R, C), (norm / s).float()


def dither_encode_keyed_ref(x, key, s, block_rows: int):
    """``dither_encode_ref`` with the uniforms ``random.uniform(key,
    x.shape)``: what the keyed kernel draws in registers."""
    return dither_encode_ref(x, random.uniform(key, tuple(x.shape)), s,
                             block_rows)


def dither_decode_ref(levels, scale, block_rows: int):
    """levels int8 [R, C], scale float32 [R // block_rows] -> float32."""
    R, C = levels.shape
    nb = R // block_rows
    lb = levels.reshape(nb, block_rows, C).float()
    return (lb * scale[:, None, None]).reshape(R, C)
