"""Plain PyTorch version of the int8 dither codec (counterpart of
``repro.kernels.dither.ref``): the CPU path of ``ops.py`` and the oracle the
card's kernels are held to.

Q(x): per-block ∞-norm random dithering to s levels, an int8 level per
element and a float32 scale per block of ``block_rows`` rows, bit for bit
the reference's given the same uniforms.  The keyed encode's split entries
have theirs too: the norms merged into int32 bits (``absmax_bits``,
``dither_absmax_into_ref``), then the levels from given norms
(``dither_levels_ref``, ``dither_levels_keyed_ref``).
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


def _levels(xb, ub, norm, s):
    """The levels of blocks xb [nb, block_rows, C] and the scales from
    their norms [nb] (0 -> 1) and uniforms ub of xb's shape."""
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    y = xb / norm[:, None, None] * s
    lo = torch.floor(y)
    return to_int8(lo + (ub < (y - lo)).float()), (norm / s).float()


def dither_encode_ref(x, u, s, block_rows: int):
    """x, u: [R, C] (u uniform on [0, 1), float32; x float32 or bfloat16);
    returns (levels int8 [R, C], scale float32 [R // block_rows])."""
    R, C = x.shape
    nb = R // block_rows
    xb = x.reshape(nb, block_rows, C).float()
    levels, scale = _levels(xb, u.reshape(nb, block_rows, C),
                            torch.amax(xb.abs(), dim=(1, 2)), s)
    return levels.reshape(R, C), scale


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


def absmax_bits(x, block_rows: int) -> torch.Tensor:
    """The int32 bits of max |x| over each block of ``block_rows`` rows of
    x [R, C]: [R // block_rows].  For non-negative floats the bits order as
    the values do, so their maximum is the norm's bits."""
    R, C = x.shape
    bits = x.float().reshape(R // block_rows, -1).view(torch.int32)
    return (bits & 0x7FFFFFFF).amax(dim=1)


def dither_absmax_into_ref(x, norm_bits, block_rows: int):
    """``norm_bits = max(norm_bits, absmax_bits(x))`` in place: pass 1 of
    the keyed encode merged into a caller's int32 [R // block_rows]."""
    return torch.maximum(norm_bits, absmax_bits(x, block_rows),
                         out=norm_bits)


def dither_levels_ref(x, u, norm_bits, s, block_rows: int):
    """The levels of x [R, C] and the scales from given norms (int32 bits
    [R // block_rows]) and uniforms u of x's shape."""
    R, C = x.shape
    nb = R // block_rows
    levels, scale = _levels(x.reshape(nb, block_rows, C).float(),
                            u.reshape(nb, block_rows, C),
                            norm_bits.view(torch.float32), s)
    return levels.reshape(R, C), scale


def dither_levels_keyed_ref(x, key, norm_bits, s, block_rows: int):
    """Pass 2 of the keyed encode from given norms: ``dither_levels_ref``
    with the uniforms ``random.uniform(key, x.shape)``, what the kernel
    draws in registers."""
    return dither_levels_ref(x, random.uniform(key, tuple(x.shape)),
                             norm_bits, s, block_rows)
