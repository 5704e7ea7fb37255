"""Plain PyTorch versions of the compressor kernels.

Each function computes exactly what its kernel in ``csrc/compressor.cu``
computes, with the reference's expressions (``repro.core.compressors``:
``_dither``, ``_topk``, ``spec_bits``) in the reference's order.  They are
what a CPU tensor runs, what the tests compare with the JAX reference, and
what ``chip_smoke.py`` holds each kernel against on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1, and x itself for +-0 and NaN (``torch.sign``
    maps -0 and NaN to +0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def ceil_log2(t: torch.Tensor) -> torch.Tensor:
    """ceil(log2(t)) exactly for t > 1 (the bit length of ceil(t) - 1);
    the float expression otherwise, as the kernel does."""
    exact = torch.frexp(torch.ceil(t) - 1.0).exponent.to(torch.float32)
    return torch.where(t > 1.0, exact, torch.ceil(torch.log2(t)))


def dither_bits_ref(s, d, device) -> torch.Tensor:
    """⌈log2(2s+1)⌉·d payload bits (float32, 0-d)."""
    return ceil_log2(2.0 * _f32(s, device) + 1.0) * _f32(d, device)


def topk_bits_ref(frac, d, device) -> torch.Tensor:
    """clip(⌈frac·d⌉, 1, d)·(32 + ⌈log2 max(d, 1)⌉) payload bits."""
    d_t = _f32(d, device)
    one = _f32(1.0, device)
    kept = torch.minimum(torch.maximum(torch.ceil(_f32(frac, device) * d_t),
                                       one), d_t)
    return kept * (32.0 + ceil_log2(torch.maximum(d_t, one)))


def topk_keep_count(frac, L: int) -> int:
    """k = clip(⌈frac·L⌉, 1, L), with frac·L rounded in float32."""
    return int(np.clip(np.ceil(np.float32(frac) * np.float32(L)), 1, L))


def fused_dither_ref(x: torch.Tensor, u: torch.Tensor, s):
    """Random ∞-norm dithering of each row of x [n, L] with uniforms u:
    returns (out [n, L], payload bits [n])."""
    s_t = _f32(s, x.device)
    ax = x.abs()
    norm = ax.amax(dim=1, keepdim=True)
    norm = torch.where(norm == 0, 1.0, norm)
    y = ax / norm * s_t                          # in [0, s]
    lo = torch.floor(y)
    p = y - lo                                   # P(round up)
    level = lo + (u < p).to(torch.float32)
    out = sign(x) * level * norm / s_t
    bits = dither_bits_ref(s, x.shape[1], x.device).expand(x.shape[0])
    return out, bits.clone()


def fused_dither_keyed_ref(x: torch.Tensor, key: torch.Tensor, s):
    """``fused_dither_ref`` with row i's uniforms drawn from
    ``random.split(key, n)[i]``: what the keyed kernel draws in
    registers."""
    keys = random.split(key, x.shape[0])
    return fused_dither_ref(x, random.uniform(keys, (x.shape[1],)), s)


def fused_topk_ref(x: torch.Tensor, frac):
    """Top-k of each row of x [n, L]: the k largest |x| plus the
    lowest-index ties, the rest zeroed; returns (out, payload bits [n])."""
    n, L = x.shape
    k = topk_keep_count(frac, L)
    ax = x.abs()
    thresh = torch.sort(ax, dim=1).values[:, L - k:L - k + 1]   # k-th largest
    above = ax > thresh
    n_above = above.sum(dim=1, keepdim=True)
    ties = ax == thresh
    tie_rank = torch.cumsum(ties.to(torch.int64), dim=1)        # 1-based
    keep = above | (ties & (tie_rank <= k - n_above))
    out = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    bits = topk_bits_ref(frac, L, x.device).expand(n)
    return out, bits.clone()
