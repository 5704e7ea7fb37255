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


def dither_bits_grouped_ref(s: torch.Tensor, d) -> torch.Tensor:
    """``dither_bits_ref`` of each level of s [G] (float32 [G])."""
    return ceil_log2(2.0 * s + 1.0) * _f32(d, s.device)


def topk_bits_ref(frac, d, device) -> torch.Tensor:
    """clip(⌈frac·d⌉, 1, d)·(32 + ⌈log2 max(d, 1)⌉) payload bits."""
    d_t = _f32(d, device)
    one = _f32(1.0, device)
    kept = torch.minimum(torch.maximum(torch.ceil(_f32(frac, device) * d_t),
                                       one), d_t)
    return kept * (32.0 + ceil_log2(torch.maximum(d_t, one)))


def topk_bits_grouped_ref(frac: torch.Tensor, d) -> torch.Tensor:
    """``topk_bits_ref`` of each fraction of frac [G] (float32 [G])."""
    d_t = _f32(d, frac.device)
    one = _f32(1.0, frac.device)
    kept = torch.minimum(torch.maximum(torch.ceil(frac * d_t), one), d_t)
    return kept * (32.0 + ceil_log2(torch.maximum(d_t, one)))


def topk_keep_count(frac, L: int) -> int:
    """k = clip(⌈frac·L⌉, 1, L), with frac·L rounded in float32."""
    return int(np.clip(np.ceil(np.float32(frac) * np.float32(L)), 1, L))


def _dither_rows(x: torch.Tensor, u: torch.Tensor, s_t: torch.Tensor):
    """The stochastic rounding of each row of x with uniforms u to s_t
    levels (a 0-d tensor, or [n, 1]: one level a row)."""
    ax = x.abs()
    norm = ax.amax(dim=1, keepdim=True)
    norm = torch.where(norm == 0, 1.0, norm)
    y = ax / norm * s_t                          # in [0, s]
    lo = torch.floor(y)
    p = y - lo                                   # P(round up)
    level = lo + (u < p).to(torch.float32)
    return sign(x) * level * norm / s_t


def fused_dither_ref(x: torch.Tensor, u: torch.Tensor, s):
    """Random ∞-norm dithering of each row of x [n, L] with uniforms u:
    returns (out [n, L], payload bits [n])."""
    out = _dither_rows(x, u, _f32(s, x.device))
    bits = dither_bits_ref(s, x.shape[1], x.device).expand(x.shape[0])
    return out, bits.clone()


def fused_dither_keyed_ref(x: torch.Tensor, key: torch.Tensor, s):
    """``fused_dither_ref`` with row i's uniforms drawn from
    ``random.split(key, n)[i]``: what the keyed kernel draws in
    registers."""
    keys = random.split(key, x.shape[0])
    return fused_dither_ref(x, random.uniform(keys, (x.shape[1],)), s)


def fused_dither_keyed_grouped_ref(x: torch.Tensor, keys: torch.Tensor,
                                   s: torch.Tensor, ids=None):
    """Grid point g of G owns rows [g·n, (g+1)·n) of x [G·n, L]: its row i
    is dithered to s[g] levels with the uniforms of
    ``random.split(keys[g], n)[i]``, or, with global row ids (int64 [n],
    shared by the points, or [G, n]), of ``random.split(keys[g], N)[id]``
    for row i's id; returns (out, payload bits [G·n])."""
    G = keys.shape[0]
    n = x.shape[0] // G
    row_keys = (random.split(keys, n) if ids is None
                else random.split_at(keys, ids)).reshape(G * n, 2)
    u = random.uniform(row_keys, (x.shape[1],))
    out = _dither_rows(x, u, s.repeat_interleave(n)[:, None])
    bits = dither_bits_grouped_ref(s, x.shape[1]).repeat_interleave(n)
    return out, bits


def fused_topk_grouped_ref(x: torch.Tensor, frac: torch.Tensor):
    """Grid point g of G keeps ⌈frac[g]·L⌉ values of each of its rows
    [g·n, (g+1)·n) of x [G·n, L]; returns (out, payload bits [G·n])."""
    n = x.shape[0] // frac.shape[0]
    outs, bits = zip(*(fused_topk_ref(x[g * n:(g + 1) * n], f)
                       for g, f in enumerate(frac.tolist())))
    return torch.cat(outs), torch.cat(bits)


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
