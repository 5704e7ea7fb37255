"""Shared building blocks (counterpart of ``repro.models.layers``).

Parameters are plain dictionaries of tensors with the reference's keys and
shapes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from repro_torch import random


def rms_norm(x, scale, eps=1e-6):
    """RMS norm with the reference's ``(1 + scale)`` gain (zero-initialised
    scales are the identity), computed in float32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return ((1.0 + scale.float()) * out).to(x.dtype)


def softcap(x, cap):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


class _SiLU(torch.autograd.Function):
    """silu whose backward forward AD can differentiate: ``aten::
    silu_backward`` has no forward-AD formula, so a Hessian-vector product
    (``core/hessian.py``) could not pass ``F.silu``'s backward.  The forward
    is ``F.silu``; the backward g·s·(1 + x(1 − s)) (s = sigmoid(x)) in
    plain ops, which forward AD differentiates; ``jvp`` is the same
    derivative times the tangent."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return F.silu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * s * (1 + x * (1 - s))

    @staticmethod
    def jvp(ctx, tx):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return tx * s * (1 + x * (1 - s))


def silu(x):
    """``F.silu``, and under a forward-AD dual level (a Hessian-vector
    product) ``_SiLU``, whose backward forward AD can pass.  Only under a
    dual level: ``_SiLU``'s backward is not ``aten::silu_backward`` bit for
    bit, and the standard and first-order FLECS-CGD steps keep the bits
    they had."""
    if fwAD._current_level >= 0:
        return _SiLU.apply(x)
    return F.silu(x)


def act_fn(name):
    return {"silu": silu,
            "gelu": lambda v: F.gelu(v, approximate="tanh")}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, base: float):
    """Inverse frequencies in numpy float32, as the reference builds them."""
    half = head_dim // 2
    return 1.0 / (base ** (np.arange(0, half, dtype=np.float32) * 2.0
                           / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, base: float, device: torch.device):
    """``rope_freqs`` on ``device``, copied there once: a copy from pageable
    host memory synchronises the stream, which at two a layer would stall
    every decode step."""
    return torch.as_tensor(rope_freqs(head_dim, base), device=device)


def apply_rope(x, positions, base: float):
    """x: [..., S, H, dh]; positions: int tensor broadcastable to [..., S]."""
    inv = _inv_freqs(x.shape[-1], base, x.device)
    ang = positions[..., :, None].float() * inv           # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                 # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Depthwise causal conv (mamba2 / RG-LRU temporal conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: [B, S, C]; w: [K, C]; ``state`` [B, K-1,
    C] the trailing inputs of the previous segment (zeros if None).
    Returns (y [B, S, C] in x's type, the new state: the trailing K-1
    inputs).  The taps are summed as the reference sums them, from 0, then
    tap 0, 1, ... in x's type, so a bfloat16 x rounds where it rounds."""
    K = w.shape[0]
    S = x.shape[-2]
    if state is None:
        state = torch.zeros(x.shape[:-2] + (K - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=-2)        # [B, S+K-1, C]
    y = 0
    for i in range(K):
        y = y + xp[..., i:i + S, :] * w[i]
    return y.to(x.dtype), xp[..., S:, :]


# ---------------------------------------------------------------------------
# Dense (gated) FFN
# ---------------------------------------------------------------------------

def init_normal(key, shape, scale, dtype):
    """``(normal(key, shape) * scale).astype(dtype)``, the reference's
    init of a leaf (scale taken in float32), drawn and cast a slice at a
    time (:func:`repro_torch.random.normal_cast`)."""
    s = np.float32(scale)
    return random.normal_cast(key, shape, dtype, lambda z: z * s)


def init_ffn(key, d_model, d_ff, dtype):
    """The reference's ``init_ffn`` key tree (``split(key, 3)``) through
    :func:`repro_torch.random.normal`."""
    k1, k2, k3 = random.split(key, 3)
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)
    return {
        "w_gate": init_normal(k1, (d_model, d_ff), s_in, dtype),
        "w_up": init_normal(k2, (d_model, d_ff), s_in, dtype),
        "w_down": init_normal(k3, (d_ff, d_model), s_out, dtype),
    }


def ffn(params, x, act: str):
    g = act_fn(act)(x @ params["w_gate"])
    u = x @ params["w_up"]
    return (g * u) @ params["w_down"]
