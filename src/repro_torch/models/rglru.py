"""RG-LRU recurrent block (counterpart of ``repro.models.rglru``;
RecurrentGemma / Griffin, arXiv:2402.19427).

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
a_t = sigmoid(Λ)^(c·r_t) (log-space, c = 8), r_t, i_t = sigmoid(linear(x_t)).

The reference's ``associative_scan`` over time becomes a sequential scan,
one fused multiply-add a step (``torch.addcmul``) over [B, W]: the same
recurrence with another order of combination, held to the reference by
tolerance.  Plain PyTorch on both devices (the reference computes the scan
outside any Pallas kernel).  Decode carries (h, the conv state).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random
from repro_torch.models.layers import causal_conv1d, init_normal

_C = 8.0


def init_rglru(key, cfg, dtype):
    """The reference's ``init_rglru`` key tree (``split(key, 6)``); Λ is
    computed in numpy float64 and cast to float32 once, as there."""
    D = cfg.d_model
    W = cfg.rglru.lru_width or D
    ks = random.split(key, 6)
    s = 1.0 / np.sqrt(D)
    sw = 1.0 / np.sqrt(W)
    lam = np.log(np.exp(-np.log(np.linspace(0.9, 0.999, W)) / _C) - 1.0) * -1.0
    return {
        "w_in": init_normal(ks[0], (D, W), s, dtype),
        "w_gate_branch": init_normal(ks[1], (D, W), s, dtype),
        "conv_w": init_normal(ks[2], (cfg.rglru.conv_width, W), 0.1, dtype),
        "w_r": init_normal(ks[3], (W, W), sw, dtype),
        "w_i": init_normal(ks[4], (W, W), sw, dtype),
        "lam": torch.as_tensor(lam.astype(np.float32), device=key.device),
        "w_out": init_normal(ks[5], (W, D), sw, dtype),
    }


def _gates(params, x):
    """x: [..., W] (after the conv).  Returns (log_a, gated input), float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_r"].float())
    i = torch.sigmoid(xf @ params["w_i"].float())
    log_a = _C * r * F.logsigmoid(params["lam"].float())
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * (i * xf)


def linear_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over t for a, b [B, S, W] float32 from h0
    [B, W] (zeros if None): every h_t, [B, S, W].  One ``addcmul`` a step
    (differentiable: the training path runs it too), on [S, B, W] copies so
    each step reads contiguous rows."""
    B, S, W = b.shape
    a_t, b_t = a.transpose(0, 1).contiguous(), b.transpose(0, 1).contiguous()
    h = (torch.zeros((B, W), dtype=b.dtype, device=b.device) if h0 is None
         else h0.to(b.dtype))
    hs = []
    for t in range(S):
        h = torch.addcmul(b_t[t], a_t[t], h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_forward(params, x, cfg, *, h0=None, conv_state=None):
    """Full-sequence recurrent block.  x: [B, S, D] -> (y, (h_last [B, W]
    float32, conv state)); ``h0`` [B, W] carries a previous segment's state
    (the reference's virtual step 0)."""
    u = x @ params["w_in"]
    u, conv_state = causal_conv1d(u, params["conv_w"], conv_state)
    log_a, b = _gates(params, u)
    h = linear_scan(torch.exp(log_a), b, h0)
    gate = F.gelu(x @ params["w_gate_branch"], approximate="tanh")
    y = h.to(x.dtype) * gate
    return y @ params["w_out"], (h[:, -1], conv_state)


def rglru_decode(params, x, cache, cfg):
    """One-token decode.  x: [B, 1, D]; cache {"state" [B, W] float32,
    "conv"}, updated in place and returned."""
    u = x @ params["w_in"]
    u, conv = causal_conv1d(u, params["conv_w"], cache["conv"])
    log_a, b = _gates(params, u[:, 0])
    h = torch.exp(log_a) * cache["state"].float() + b
    gate = F.gelu((x @ params["w_gate_branch"])[:, 0], approximate="tanh")
    y = h.to(x.dtype) * gate
    cache["state"].copy_(h)
    cache["conv"].copy_(conv)
    return (y @ params["w_out"])[:, None], cache
