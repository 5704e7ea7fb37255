"""Mamba-2 SSD mixer (counterpart of ``repro.models.ssm``) [arXiv:2405.21060].

Chunked SSD: the intra-chunk quadratic term plus the inter-chunk state
recurrence, the reference's ``lax.scan`` over chunks a Python loop here.
Decode carries (the float32 state, the conv states).  Plain PyTorch on
both devices: the reference computes the SSD outside any Pallas kernel.

The reference's four-operand einsums are split into explicit two-operand
steps, each a batched matmul or an elementwise product, so no step builds
``[B, nc, H, Q, Q, P]`` (17 GB in float32 at mamba2-1.3b's width and
8 × 1024 tokens); the tests hold the result to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random
from repro_torch.models.layers import (causal_conv1d, init_normal, rms_norm,
                                       silu)


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.d_state


def init_ssm(key, cfg, dtype):
    """The reference's ``init_ssm`` key tree (``split(key, 9)``); A_log,
    dt_bias and D_skip stay float32 whatever ``dtype`` is."""
    s = cfg.ssm
    d_inner, H, _, N = _dims(cfg)
    D = cfg.d_model
    ks = random.split(key, 9)
    sc = 1.0 / np.sqrt(D)
    f32 = dict(dtype=torch.float32, device=key.device)
    a_log = np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))
    div = torch.tensor(np.sqrt(d_inner), **f32)
    return {
        "in_z": init_normal(ks[0], (D, d_inner), sc, dtype),
        "in_x": init_normal(ks[1], (D, d_inner), sc, dtype),
        "in_B": init_normal(ks[2], (D, N), sc, dtype),
        "in_C": init_normal(ks[3], (D, N), sc, dtype),
        "in_dt": init_normal(ks[4], (D, H), sc, dtype),
        "conv_x": init_normal(ks[5], (s.conv_width, d_inner), 0.1, dtype),
        "conv_B": init_normal(ks[6], (s.conv_width, N), 0.1, dtype),
        "conv_C": init_normal(ks[7], (s.conv_width, N), 0.1, dtype),
        "A_log": torch.as_tensor(a_log.astype(np.float32), **f32),
        "dt_bias": torch.zeros(H, **f32),
        "D_skip": torch.ones(H, **f32),
        "norm": torch.zeros(d_inner, dtype=dtype, device=key.device),
        "out_proj": random.normal_cast(ks[8], (d_inner, D), dtype,
                                       lambda z: z / div),
    }


def _segsum(a):
    """a: [..., Q] -> [..., Q, Q]: out[i, j] = sum(a[j+1..i]) for i >= j,
    -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_scan(xh, dt, A_log, B_mat, C_mat, chunk, init_state=None):
    """Chunked SSD.  xh: [B, S, H, P]; dt: [B, S, H]; B_mat, C_mat:
    [B, S, N].  Returns (y [B, S, H, P], final state [B, H, P, N]), both
    float32.  The chunk is the largest divisor of S not above ``chunk``."""
    Bb, S, H, P = xh.shape
    N = B_mat.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    A = -torch.exp(A_log.float())                            # [H]
    a = dt.float() * A                                       # [B, S, H]
    xdt = xh.float() * dt.float()[..., None]

    a_c = a.reshape(Bb, nc, Q, H).transpose(2, 3)            # [B, nc, H, Q]
    x_c = xdt.reshape(Bb, nc, Q, H, P)
    B_c = B_mat.float().reshape(Bb, nc, Q, N)
    C_c = C_mat.float().reshape(Bb, nc, Q, N)

    # intra-chunk: y[l] = sum_s (C_l . B_s) L[h, l, s] x[s, h]
    L = torch.exp(_segsum(a_c))                              # [B, nc, H, Q, Q]
    cb = torch.einsum("bcln,bcsn->bcls", C_c, B_c)           # [B, nc, Q, Q]
    y_diag = torch.einsum("bchls,bcshp->bclhp", L * cb[:, :, None], x_c)
    # per-chunk end states: sum_s B_s exp(a_tail[s]) x[s]
    a_cum = torch.cumsum(a_c, dim=-1)                        # [B, nc, H, Q]
    a_tail = a_cum[..., -1:] - a_cum
    xs = x_c * torch.exp(a_tail).transpose(2, 3)[..., None]  # [B,nc,Q,H,P]
    states = torch.einsum("bcshp,bcsn->bchpn", xs, B_c)      # [B,nc,H,P,N]
    # inter-chunk recurrence, the state entering each chunk
    decay = torch.exp(a_cum[..., -1])                        # [B, nc, H]
    s = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                    # [B,nc,H,P,N]
    # y[l] += exp(a_cum[h, l]) (C_l . s_prev[h])
    cs = torch.einsum("bcln,bchpn->bclhp", C_c, s_prevs)
    y_off = cs * torch.exp(a_cum).transpose(2, 3)[..., None]
    y = (y_diag + y_off).reshape(Bb, S, H, P)
    return y, s


def _project(params, x):
    return (x @ params["in_z"], x @ params["in_x"], x @ params["in_B"],
            x @ params["in_C"], x @ params["in_dt"])


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_forward(params, x, cfg, *, state=None, conv_state=None):
    """Full-sequence mixer.  x: [B, S, D] -> (y [B, S, D], (state,
    {"x", "B", "C"} conv states))."""
    d_inner, H, P, _ = _dims(cfg)
    B, S = x.shape[:2]
    z, xin, B_in, C_in, dt = _project(params, x)
    cs = conv_state or {"x": None, "B": None, "C": None}
    xin, cx = causal_conv1d(xin, params["conv_x"], cs["x"])
    B_in, cb = causal_conv1d(B_in, params["conv_B"], cs["B"])
    C_in, cc = causal_conv1d(C_in, params["conv_C"], cs["C"])
    xin, B_in, C_in = silu(xin), silu(B_in), silu(C_in)
    xh = xin.reshape(B, S, H, P)
    dt = _softplus(dt.float() + params["dt_bias"])
    y, state = ssd_scan(xh, dt, params["A_log"], B_in, C_in, cfg.ssm.chunk,
                        init_state=state)
    y = y + params["D_skip"][:, None] * xh.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    return out, (state, {"x": cx, "B": cb, "C": cc})


def ssm_decode(params, x, cache, cfg):
    """One-token decode.  x: [B, 1, D]; cache {"state" [B, H, P, N]
    float32, "conv_x", "conv_B", "conv_C"}, updated in place and
    returned (the reference returns an updated copy)."""
    d_inner, H, P, _ = _dims(cfg)
    z, xin, B_in, C_in, dt = _project(params, x)
    xin, cx = causal_conv1d(xin, params["conv_x"], cache["conv_x"])
    B_in, cb = causal_conv1d(B_in, params["conv_B"], cache["conv_B"])
    C_in, cc = causal_conv1d(C_in, params["conv_C"], cache["conv_C"])
    xin, B_in, C_in = silu(xin), silu(B_in), silu(C_in)
    xh = xin[:, 0].reshape(-1, H, P).float()
    B1 = B_in[:, 0].float()
    C1 = C_in[:, 0].float()
    dt1 = _softplus(dt[:, 0].float() + params["dt_bias"])   # [B, H]
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt1 * A)
    h = (cache["state"] * decay[..., None, None]
         + (dt1[..., None] * xh)[..., None] * B1[:, None, None, :])
    y = (h @ C1[:, None, :, None])[..., 0]                   # [B, H, P]
    y = y + params["D_skip"][:, None] * xh
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    for name, new in (("state", h), ("conv_x", cx), ("conv_B", cb),
                      ("conv_C", cc)):
        cache[name].copy_(new)
    return out, cache
