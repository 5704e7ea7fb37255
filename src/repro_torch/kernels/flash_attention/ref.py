"""Plain PyTorch versions of the flash-attention kernels (counterpart of
``repro.kernels.flash_attention.ref``): the CPU path of ``ops.py`` and the
oracles the card's kernels are held to.

Beside the forward, the two tangent kernels' plain versions, written from
their formulas (the notation of ``csrc/flash_attention_jvp.cu``):
S0 = scale·QKᵀ, S = cap·tanh(S0/cap) (or S0), masked; P = exp(S − lse);
c′ = 1 − tanh²(S0/cap) (or 1).  ``attention_jvp_ref`` is the forward's
tangent, ``attention_backward_jvp_ref`` the backward's (the tangents of
dQ, dK and dV), both in float32 and in the kernel layout [B, H, S, D].
"""
from __future__ import annotations

import math

import torch

#: The reference's mask value: finite, so a fully masked row gives
#: exp(NEG - NEG) = 1 rather than NaN.
NEG = -1e30


def attention_ref(q, k, v, window: int = 0, cap: float = 0.0):
    """q: [B, H, S, Dk]; k: [B, KV, S, Dk]; v: [B, KV, S, Dv] (kernel
    layout), causal with query i at key position i, scaled by 1/sqrt(Dk);
    optional sliding window and tanh soft-cap.  Float32 arithmetic; the
    result [B, H, S, Dv] is in q's type."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def _pairs(q, k, tq, tk, window, cap):
    """Per (query, key) pair of every [B, KV, G] group, in float32: the
    masked scores S, S0's tangent tS0, c′ and, with a cap, tanh(S0/cap);
    and the mask."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, H // KV, Sq, D).float()
    tqg = tq.reshape(B, KV, H // KV, Sq, D).float()
    s0 = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    ts0 = (torch.einsum("bkgqd,bksd->bkgqs", tqg, k.float())
           + torch.einsum("bkgqd,bksd->bkgqs", qg, tk.float())) * scale
    th = torch.tanh(s0 / cap) if cap else None
    s = cap * th if cap else s0
    c1 = 1.0 - th * th if cap else torch.ones_like(s0)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    return torch.where(mask, s, NEG), ts0, c1, th, mask


def attention_jvp_ref(q, k, v, tq, tk, tv, window: int = 0,
                      cap: float = 0.0):
    """The forward and its tangent along (tq, tk, tv): (out, tout, lse,
    tlse), out and tout [B, H, S, D], lse and tlse [B, H, S], float32.

    tS = c′·tS0, t_lse = Σⱼ P tS, tP = P ⊙ (tS − t_lse), tO = tP V + P tV.
    """
    B, H, S, D = q.shape
    s, ts0, c1, _, mask = _pairs(q, k, tq, tk, window, cap)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    ts = torch.where(mask, c1 * ts0, 0.0)
    tlse = torch.sum(p * ts, dim=-1)
    tp = p * (ts - tlse[..., None])
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    to = (torch.einsum("bkgqs,bksd->bkgqd", tp, v.float())
          + torch.einsum("bkgqs,bksd->bkgqd", p, tv.float()))
    return (o.reshape(B, H, S, D), to.reshape(B, H, S, D),
            lse.reshape(B, H, S), tlse.reshape(B, H, S))


def attention_backward_jvp_ref(q, k, v, out, dout, lse, tq, tk, tv, tout,
                               tdout, tlse, window: int = 0,
                               cap: float = 0.0):
    """The tangents (tdq, tdk, tdv) of the backward's dQ, dK and dV along
    the tangents of q, k, v, out, dout and lse (lse and tlse [B, H, S];
    the rest [B, H or KV, S, D]), float32, GQA groups summed into KV heads.

    The backward: D = rowsum(dO ⊙ O), dP = dO Vᵀ, dS = P ⊙ (dP − D),
    dS0 = c′ dS, dQ = scale·dS0 K, dK = scale·dS0ᵀ Q, dV = Pᵀ dO.  Its
    tangents: tdP = tdO Vᵀ + dO tVᵀ, tD = rowsum(tdO ⊙ O + dO ⊙ tO),
    tdS = tP ⊙ (dP − D) + P ⊙ (tdP − tD), tdS0 = c′ tdS + dS c″ tS0 with
    c″ = −2 tanh(S0/cap) c′ / cap, tdQ = scale(tdS0 K + dS0 tK),
    tdK = scale(tdS0ᵀ Q + dS0ᵀ tQ), tdV = tPᵀ dO + Pᵀ tdO."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D)

    def grouped(t):
        return t.reshape(B, KV, G, S, -1).float()

    s, ts0, c1, th, mask = _pairs(q, k, tq, tk, window, cap)
    qg, tqg, og, tog, dog, tdog = map(grouped, (q, tq, out, tout, dout,
                                                tdout))
    lse_g, tlse_g = grouped(lse)[..., 0], grouped(tlse)[..., 0]
    kf, tkf, vf, tvf = (t.float() for t in (k, tk, v, tv))
    p = torch.exp(s - lse_g[..., None])
    ts = torch.where(mask, c1 * ts0, 0.0)
    tp = p * (ts - tlse_g[..., None])
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    tdp = (torch.einsum("bkgqd,bksd->bkgqs", tdog, vf)
           + torch.einsum("bkgqd,bksd->bkgqs", dog, tvf))
    delta = torch.sum(dog * og, dim=-1)[..., None]
    tdelta = torch.sum(tdog * og + dog * tog, dim=-1)[..., None]
    ds = p * (dp - delta)
    tds = tp * (dp - delta) + p * (tdp - tdelta)
    tds0 = c1 * tds
    if cap:
        tds0 = tds0 + ds * (-2.0 * th * c1 / cap) * ts0
    ds0 = c1 * ds
    tdq = scale * (torch.einsum("bkgqs,bksd->bkgqd", tds0, kf)
                   + torch.einsum("bkgqs,bksd->bkgqd", ds0, tkf))
    tdk = scale * (torch.einsum("bkgqs,bkgqd->bksd", tds0, qg)
                   + torch.einsum("bkgqs,bkgqd->bksd", ds0, tqg))
    tdv = (torch.einsum("bkgqs,bkgqd->bksd", tp, dog)
           + torch.einsum("bkgqs,bkgqd->bksd", p, tdog))
    return tdq.reshape(B, H, S, D), tdk, tdv
