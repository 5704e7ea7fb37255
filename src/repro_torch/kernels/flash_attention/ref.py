"""Plain PyTorch version of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ref``): the CPU path of ``ops.py`` and the
oracle the card's kernel is held to."""
from __future__ import annotations

import math

import torch

#: The reference's mask value: finite, so a fully masked row gives
#: exp(NEG - NEG) = 1 rather than NaN.
NEG = -1e30


def attention_ref(q, k, v, window: int = 0, cap: float = 0.0):
    """q: [B, H, S, D]; k/v: [B, KV, S, D] (kernel layout), causal with query
    i at key position i; optional sliding window and tanh soft-cap.  Float32
    arithmetic; the result is in q's type."""
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
    return o.reshape(B, H, Sq, D).to(q.dtype)
