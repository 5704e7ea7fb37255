"""GQA attention sub-layer (counterpart of ``repro.models.attention``).

Full-sequence attention goes through ``kernels.flash_attention.ops.attention``:
the hand-written kernel on the card, its plain version on the CPU.  Decode
attention against the cache stays plain torch, as the reference computes it
outside any Pallas kernel.  The reference's ``chunked_attention`` has no copy
here: its counterpart is ``kernels/flash_attention/ref.attention_ref``, and
the tests hold the two against each other.

Only the single-device path is ported (``seq_shard=False``): the
sequence-sharded decode needs a mesh and comes with the sharded slice.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import NEG
from repro_torch.models.layers import apply_rope, init_normal, softcap


def init_attn(key, cfg, dtype):
    """The reference's ``init_attn`` key tree (``split(key, 4)``)."""
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = random.split(key, 4)
    s = 1.0 / np.sqrt(D)
    so = 1.0 / np.sqrt(H * Dh)
    return {
        "wq": init_normal(ks[0], (D, H, Dh), s, dtype),
        "wk": init_normal(ks[1], (D, KV, Dh), s, dtype),
        "wv": init_normal(ks[2], (D, KV, Dh), s, dtype),
        "wo": init_normal(ks[3], (H, Dh, D), so, dtype),
    }


def _project(x, w):
    """x [B, S, D] by w [D, H, Dh] -> contiguous [B, S, H, Dh]."""
    out = x @ w.reshape(w.shape[0], -1)
    return out.view(*x.shape[:-1], *w.shape[1:])


def _out_proj(o, wo):
    """o [B, S, H, Dh] by wo [H, Dh, D] -> [B, S, D]."""
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def qkv(params, x, cfg, positions):
    """Projections and RoPE: q [B, S, H, Dh], k and v [B, S, KV, Dh]."""
    q = apply_rope(_project(x, params["wq"]), positions, cfg.rope_base)
    k = apply_rope(_project(x, params["wk"]), positions, cfg.rope_base)
    return q, k, _project(x, params["wv"])


def attn_forward(params, x, cfg, *, window=0, positions=None):
    """Full-sequence causal attention sub-layer.  x: [B, S, D].  Returns
    the output and the roped k and v (which prefill caches)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = qkv(params, x, cfg, positions)
    o = ops.attention(q, k, v, window=window, cap=cfg.attn_softcap)
    return _out_proj(o, params["wo"]), k, v


def attend_cache(q, k_cache, v_cache, n_valid: int, *, cap=0.0):
    """Single-step decode attention against a cache.

    q: [B, H, Dk]; k_cache: [B, S, KV, Dk]; v_cache: [B, S, KV, Dv];
    slots ``>= n_valid`` are masked.  Returns [B, H, Dv]."""
    B, S, KV, Dk = k_cache.shape
    Dv = v_cache.shape[-1]
    H = q.shape[1]
    qg = q.reshape(B, KV, H // KV, Dk).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * (
        1.0 / math.sqrt(Dk))
    s = softcap(s, cap)
    valid = torch.arange(S, device=q.device) < n_valid
    s = torch.where(valid, s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = acc / p.sum(dim=-1, keepdim=True)
    return out.reshape(B, H, Dv).to(q.dtype)


def attn_decode(params, x, cache, pos: int, cfg, *, window=0):
    """One-token decode.  x: [B, 1, D]; cache: {"k", "v": [B, S, KV, Dh]}.

    Global layers write slot ``pos``; local layers a ring buffer of size
    window, slot ``pos % window`` (rope is applied before caching, so slot
    order does not matter for the scores).  Unlike the reference, which
    returns an updated copy, the cache is updated in place and returned."""
    B = x.shape[0]
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = qkv(params, x, cfg, posb)
    S = cache["k"].shape[1]
    slot = pos % S if window else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    n_valid = min(pos + 1, S) if window else pos + 1
    o = attend_cache(q[:, 0], cache["k"], cache["v"], n_valid,
                     cap=cfg.attn_softcap)
    return _out_proj(o, params["wo"])[:, None, :], cache
