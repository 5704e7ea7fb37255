"""DeepSeek-V3 multi-head latent attention (counterpart of
``repro.models.mla``).

The cache is the per-token compressed KV latent ``c_kv`` [B, S, r_kv] and
the shared rotary key ``k_rope`` [B, S, d_rope].  The full sequence expands
the latent into per-head keys (qk_nope + qk_rope wide) and values
(v_head_dim wide) and goes through the flash-attention forward at that
(Dk, Dv) pair, (192, 128) at deepseek-v3's width: the kernel on the card,
its plain version on the CPU.  Decode uses the absorbed form (queries
folded into the latent space) in plain torch, as the reference computes it
outside any kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import NEG
from repro_torch.models.attention import _out_proj, _project
from repro_torch.models.layers import apply_rope, init_normal, rms_norm


def init_mla(key, cfg, dtype):
    """The reference's ``init_mla`` key tree (``split(key, 6)``)."""
    D, H = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ks = random.split(key, 6)
    s = lambda fan: 1.0 / np.sqrt(fan)                      # noqa: E731
    zeros = lambda n: torch.zeros(n, dtype=dtype,           # noqa: E731
                                  device=key.device)
    return {
        "wq_a": init_normal(ks[0], (D, rq), s(D), dtype),
        "q_norm": zeros(rq),
        "wq_b": init_normal(ks[1], (rq, H, dn + dr), s(rq), dtype),
        "wkv_a": init_normal(ks[2], (D, rkv + dr), s(D), dtype),
        "kv_norm": zeros(rkv),
        "wk_b": init_normal(ks[3], (rkv, H, dn), s(rkv), dtype),
        "wv_b": init_normal(ks[4], (rkv, H, dv), s(rkv), dtype),
        "wo": init_normal(ks[5], (H, dv, D), s(H * dv), dtype),
    }


def _latents(params, x, cfg, positions):
    """x -> (q_nope, q_rope [B, S, H, *], c_kv [B, S, r_kv], k_rope
    [B, S, d_rope])."""
    dn, rkv = cfg.qk_nope_dim, cfg.kv_lora_rank
    q_lat = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = _project(q_lat, params["wq_b"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_base)
    kv = x @ params["wkv_a"]
    c_kv = rms_norm(kv[..., :rkv], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, rkv:], positions, cfg.rope_base)[..., 0,
                                                                      :]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(params, x, cfg, *, positions=None):
    """Full-sequence MLA (naive expansion).  x: [B, S, D].  Returns the
    output and the latents prefill caches, c_kv and k_rope."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _latents(params, x, cfg, positions)
    k_nope = _project(c_kv, params["wk_b"])
    v = _project(c_kv, params["wv_b"])
    H = cfg.n_heads
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, -1)],
                  dim=-1)
    o = ops.attention(q, k, v)
    return _out_proj(o, params["wo"]), c_kv, k_rope


def mla_decode(params, x, cache, pos: int, cfg):
    """Absorbed one-token decode.  cache: {"c_kv": [B, S, r_kv], "k_rope":
    [B, S, d_rope]}, written at slot ``pos`` in place and returned."""
    B = x.shape[0]
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _latents(params, x, cfg, posb)
    cache["c_kv"][:, pos] = c_kv_new[:, 0]
    cache["k_rope"][:, pos] = k_rope_new[:, 0]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    # absorb wk_b into the query: q_lat[b, h, r] = q_nope . wk_b[r, h]
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["wk_b"])
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    ckv = c_kv.float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
         + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(),
                        k_rope.float())) * scale
    S = c_kv.shape[1]
    s = torch.where(torch.arange(S, device=x.device) <= pos, s, NEG)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, ckv)
    o = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), params["wv_b"])
    out = torch.einsum("bhv,hvd->bd", o, params["wo"])[:, None, :]
    return out, cache
