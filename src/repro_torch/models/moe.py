"""Mixture-of-experts FFN on one device (counterpart of
``repro.models.moe``'s ``init_moe``, ``_route`` and ``moe_ref``).

Two computations of one function, the reference's exact, dropless MoE
(``model._moe_call`` takes ``moe_ref`` on one device):

* ``moe_ref`` — the reference's per-token gather formula, the plain
  version the tests and ``chip_smoke.py`` hold the main path to.  It
  gathers each token's k experts' weights ([T, k, D, F]), 825 GB at
  qwen3's width and 8 × 1024 tokens, so it serves only a few tokens.
* ``moe_forward`` — the main path: a dropless sorted dispatch.  The T·k
  token copies are sorted by expert (stable), each expert with copies runs
  its gated MLP on them as three matmuls, and the copies' outputs return
  to token order for the weighted combine.  No capacity, no drops.

The reference computes the expert products outside any Pallas kernel, and
so do these (``torch.matmul``).  The router loss follows Switch:
E · sum(fraction_e · prob_e).  Shared experts are added by the caller.
The reference's ``moe_sorted`` and ``moe_fshard`` need a mesh and come with
the sharded tooling (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random
from repro_torch.models.layers import act_fn, init_ffn, init_normal


def init_moe(key, cfg, dtype):
    """The reference's ``init_moe`` key tree (``split(key, 5)``); the
    router stays float32."""
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_ff
    ks = random.split(key, 5)
    s_in, s_out = 1.0 / np.sqrt(D), 1.0 / np.sqrt(F)
    p = {
        "router": init_normal(ks[0], (D, E), s_in, torch.float32),
        "w_gate": init_normal(ks[1], (E, D, F), s_in, dtype),
        "w_up": init_normal(ks[2], (E, D, F), s_in, dtype),
        "w_down": init_normal(ks[3], (E, F, D), s_out, dtype),
    }
    if m.n_shared:
        p["shared"] = init_ffn(ks[4], D, F * m.n_shared, dtype)
    return p


def route(params, x, cfg):
    """x: [T, D] -> (weights [T, k] in x's type, ids [T, k], router loss):
    the top k of the float32 softmax of the router's logits, renormalised;
    the loss E · sum(fraction of first choices · mean probability)."""
    m = cfg.moe
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    frac = torch.bincount(ids[:, 0], minlength=m.n_experts).float() \
        / ids.shape[0]
    aux = m.n_experts * torch.sum(frac * probs.mean(dim=0))
    return w.to(x.dtype), ids, aux


def _combine(y, w):
    """sum over k of y [T, k, D] weighted by w [T, k], in y's type."""
    return torch.einsum("tkd,tk->td", y, w.float().to(y.dtype))


def moe_ref(params, x, cfg):
    """The reference's exact dropless gather formula.  x: [..., D] ->
    ([..., D], router loss)."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    w, ids, aux = route(params, xt, cfg)
    act = act_fn(cfg.act)
    g = act(torch.einsum("td,tkdf->tkf", xt, params["w_gate"][ids]))
    u = torch.einsum("td,tkdf->tkf", xt, params["w_up"][ids])
    y = torch.einsum("tkf,tkfd->tkd", g * u, params["w_down"][ids])
    return _combine(y, w).reshape(shape), aux


def moe_forward(params, x, cfg):
    """The same function as :func:`moe_ref` by a dropless sorted dispatch.
    x: [..., D] -> ([..., D], router loss).  Reads the per-expert counts
    on the host once (which experts run, and their row ranges)."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    T, k = xt.shape[0], cfg.moe.top_k
    w, ids, aux = route(params, xt, cfg)
    flat = ids.reshape(-1)                         # copy j = t * k + kk
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=cfg.moe.n_experts).tolist()
    tokens = xt[order // k]                        # copies in expert order
    act = act_fn(cfg.act)
    outs, lo = [], 0
    for e, n in enumerate(counts):
        if n:
            xs = tokens[lo:lo + n]
            h = act(xs @ params["w_gate"][e]) * (xs @ params["w_up"][e])
            outs.append(h @ params["w_down"][e])
            lo += n
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    y = torch.cat(outs)[inverse].view(T, k, -1)    # back to token order
    return _combine(y, w).reshape(shape), aux
