"""LM assembler (counterpart of ``repro.models.model``) for the layer kinds
of this slice: global and local (sliding-window) GQA attention with dense
FFNs — tinyllama, yi, gemma2/3, and llava's text path.

Parameters keep the reference's pytree: ``{"embed", "blocks", "final_norm",
"head"?}`` where ``blocks`` holds one entry per layer group
(``cfg.layer_groups()``), a list over the group's block plan of dictionaries
whose leaves are stacked ``[reps, ...]``.  Weights therefore carry across
leaf for leaf (``convert.params_from_reference``).  The reference's
``lax.scan`` over a group becomes a Python loop over the reps.  There is no
mesh yet, so the reference's ``ctx`` argument is dropped; it returns with
the sharded slice.

Three entry points, as in the reference:
  * ``forward``      — full-sequence hidden states (``remat=True`` recomputes
    each layer's activations in the backward, as ``jax.checkpoint`` does);
  * ``prefill``      — full sequence plus populated decode caches;
  * ``decode_step``  — one token against the caches, which it updates in
    place (the reference returns updated copies).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, FFN_DENSE,
                                      ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import ffn, init_ffn, rms_norm, softcap
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

#: Where the layer kinds this slice lacks come from (ROADMAP.md).
_LATER = "a later slice (ROADMAP.md, queue 1: 'other model families': " \
         "MLA, MoE, SSM, RG-LRU, VLM image embeds, audio codebooks)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a layer kind outside this slice."""
    for mixer, ffnk in cfg.layer_plan:
        if mixer not in (ATTN_GLOBAL, ATTN_LOCAL):
            raise NotImplementedError(
                f"{cfg.arch_id}: mixer {mixer!r} is not ported yet; it comes "
                f"with {_LATER}")
        if ffnk != FFN_DENSE:
            raise NotImplementedError(
                f"{cfg.arch_id}: FFN {ffnk!r} is not ported yet; it comes "
                f"with {_LATER}")
    if cfg.n_codebooks:
        raise NotImplementedError(
            f"{cfg.arch_id}: audio codebooks are not ported yet; they come "
            f"with {_LATER}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_sublayer(key, cfg: ModelConfig, dtype):
    ks = random.split(key, 3)
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype,          # noqa: E731
                                device=key.device)
    p: Dict[str, Any] = {"pre_norm": zeros(),
                         "mixer": attn_mod.init_attn(ks[0], cfg, dtype)}
    if cfg.use_post_norms:
        p["post_mixer_norm"] = zeros()
    p["ffn_norm"] = zeros()
    p["ffn"] = init_ffn(ks[1], cfg.d_model, cfg.d_ff, dtype)
    if cfg.use_post_norms:
        p["post_ffn_norm"] = zeros()
    return p


def _normal_table(key, shape, D, dtype):
    return (random.normal(key, shape)
            / torch.tensor(np.sqrt(D), dtype=torch.float32)).to(dtype)


def init_params(cfg: ModelConfig, key, dtype=torch.bfloat16):
    """The reference's ``init_params`` key tree — ``split(key, 4 + groups)``,
    ``split(ks[2 + gi], reps)``, ``split(rep_key, len(plan))``, then each
    sublayer's — drawn with :func:`repro_torch.random.normal`, on the key's
    device.  Equal to the reference's weights to the tolerance of
    ``normal`` (a few ulps)."""
    check_supported(cfg)
    groups_plan = cfg.layer_groups()
    ks = random.split(key, 4 + len(groups_plan))
    D, V = cfg.d_model, cfg.vocab
    params: Dict[str, Any] = {"embed": _normal_table(ks[0], (V, D), D, dtype)}
    groups = []
    for gi, (block_plan, reps) in enumerate(groups_plan):
        gk = random.split(ks[2 + gi], reps)
        reps_params = []
        for r in range(reps):
            sks = random.split(gk[r], len(block_plan))
            reps_params.append([_init_sublayer(sks[i], cfg, dtype)
                                for i in range(len(block_plan))])
        groups.append(tree_map(lambda *xs: torch.stack(xs), *reps_params))
    params["blocks"] = groups
    params["final_norm"] = torch.zeros(D, dtype=dtype, device=key.device)
    if not cfg.tie_embeddings:
        params["head"] = _normal_table(ks[1], (D, V), D, dtype)
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params, batch, cfg: ModelConfig):
    """batch: {"tokens": [B, S] int}."""
    if "image_embeds" in batch:
        raise NotImplementedError(
            f"{cfg.arch_id}: VLM image embeds are not ported yet; they come "
            f"with {_LATER}")
    x = params["embed"][batch["tokens"]]
    if cfg.use_post_norms or cfg.tie_embeddings:   # gemma-style scaling
        x = x * float(np.sqrt(cfg.d_model))
    return x


def head_logits(params, hidden, cfg: ModelConfig):
    """hidden: [..., D] -> float32 logits [..., V]."""
    h = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["head"]
    return softcap(logits.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _finish_block(p, x, out, cfg):
    """The residual add of the mixer's output, then the dense FFN, with the
    gemma-style post-norms where the config has them."""
    if cfg.use_post_norms:
        out = rms_norm(out, p["post_mixer_norm"], cfg.norm_eps)
    x = x + out
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    out = ffn(p["ffn"], h, cfg.act)
    if cfg.use_post_norms:
        out = rms_norm(out, p["post_ffn_norm"], cfg.norm_eps)
    return x + out


def _window(mixer, cfg):
    return cfg.window if mixer == ATTN_LOCAL else 0


def apply_block(p, x, mixer, cfg, positions):
    """One transformer block (full sequence).  Returns (x, aux); aux is the
    MoE router loss in the reference, zero for dense FFNs."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, _, _ = attn_mod.attn_forward(p["mixer"], h, cfg,
                                      window=_window(mixer, cfg),
                                      positions=positions)
    return _finish_block(p, x, out, cfg), torch.zeros((), device=x.device)


def _unstack(tree, reps):
    """The ``reps`` per-layer trees of a tree of stacked ``[reps, ...]``
    leaves, each leaf split by one ``unbind``: under autograd the backward
    of an unbind stacks the layers' gradients once, where taking ``a[r]``
    of each leaf would add a full-size zero tensor per layer."""
    leaves, treedef = tree_flatten(tree)
    split = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(treedef, [s[r] for s in split])
            for r in range(reps)]


def _layers(params, cfg, unbind: bool = False):
    """(group index, rep, sublayer index, params of that layer, mixer) over
    every layer, in order (the FFN is dense: ``check_supported``).  Each
    layer's leaves are ``a[r]`` views of the stacked leaves, or, with
    ``unbind`` (for autograd), taken by ``_unstack``."""
    for gi, ((block_plan, reps), gp) in enumerate(zip(cfg.layer_groups(),
                                                      params["blocks"])):
        per_rep = [_unstack(sub, reps) for sub in gp] if unbind else None
        for r in range(reps):
            for i, (m, _) in enumerate(block_plan):
                sp = (per_rep[i][r] if unbind
                      else tree_map(lambda a: a[r], gp[i]))
                yield gi, r, i, sp, m


class _DualRemat(torch.autograd.Function):
    """The primal output of a block whose forward ran outside autograd
    (``_dual_remat``): ``forward`` hands it on; ``backward`` recomputes the
    block on the saved inputs with grad on and backpropagates the incoming
    gradient, itself a dual in a forward-over-reverse pass, so the inputs'
    gradients carry their tangents."""

    @staticmethod
    def forward(ctx, run, duals, value, *primals):
        ctx.run, ctx.duals = run, duals
        return value.pop()

    @staticmethod
    def backward(ctx, grad):
        leaves, inputs = [], []
        with torch.enable_grad():         # the backward runs with grad off
            for d in ctx.duals:
                primal, tangent = fwAD.unpack_dual(d)
                leaf = primal.detach().requires_grad_(True)
                leaves.append(leaf)
                inputs.append(leaf if tangent is None
                              else fwAD.make_dual(leaf, tangent))
            out = ctx.run(*inputs)
        grads = torch.autograd.grad(out, leaves, grad, allow_unused=True)
        return (None, None, None) + tuple(grads)


def _dual_remat(run, *duals):
    """``run(*duals)`` (a block: tensors in, one tensor out) whose inputs
    carry forward-AD tangents (a Hessian-vector product), with its
    activations recomputed in the backward, as ``torch.utils.checkpoint``
    recomputes them for inputs without.

    The forward runs once, dual and without autograd: the output's primal
    and tangent, nothing saved.  ``_DualRemat`` links the primal to the
    inputs' primals, keeping only the dual inputs (a layer's input and its
    weights) for the backward's recompute.  ``torch.utils.checkpoint``
    does not serve here: its saved-tensor hooks leave every saved dual's
    tangent stored beside the hook's handle (and each tangent's own
    autograd graph), so the tangents of all layers' activations would stay
    on the card; and some torch releases pass its inputs through an
    ``autograd.Function`` without ``jvp``, which forward AD refuses.  On
    inputs without tangents both give the same bits, but
    ``torch.utils.checkpoint`` stops its recompute once the backward has
    every saved tensor it needs, so it skips each block's last GEMM (the
    FFN's down projection), which ``_dual_remat`` recomputes: it stays the
    remat of the gradient pass."""
    with torch.no_grad():
        out = run(*duals)
    value, tangent = fwAD.unpack_dual(out)
    primals = [fwAD.unpack_dual(d).primal for d in duals]
    primal = _DualRemat.apply(run, duals, [value.clone()], *primals)
    return primal if tangent is None else fwAD.make_dual(primal, tangent)


def _block_remat(sp, x, m, cfg, positions):
    """``apply_block`` with its activations recomputed in the backward:
    through ``_dual_remat`` where the layer's input or weights carry a
    forward-AD tangent, else through ``torch.utils.checkpoint``
    (non-reentrant).  Under ``_dual_remat`` aux is the dense FFN's zero
    (the layer kinds with a router loss raise in ``check_supported``)."""
    leaves, treedef = tree_flatten(sp)
    if all(fwAD.unpack_dual(t).tangent is None for t in (*leaves, x)):
        return checkpoint(apply_block, sp, x, m, cfg, positions,
                          use_reentrant=False, preserve_rng_state=False)

    def run(*ts):
        return apply_block(tree_unflatten(treedef, list(ts[:-1])), ts[-1],
                           m, cfg, positions)[0]

    return (_dual_remat(run, *leaves, x),
            torch.zeros((), device=x.device))


def forward(params, batch, cfg: ModelConfig, remat: bool = False):
    """Full-sequence forward.  Returns (hidden [B, S, D], aux scalar).

    ``remat`` checkpoints each layer (``_block_remat``): the backward
    recomputes the layer's activations from its input, as the reference's
    ``jax.checkpoint`` of each scanned block does, so only the layers'
    inputs are kept."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    for _, _, _, sp, m in _layers(params, cfg, unbind=True):
        if remat:
            x, a = _block_remat(sp, x, m, cfg, positions)
        else:
            x, a = apply_block(sp, x, m, cfg, positions)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _cache_len(mixer, cfg, max_len):
    if mixer == ATTN_LOCAL and cfg.window:
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches mirroring ``params["blocks"]``: per group, a list over
    the block plan of {"k", "v": [reps, B, S, KV, Dh]} (S = window for
    local layers)."""
    check_supported(cfg)
    groups = []
    for block_plan, reps in cfg.layer_groups():
        groups.append([
            {name: torch.zeros((reps, batch, _cache_len(m, cfg, max_len),
                                cfg.n_kv_heads, cfg.head_dim), dtype=dtype,
                               device=device) for name in ("k", "v")}
            for m, _ in block_plan])
    return groups


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_block(p, c, x, mixer, cfg, pos: int):
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, c = attn_mod.attn_decode(p["mixer"], h, c, pos, cfg,
                                  window=_window(mixer, cfg))
    return _finish_block(p, x, out, cfg), c


def decode_step(params, cache, batch, pos: int, cfg: ModelConfig):
    """One-token decode.  batch["tokens"]: [B, 1].  Returns (logits
    [B, 1, V], cache); the cache is updated in place (each layer's slice of
    the stacked ``[reps, ...]`` leaves is a view)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    for gi, r, i, sp, m in _layers(params, cfg):
        sc = tree_map(lambda a: a[r], cache[gi][i])
        x, _ = decode_block(sp, sc, x, m, cfg, pos)
    return head_logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Prefill (full sequence, returns caches for subsequent decode)
# ---------------------------------------------------------------------------

def _prefill_block(p, x, mixer, cfg, positions, max_len):
    """Like ``apply_block`` but also returns the layer's decode cache."""
    B, S, _ = x.shape
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    window = _window(mixer, cfg)
    out, k, v = attn_mod.attn_forward(p["mixer"], h, cfg, window=window,
                                      positions=positions)
    W = _cache_len(mixer, cfg, max_len)
    c = {name: torch.zeros((B, W) + t.shape[2:], dtype=x.dtype,
                           device=x.device) for name, t in (("k", k),
                                                            ("v", v))}
    if window and S >= W:
        # keep only the trailing window, at its ring slots
        slots = (S - W + torch.arange(W, device=x.device)) % W
        c["k"][:, slots] = k[:, S - W:].to(x.dtype)
        c["v"][:, slots] = v[:, S - W:].to(x.dtype)
    else:
        c["k"][:, :S] = k
        c["v"][:, :S] = v
    return _finish_block(p, x, out, cfg), c


def prefill(params, batch, cfg: ModelConfig, max_len: int = 0):
    """Full-sequence forward that also populates the decode caches.
    Returns (last logits [B, 1, V], cache); max_len defaults to S."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    S = x.shape[1]
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)[None, :]
    per_layer: Dict[tuple, list] = {}
    for gi, r, i, sp, m in _layers(params, cfg):
        x, c = _prefill_block(sp, x, m, cfg, positions, max_len)
        per_layer.setdefault((gi, i), []).append(c)
    cache = [[tree_map(lambda *cs: torch.stack(cs), *per_layer[(gi, i)])
              for i in range(len(block_plan))]
             for gi, (block_plan, _) in enumerate(cfg.layer_groups())]
    return head_logits(params, x[:, -1:], cfg), cache
