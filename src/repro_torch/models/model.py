"""LM assembler (counterpart of ``repro.models.model``) for every layer
kind of the ten architectures: global and local (sliding-window) GQA
attention, DeepSeek's MLA, the Mamba-2 SSD and RG-LRU mixers; dense, MoE
and no FFN; audio codebooks (embeds summed over codebooks, a head per
codebook) and VLM image embeds in place of the first positions.

Parameters keep the reference's pytree: ``{"embed", "blocks", "final_norm",
"head"?}`` where ``blocks`` holds one entry per layer group
(``cfg.layer_groups()``), a list over the group's block plan of dictionaries
whose leaves are stacked ``[reps, ...]``.  Weights therefore carry across
leaf for leaf (``convert.params_from_reference``).  The reference's
``lax.scan`` over a group becomes a Python loop over the reps.  There is no
mesh, so the reference's ``ctx`` argument is dropped (its ``remat`` is an
argument of ``forward``); MoE layers take the reference's one-device path,
its exact dropless function (``models/moe.py``).

Three entry points, as in the reference:
  * ``forward``      — full-sequence hidden states and the summed MoE
    router loss (``remat=True`` recomputes each layer's activations in the
    backward, as ``jax.checkpoint`` does);
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
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, ATTN_MLA,
                                      FFN_DENSE, FFN_MOE, FFN_NONE, RGLRU,
                                      SSM, ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import ffn, init_ffn, rms_norm, softcap
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

#: Where the router loss under forward AD comes from (ROADMAP.md).
_LATER_FAMILY_TRAINING = "ROADMAP.md queue 1, 'family training'"


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_sublayer(key, mixer, ffnk, cfg: ModelConfig, dtype):
    """The reference's sublayer key tree: ``split(key, 3)``, the mixer on
    ``ks[0]``, the FFN or MoE on ``ks[1]``."""
    ks = random.split(key, 3)
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype,          # noqa: E731
                                device=key.device)
    p: Dict[str, Any] = {"pre_norm": zeros()}
    if mixer in (ATTN_GLOBAL, ATTN_LOCAL):
        p["mixer"] = attn_mod.init_attn(ks[0], cfg, dtype)
    elif mixer == ATTN_MLA:
        p["mixer"] = mla_mod.init_mla(ks[0], cfg, dtype)
    elif mixer == SSM:
        p["mixer"] = ssm_mod.init_ssm(ks[0], cfg, dtype)
    elif mixer == RGLRU:
        p["mixer"] = rglru_mod.init_rglru(ks[0], cfg, dtype)
    else:
        raise ValueError(mixer)
    if cfg.use_post_norms:
        p["post_mixer_norm"] = zeros()
    if ffnk == FFN_DENSE:
        p["ffn_norm"] = zeros()
        p["ffn"] = init_ffn(ks[1], cfg.d_model, cfg.d_ff, dtype)
    elif ffnk == FFN_MOE:
        p["ffn_norm"] = zeros()
        p["moe"] = moe_mod.init_moe(ks[1], cfg, dtype)
    if ffnk != FFN_NONE and cfg.use_post_norms:
        p["post_ffn_norm"] = zeros()
    return p


def _normal_table(key, shape, D, dtype):
    div = torch.tensor(np.sqrt(D), dtype=torch.float32, device=key.device)
    return random.normal_cast(key, shape, dtype, lambda z: z / div)


def _stack(*xs):
    """The reps' leaves stacked [reps, ...]; a group of one rep is a view
    (a 7.5 GB expert leaf is not copied)."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def init_params(cfg: ModelConfig, key, dtype=torch.bfloat16):
    """The reference's ``init_params`` key tree — ``split(key, 4 + groups)``,
    ``split(ks[2 + gi], reps)``, ``split(rep_key, len(plan))``, then each
    sublayer's — drawn with :func:`repro_torch.random.normal`, on the key's
    device, each leaf a slice of its counters at a time
    (``random.normal_cast``).  Equal to the reference's weights to the
    tolerance of ``normal`` (a few ulps)."""
    groups_plan = cfg.layer_groups()
    ks = random.split(key, 4 + len(groups_plan))
    D, V, C = cfg.d_model, cfg.vocab, cfg.n_codebooks
    params: Dict[str, Any] = {
        "embed": _normal_table(ks[0], (C, V, D) if C else (V, D), D, dtype)}
    groups = []
    for gi, (block_plan, reps) in enumerate(groups_plan):
        gk = random.split(ks[2 + gi], reps)
        reps_params = []
        for r in range(reps):
            sks = random.split(gk[r], len(block_plan))
            reps_params.append([_init_sublayer(sks[i], m, f, cfg, dtype)
                                for i, (m, f) in enumerate(block_plan)])
        groups.append(tree_map(_stack, *reps_params))
        del reps_params
    params["blocks"] = groups
    params["final_norm"] = torch.zeros(D, dtype=dtype, device=key.device)
    if not cfg.tie_embeddings:
        params["head"] = _normal_table(ks[1], (C, D, V) if C else (D, V), D,
                                       dtype)
    return params


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params, batch, cfg: ModelConfig):
    """batch: {"tokens": [B, S] (or [B, S, C] audio) int; optional
    "image_embeds" [B, n_img, D] (VLM: they replace the first n_img <= S
    positions)}."""
    tokens = batch["tokens"]
    if cfg.n_codebooks:
        x = 0                       # the reference's sum, codebooks in order
        for i in range(cfg.n_codebooks):
            x = x + params["embed"][i][tokens[..., i]]
    else:
        x = params["embed"][tokens]
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = batch["image_embeds"].to(x.dtype)
        n_img = img.shape[1]
        if n_img > x.shape[1]:
            raise ValueError(f"{cfg.arch_id}: {n_img} image embeds for "
                             f"{x.shape[1]} positions")
        x = torch.cat([img, x[:, n_img:]], dim=1)
    if cfg.use_post_norms or cfg.tie_embeddings:   # gemma-style scaling
        x = x * float(np.sqrt(cfg.d_model))
    return x


def head_logits(params, hidden, cfg: ModelConfig):
    """hidden: [..., D] -> float32 logits [..., V] (or [..., C, V] for
    audio: a head a codebook, or the swapped embeds when tied)."""
    h = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    if cfg.n_codebooks:
        table = params.get("head")
        if table is None:
            table = params["embed"].transpose(-1, -2)
        logits = torch.einsum("...d,cdv->...cv", h, table)
    elif cfg.tie_embeddings:
        logits = h @ params["embed"].T
    else:
        logits = h @ params["head"]
    return softcap(logits.float(), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _window(mixer, cfg):
    return cfg.window if mixer == ATTN_LOCAL else 0


def _mixer(p, h, mixer, cfg, positions):
    """A mixer over the full sequence: (output, what prefill caches): the
    roped k and v (attention), c_kv and k_rope (MLA), the state and conv
    states (SSM, RG-LRU)."""
    if mixer in (ATTN_GLOBAL, ATTN_LOCAL):
        out, k, v = attn_mod.attn_forward(p, h, cfg,
                                          window=_window(mixer, cfg),
                                          positions=positions)
        return out, (k, v)
    if mixer == ATTN_MLA:
        out, c_kv, k_rope = mla_mod.mla_forward(p, h, cfg,
                                                positions=positions)
        return out, (c_kv, k_rope)
    if mixer == SSM:
        return ssm_mod.ssm_forward(p, h, cfg)
    if mixer == RGLRU:
        return rglru_mod.rglru_forward(p, h, cfg)
    raise ValueError(mixer)


def _finish_block(p, x, out, ffnk, cfg):
    """The residual add of the mixer's output, then the FFN (dense, MoE
    with its shared experts, or none), with the gemma-style post-norms
    where the config has them.  Returns (x, the MoE router loss or 0)."""
    aux = torch.zeros((), device=x.device)
    if cfg.use_post_norms:
        out = rms_norm(out, p["post_mixer_norm"], cfg.norm_eps)
    x = x + out
    if ffnk == FFN_NONE:
        return x, aux
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if ffnk == FFN_DENSE:
        out = ffn(p["ffn"], h, cfg.act)
    else:
        out, aux = moe_mod.moe_forward(p["moe"], h, cfg)
        if cfg.moe.n_shared:
            out = out + ffn(p["moe"]["shared"], h, cfg.act)
    if cfg.use_post_norms:
        out = rms_norm(out, p["post_ffn_norm"], cfg.norm_eps)
    return x + out, aux


def apply_block(p, x, kind, cfg, positions):
    """One block over the full sequence; ``kind`` is the layer's
    (mixer, FFN).  Returns (x, aux): the MoE router loss, zero for the
    other FFNs."""
    mixer, ffnk = kind
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, _ = _mixer(p["mixer"], h, mixer, cfg, positions)
    return _finish_block(p, x, out, ffnk, cfg)


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
    """(group index, rep, sublayer index, params of that layer, its kind
    (mixer, FFN)) over every layer, in order.  Each layer's leaves are
    ``a[r]`` views of the stacked leaves, or, with ``unbind`` (for
    autograd), taken by ``_unstack``."""
    for gi, ((block_plan, reps), gp) in enumerate(zip(cfg.layer_groups(),
                                                      params["blocks"])):
        per_rep = [_unstack(sub, reps) for sub in gp] if unbind else None
        for r in range(reps):
            for i, kind in enumerate(block_plan):
                sp = (per_rep[i][r] if unbind
                      else tree_map(lambda a: a[r], gp[i]))
                yield gi, r, i, sp, kind


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


def _block_remat(sp, x, kind, cfg, positions):
    """``apply_block`` with its activations recomputed in the backward:
    through ``_dual_remat`` where the layer's input or weights carry a
    forward-AD tangent, else through ``torch.utils.checkpoint``
    (non-reentrant).  ``_dual_remat`` carries one output, the block's, so
    a MoE layer's router loss would be lost there: it raises instead."""
    leaves, treedef = tree_flatten(sp)
    if all(fwAD.unpack_dual(t).tangent is None for t in (*leaves, x)):
        return checkpoint(apply_block, sp, x, kind, cfg, positions,
                          use_reentrant=False, preserve_rng_state=False)
    if kind[1] == FFN_MOE:
        raise NotImplementedError(
            f"{cfg.arch_id}: remat under forward AD (a Hessian-vector "
            f"product) would drop the MoE router loss; it comes with "
            f"{_LATER_FAMILY_TRAINING}")

    def run(*ts):
        return apply_block(tree_unflatten(treedef, list(ts[:-1])), ts[-1],
                           kind, cfg, positions)[0]

    return (_dual_remat(run, *leaves, x),
            torch.zeros((), device=x.device))


def forward(params, batch, cfg: ModelConfig, remat: bool = False):
    """Full-sequence forward.  Returns (hidden [B, S, D], the router loss
    summed over the MoE layers, 0 without).

    ``remat`` checkpoints each layer (``_block_remat``): the backward
    recomputes the layer's activations from its input, as the reference's
    ``jax.checkpoint`` of each scanned block does, so only the layers'
    inputs are kept."""
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    for _, _, _, sp, kind in _layers(params, cfg, unbind=True):
        if remat:
            x, a = _block_remat(sp, x, kind, cfg, positions)
        else:
            x, a = apply_block(sp, x, kind, cfg, positions)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _cache_len(mixer, cfg, max_len):
    if mixer == ATTN_LOCAL and cfg.window:
        return min(cfg.window, max_len)
    return max_len


def _cache_shapes(mixer, cfg, batch, max_len, dtype):
    """{name: (shape, dtype)} of one layer's decode cache, as the
    reference's ``_cache_for`` lays it out."""
    if mixer in (ATTN_GLOBAL, ATTN_LOCAL):
        S = _cache_len(mixer, cfg, max_len)
        return {"k": ((batch, S, cfg.n_kv_heads, cfg.qk_head_dim), dtype),
                "v": ((batch, S, cfg.n_kv_heads, cfg.head_dim), dtype)}
    if mixer == ATTN_MLA:
        return {"c_kv": ((batch, max_len, cfg.kv_lora_rank), dtype),
                "k_rope": ((batch, max_len, cfg.qk_rope_dim), dtype)}
    if mixer == SSM:
        d_inner, H, P, N = ssm_mod._dims(cfg)
        K = cfg.ssm.conv_width - 1
        return {"state": ((batch, H, P, N), torch.float32),
                "conv_x": ((batch, K, d_inner), dtype),
                "conv_B": ((batch, K, N), dtype),
                "conv_C": ((batch, K, N), dtype)}
    if mixer == RGLRU:
        W = cfg.rglru.lru_width or cfg.d_model
        return {"state": ((batch, W), torch.float32),
                "conv": ((batch, cfg.rglru.conv_width - 1, W), dtype)}
    raise ValueError(mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches mirroring ``params["blocks"]``: per group, a list over
    the block plan of the layer's cache with every leaf stacked [reps,
    ...]: {"k", "v": [B, S, KV, Dh]} (S = window for local layers), MLA's
    {"c_kv", "k_rope"}, the SSM's {"state" (float32), "conv_x", "conv_B",
    "conv_C"}, the RG-LRU's {"state" (float32), "conv"}."""
    groups = []
    for block_plan, reps in cfg.layer_groups():
        groups.append([
            {name: torch.zeros((reps,) + shape, dtype=dt, device=device)
             for name, (shape, dt) in _cache_shapes(
                 m, cfg, batch, max_len, dtype).items()}
            for m, _ in block_plan])
    return groups


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_block(p, c, x, kind, cfg, pos: int):
    """One block for one token against its cache ``c`` (updated in
    place)."""
    mixer, ffnk = kind
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if mixer in (ATTN_GLOBAL, ATTN_LOCAL):
        out, c = attn_mod.attn_decode(p["mixer"], h, c, pos, cfg,
                                      window=_window(mixer, cfg))
    elif mixer == ATTN_MLA:
        out, c = mla_mod.mla_decode(p["mixer"], h, c, pos, cfg)
    elif mixer == SSM:
        out, c = ssm_mod.ssm_decode(p["mixer"], h, c, cfg)
    elif mixer == RGLRU:
        out, c = rglru_mod.rglru_decode(p["mixer"], h, c, cfg)
    else:
        raise ValueError(mixer)
    return _finish_block(p, x, out, ffnk, cfg)[0], c


def decode_step(params, cache, batch, pos: int, cfg: ModelConfig):
    """One-token decode.  batch["tokens"]: [B, 1] (or [B, 1, C] audio).
    Returns (logits [B, 1, V] (or [B, 1, C, V]), cache); the cache is
    updated in place (each layer's slice of the stacked ``[reps, ...]``
    leaves is a view)."""
    x = embed_inputs(params, batch, cfg)
    for gi, r, i, sp, kind in _layers(params, cfg):
        sc = tree_map(lambda a: a[r], cache[gi][i])
        x, _ = decode_block(sp, sc, x, kind, cfg, pos)
    return head_logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Prefill (full sequence, returns caches for subsequent decode)
# ---------------------------------------------------------------------------

def _layer_cache(mixer, cfg, extras, x, max_len):
    """One layer's decode cache from what its mixer returned over the S
    prompt positions (``_mixer``)."""
    B, S, _ = x.shape
    if mixer in (ATTN_GLOBAL, ATTN_LOCAL):
        k, v = extras
        W = _cache_len(mixer, cfg, max_len)
        c = {name: torch.zeros((B, W) + t.shape[2:], dtype=x.dtype,
                               device=x.device)
             for name, t in (("k", k), ("v", v))}
        if _window(mixer, cfg) and S >= W:
            # keep only the trailing window, at its ring slots
            slots = (S - W + torch.arange(W, device=x.device)) % W
            c["k"][:, slots] = k[:, S - W:].to(x.dtype)
            c["v"][:, slots] = v[:, S - W:].to(x.dtype)
        else:
            c["k"][:, :S] = k
            c["v"][:, :S] = v
        return c
    if mixer == ATTN_MLA:
        c = {name: torch.zeros((B, max_len, t.shape[-1]), dtype=x.dtype,
                               device=x.device)
             for name, t in zip(("c_kv", "k_rope"), extras)}
        c["c_kv"][:, :S] = extras[0]
        c["k_rope"][:, :S] = extras[1]
        return c
    state, conv = extras
    if mixer == SSM:
        return {"state": state, "conv_x": conv["x"], "conv_B": conv["B"],
                "conv_C": conv["C"]}
    return {"state": state, "conv": conv}                   # RG-LRU


def _prefill_block(p, x, kind, cfg, positions, max_len):
    """Like ``apply_block`` but also returns the layer's decode cache."""
    mixer, ffnk = kind
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    out, extras = _mixer(p["mixer"], h, mixer, cfg, positions)
    c = _layer_cache(mixer, cfg, extras, x, max_len)
    return _finish_block(p, x, out, ffnk, cfg)[0], c


def prefill(params, batch, cfg: ModelConfig, max_len: int = 0):
    """Full-sequence forward that also populates the decode caches.
    Returns (last logits [B, 1, V] (or [B, 1, C, V]), cache); max_len
    defaults to S."""
    x = embed_inputs(params, batch, cfg)
    S = x.shape[1]
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)[None, :]
    per_layer: Dict[tuple, list] = {}
    for gi, r, i, sp, kind in _layers(params, cfg):
        x, c = _prefill_block(sp, x, kind, cfg, positions, max_len)
        per_layer.setdefault((gi, i), []).append(c)
    cache = [[tree_map(lambda *cs: torch.stack(cs), *per_layer[(gi, i)])
              for i in range(len(block_plan))]
             for gi, (block_plan, _) in enumerate(cfg.layer_groups())]
    return head_logits(params, x[:, -1:], cfg), cache
