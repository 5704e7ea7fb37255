"""FLECS-CGD at deep-learning scale on one card (counterpart of
``repro.core.dl_flecs``), for one worker (n = 1).

Each step takes the gradient of the LM loss, and for each parameter leaf
compresses its difference from the worker's shift with int8 random
dithering (``compressors.shared_scale_levels``: the dither codec's encode
kernel over the leaf as one block), decodes it (``compressors.decode_int8``:
the decode kernel), and steps along the shifted estimate
g̃ = h̄ + c̄.  The shifts are bf16 trees, ``own`` [1, ...] and ``mean``,
updated as h⁺ = h + γ·c in float32 and cast back.

On one worker the reference's collectives are identities: the ``pmax`` of
the norm, the f16 ``psum`` of the levels (f16 holds every int8 level
exactly) and the ``pmean`` of the loss; c̄ = levels·scale/1 equals the
worker's own decoded message bit for bit.  The level cap is
``psum_level_cap(s, 1) = min(s, 2047)``.

Leaf order is JAX's (``repro_torch.tree.tree_flatten``, dict keys sorted):
the number i of a leaf sets its key, ``fold_in(fold_in(key(29), step), i)``,
and the float32 sum of ``payload_bits`` is taken in that order.

Not ported yet: ``m > 0`` (the sketched-Hessian preconditioner needs
Hessian-vector products through the kernels, a double backward) and more
than one worker (``torch.distributed``); both raise or are absent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random
from repro_torch.configs.base import ModelConfig
from repro_torch.core.compressors import (decode_int8, dither_spec,
                                          identity_spec, psum_level_cap,
                                          shared_scale_levels, spec_bits)
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

#: Where the sketched-Hessian path comes from (ROADMAP.md, queue 1).
_LATER_HVP = ("a later slice: FlecsDLConfig.m > 0 needs Hessian-vector "
              "products through the attention kernels (a double backward); "
              "ROADMAP.md queue 1")


@dataclasses.dataclass(frozen=True)
class FlecsDLConfig:
    alpha: float = 1e-2            # iterate step size
    gamma: float = 0.5             # shift learning rate
    s_levels: int = 127            # int8 dithering levels
    m: int = 0                     # sketch columns (0 = first-order CGD/DIANA)
    compress: bool = True          # False = uncompressed baseline


def init_shifts(params):
    """Zero shifts of one worker: ``own`` (a [1, ...] bf16 leaf per
    parameter) and ``mean`` (bf16, the parameter's shape)."""
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.bfloat16, device=p.device)

    return {"own": tree_map(lambda p: zeros((1,) + p.shape, p), params),
            "mean": tree_map(lambda p: zeros(p.shape, p), params)}


def make_flecs_train_step(cfg: ModelConfig,
                          fcfg: Optional[FlecsDLConfig] = None, *,
                          remat: bool = False):
    """The FLECS-CGD step ``(params, shifts, batch, step_idx) -> (params,
    shifts, metrics)``; metrics hold ``loss``, ``grad_norm`` (of g̃) and
    ``uplink_mbits`` (the idealized per-worker payload, ``spec_bits`` of
    the wire spec summed over the leaves)."""
    fcfg = fcfg or FlecsDLConfig()
    if fcfg.m > 0:
        raise NotImplementedError(
            f"FLECS-CGD with m = {fcfg.m} sketch columns is not ported yet; "
            f"it comes with {_LATER_HVP}")
    n = 1
    gspec = dither_spec(psum_level_cap(fcfg.s_levels, n))

    def step(params, shifts, batch, step_idx: int):
        loss, grads = value_and_grad(params, batch, cfg, remat)
        leaves, treedef = tree_flatten(grads)
        del grads
        h_own = [h[0] for h in tree_leaves(shifts["own"])]
        h_mean = tree_leaves(shifts["mean"])
        dev = loss.device
        key0 = random.fold_in(random.key(29, dev), int(step_idx))
        payload_bits = torch.zeros((), dtype=torch.float32, device=dev)
        g_tilde, new_own, new_mean = [], [], []
        for i, (ho, hm) in enumerate(zip(h_own, h_mean)):
            g, leaves[i] = leaves[i], None       # free each gradient leaf
            if not fcfg.compress:
                g_tilde.append(g.float())
                new_own.append(ho)
                new_mean.append(hm)
                payload_bits = payload_bits + spec_bits(identity_spec(),
                                                        g.numel(), dev)
                continue
            key = random.fold_in(key0, i)
            delta = g.float() - ho.float()
            del g
            levels, scale = shared_scale_levels(key, delta, gspec.s)
            payload_bits = payload_bits + spec_bits(gspec, delta.numel(), dev)
            del delta
            q_own = decode_int8(levels, scale)           # own Q(δ_i)
            q_mean = q_own       # c̄: the psum of one worker's levels, / 1
            g_tilde.append(q_mean + hm.float())
            new_own.append((ho.float() + fcfg.gamma * q_own).to(ho.dtype))
            new_mean.append((hm.float() + fcfg.gamma * q_mean).to(hm.dtype))
        new_shifts = {
            "own": tree_unflatten(treedef, [h[None] for h in new_own]),
            "mean": tree_unflatten(treedef, new_mean),
        }
        update = tree_unflatten(treedef, g_tilde)
        new_params = tree_map(
            lambda p, g: (p.float() + fcfg.alpha * -g).to(p.dtype), params,
            update)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g_tilde))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "uplink_mbits": payload_bits / 1e6}
        return new_params, new_shifts, metrics

    return step
