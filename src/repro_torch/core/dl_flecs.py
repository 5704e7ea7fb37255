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

With ``m > 0`` the step preconditions each leaf by its block of a global
sketched Hessian (the reference's ``m > 0`` branch): m Hessian-vector
products along seeded Rademacher columns (``core/hessian.hvp_pytree``,
forward over reverse; on the card the attention kernels carry the
tangents), each leaf's column compressed by the same int8 codec under the
key ``fold_in(fold_in(key0, col), 1000 + i)``, then FedSONIA per leaf
(``_fedsonia_tensor``).  The sketch is never stored or sent: each leaf's
[numel, m] block is drawn from ``fold_in(fold_in(key(23), step), i)``
(``_tensor_sketch``).  The reference draws it m + 1 times a step (once per
column, once for FedSONIA); here each leaf's signs are drawn once a step
and kept as int8 ±1 (``_sketch_signs``), and every column is that draw
divided by √m, the same bits: one threefry draw instead of m + 1 (the
draws go through ``random.py``'s int64 tensor path), at a quarter of the
float32 block's memory (m bytes an element, 2.2 GB for tinyllama-1.1b at
m = 2, against m × 4.4 GB).

Not ported yet: more than one worker (``torch.distributed``;
ROADMAP.md queue 1, 'multi-worker dl_flecs').
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.configs.base import ModelConfig
from repro_torch.core import linalg
from repro_torch.core.compressors import (decode_int8, dither_spec,
                                          identity_spec, psum_level_cap,
                                          shared_scale_levels, spec_bits)
from repro_torch.core.hessian import hvp_pytree
from repro_torch.train.step import _loss_fn, value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class FlecsDLConfig:
    alpha: float = 1e-2            # iterate step size
    gamma: float = 0.5             # shift learning rate
    s_levels: int = 127            # int8 dithering levels
    m: int = 0                     # sketch columns (0 = first-order CGD/DIANA)
    omega: float = 1e-5
    Omega: float = 1e2
    rho: float = 1.0               # FedSONIA complement step (the reference's
                                   # choice: ρ = 1 steps the complement as SGD
                                   # at lr α)
    compress: bool = True          # False = uncompressed baseline


def _sqrt_m(m: int, device) -> torch.Tensor:
    """√m as the reference divides by it: ``np.sqrt(m)`` taken to
    float32."""
    return torch.tensor(np.float32(np.sqrt(m)), device=device)


def _sketch_signs(step, idx, numel: int, m: int, device) -> torch.Tensor:
    """The signs of leaf ``idx``'s sketch block at ``step``: int8 ±1
    [numel, m], ``rademacher(fold_in(fold_in(key(23), step), idx), (numel,
    m))`` bit for bit (the reference's draw, 1 byte an element)."""
    key = random.fold_in(random.fold_in(random.key(23, device), int(step)),
                         int(idx))
    heads = random.bernoulli(key, 0.5, (numel, m))
    return heads.to(torch.int8).mul_(2).sub_(1)


def _tensor_sketch(step, idx, shape, m: int, device=None) -> torch.Tensor:
    """Seeded per-tensor sketch column block [numel, m] float32 (the
    reference's ``_tensor_sketch``): regenerated, never stored or sent."""
    signs = _sketch_signs(step, idx, math.prod(shape), m,
                          torch.device("cpu") if device is None else device)
    return signs.float() / _sqrt_m(m, signs.device)


def _fedsonia_tensor(y, mmat, g, cfg: FlecsDLConfig):
    """FedSONIA (Alg 5) on one flattened tensor block.
    y: [d, m] sketched Hessian block; mmat: [m, m]; g: [d]."""
    q, r = torch.linalg.qr(y)                     # d x m, m x m
    core = r @ linalg.pinv(mmat, rtol=1e-6) @ r.T
    lam, v = linalg.eigh(0.5 * (core + core.T))
    a = torch.abs(lam)
    lam_t = torch.where(a >= cfg.omega, torch.clamp(a, cfg.omega, cfg.Omega),
                        cfg.Omega)
    vq = q @ v
    coef = vq.T @ g
    g_perp = g - vq @ coef
    return -(vq @ (coef / lam_t)) - cfg.rho * g_perp


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
    shifts, metrics)``, first order (m = 0) or with the sketched-Hessian
    preconditioner (m > 0); metrics hold ``loss``, ``grad_norm`` (of g̃) and
    ``uplink_mbits`` (the idealized per-worker payload, ``spec_bits`` of
    the wire spec summed over the leaves)."""
    fcfg = fcfg or FlecsDLConfig()
    n = 1
    gspec = dither_spec(psum_level_cap(fcfg.s_levels, n))

    def _sketched_directions(params, batch, step_idx, g_tilde, key0,
                             payload_bits):
        """The m > 0 branch: each leaf's FedSONIA direction from the m
        compressed HVP columns; returns (directions, payload_bits), the
        columns' bits added after the gradients', column by column and leaf
        by leaf as the reference adds them."""
        m = fcfg.m
        p_leaves, treedef = tree_flatten(params)
        dev = p_leaves[0].device
        sqrt_m = _sqrt_m(m, dev)
        signs = [_sketch_signs(step_idx, i, p.numel(), m, dev)
                 for i, p in enumerate(p_leaves)]
        y_cols = [[] for _ in p_leaves]
        for col in range(m):
            tangent = [(sg[:, col].float() / sqrt_m).reshape(p.shape)
                       .to(p.dtype) for sg, p in zip(signs, p_leaves)]
            hv = tree_leaves(hvp_pytree(
                lambda pp: _loss_fn(pp, batch, cfg, remat), params,
                tree_unflatten(treedef, tangent)))
            del tangent
            kcol = random.fold_in(key0, col)
            for i in range(len(hv)):
                y, hv[i] = hv[i].float(), None
                if fcfg.compress:
                    levels, scale = shared_scale_levels(
                        random.fold_in(kcol, 1000 + i), y, gspec.s)
                    payload_bits = payload_bits + spec_bits(
                        gspec, y.numel(), dev)
                    y_bar = decode_int8(levels, scale)      # psum / 1
                    del levels
                else:
                    y_bar = y
                    payload_bits = payload_bits + spec_bits(
                        identity_spec(), y.numel(), dev)
                del y
                y_cols[i].append(y_bar.reshape(-1))
        directions = []
        for i, g in enumerate(g_tilde):
            V = signs[i].float() / sqrt_m                        # [d, m]
            signs[i] = None
            Y = torch.stack(y_cols[i], dim=1)                    # [d, m]
            y_cols[i] = None
            p_dir = _fedsonia_tensor(Y, V.T @ Y, g.reshape(-1).float(),
                                     fcfg)
            directions.append(p_dir.reshape(g.shape))
            del V, Y
        return directions, payload_bits

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
        if fcfg.m > 0:
            directions, payload_bits = _sketched_directions(
                params, batch, step_idx, g_tilde, key0, payload_bits)
            new_params = tree_map(
                lambda p, u: (p.float() + fcfg.alpha * u).to(p.dtype),
                params, tree_unflatten(treedef, directions))
        else:
            new_params = tree_map(
                lambda p, g: (p.float() + fcfg.alpha * -g).to(p.dtype),
                params, tree_unflatten(treedef, g_tilde))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g_tilde))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "uplink_mbits": payload_bits / 1e6}
        return new_params, new_shifts, metrics

    return step
