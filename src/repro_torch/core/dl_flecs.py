"""FLECS-CGD at deep-learning scale (counterpart of ``repro.core.dl_flecs``):
n federated workers, each holding the full model, in one process or over
the ranks of a ``torch.distributed`` group (``driver.WorkerGroup``; rank r
holds workers [r·n_local, (r+1)·n_local)).

Worker j takes the gradient of the LM loss on its own rows of the global
batch, [j·B/n, (j+1)·B/n) (every row where n does not divide B: the
reference's ``batch_specs`` fallback).  For each parameter leaf, every
worker compresses its difference from its own shift with int8 random
dithering against one ∞-norm shared by all n workers
(``compressors.shared_scale_levels``: the reference's ``pmax``, here the
norm pass of the dither codec over every local worker's leaf, an
``all_reduce(MAX)`` over the group, then each worker's levels pass), and
the workers' levels are summed (``compressors.sum_levels``: exact in int16
within a process, float16 on the wire across ranks, as the reference's
f16 ``psum``).  The server's estimate is c̄ = (Σ levels · scale) / n, in
the reference's order, and the step moves along g̃ = h̄ + c̄.  The shifts
are bf16 trees, ``own`` [n_local, ...] (each worker's h_j) and ``mean``
(h̄, replicated), updated as h⁺ = h + γ·c in float32 and cast back: h_j
by the worker's own decoded message (``compressors.decode_int8``: the
decode kernel), h̄ by c̄.  The levels are capped at ``psum_level_cap(s,
n) = min(s, 2047 // n)`` so that every sum stays exact in float16.  The
loss is the mean of the workers' losses, summed in worker order.

Every worker draws its uniforms from the same key, ``fold_in(fold_in(
key(29), step), i)`` for leaf i: the reference folds no worker index into
it, and neither does the port.  Leaf order is JAX's
(``repro_torch.tree.tree_flatten``, dict keys sorted); the float32 sum of
``payload_bits`` (the idealized per-worker payload) is taken in that
order.

With one worker and no group the collectives are identities and the step
takes the one-worker path: the fused keyed encode kernel, and c̄ = the
worker's own decoded message (f16 holds every int8 level exactly).

With ``m > 0`` the step preconditions each leaf by its block of a global
sketched Hessian (the reference's ``m > 0`` branch): m Hessian-vector
products along seeded Rademacher columns (``core/hessian.hvp_pytree``,
forward over reverse; on the card the attention kernels carry the
tangents), taken by every worker on its own rows, each leaf's column
compressed against a shared norm and summed as the gradients are, under
the key ``fold_in(fold_in(key0, col), 1000 + i)``, then FedSONIA per leaf
on the averaged columns (``_fedsonia_tensor``), once a process.  The
sketch is never stored or sent: each leaf's [numel, m] block is drawn from
``fold_in(fold_in(key(23), step), i)`` (``_tensor_sketch``), the same for
every worker.  The reference draws it m + 1 times a step (once per
column, once for FedSONIA); here each leaf's signs are drawn once a step
and kept as int8 ±1 (``_sketch_signs``), and every column is that draw
divided by √m, the same bits: one threefry draw instead of m + 1 (the
draws go through ``random.py``'s int64 tensor path), at a quarter of the
float32 block's memory (m bytes an element, 2.2 GB for tinyllama-1.1b at
m = 2, against m × 4.4 GB).

Without compression the workers' float32 gradients (and columns) are
averaged, summed in worker order after an ``all_gather`` over the group,
so the bits do not depend on how the workers sit on the ranks.

Not ported: the model axis (tensor parallelism inside a worker; ROADMAP.md,
with ``launch/{mesh, sharding}.py``).
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
                                          shared_scale_levels, spec_bits,
                                          sum_levels)
from repro_torch.core.driver import gather_workers, worker_block
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


def init_shifts(params, n_workers: int = 1):
    """Zero shifts of ``n_workers`` workers (this process's): ``own`` (an
    [n_workers, ...] bf16 leaf per parameter) and ``mean`` (bf16, the
    parameter's shape)."""
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.bfloat16, device=p.device)

    return {"own": tree_map(lambda p: zeros((n_workers,) + p.shape, p),
                            params),
            "mean": tree_map(lambda p: zeros(p.shape, p), params)}


def worker_rows(batch, w: int, n: int):
    """Worker w's rows of each batch leaf: [w·B/n, (w+1)·B/n) where n
    divides the leaf's B, else all of them (the reference's
    ``batch_specs`` fallback)."""
    def rows(x):
        if x.dim() and x.shape[0] % n == 0:
            b = x.shape[0] // n
            return x[w * b:(w + 1) * b]
        return x

    return {k: rows(v) for k, v in batch.items()}


def make_flecs_train_step(cfg: ModelConfig,
                          fcfg: Optional[FlecsDLConfig] = None, *,
                          remat: bool = False, n_workers: int = 1,
                          group=None):
    """The FLECS-CGD step ``(params, shifts, batch, step_idx) -> (params,
    shifts, metrics)`` of ``n_workers`` federated workers, first order
    (m = 0) or with the sketched-Hessian preconditioner (m > 0).  With a
    ``group`` (``driver.WorkerGroup``) every rank calls the step with the
    same params, h̄ and global batch, its own workers' ``own`` shifts
    [n_workers / size, ...], and gets the same params and h̄ back.
    metrics hold ``loss`` (the workers' mean), ``grad_norm`` (of g̃) and
    ``uplink_mbits`` (the idealized per-worker payload, ``spec_bits`` of
    the wire spec summed over the leaves)."""
    fcfg = fcfg or FlecsDLConfig()
    n = n_workers
    if n < 1:
        raise ValueError(f"n_workers must be at least 1, got {n}")
    ids = worker_block(group, n)
    gspec = dither_spec(psum_level_cap(fcfg.s_levels, n))
    lone = n == 1 and group is None     # c̄ is the worker's own message

    def mean_over_workers(xs, n_t):
        """The mean over all n workers of float32 tensors, xs this
        process's, summed in worker order."""
        if lone:
            return xs[0]
        if group is not None:
            xs = gather_workers(torch.stack(xs), group, dim=0).unbind(0)
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return total / n_t

    def quantized_mean(key, xs, n_t, payload_bits):
        """Each worker's levels of its tensor in xs against the shared
        norm, and c̄ = (Σ levels · scale) / n: (levels, scale, c̄,
        payload_bits with the message's bits)."""
        levels, scale = shared_scale_levels(key, xs, gspec.s, group)
        payload_bits = payload_bits + spec_bits(gspec, xs[0].numel(),
                                                n_t.device)
        mean = (decode_int8(levels[0], scale) if lone    # psum / 1
                else sum_levels(levels, group) * scale / n_t)
        return levels, scale, mean, payload_bits

    def _sketched_directions(params, batches, step_idx, g_tilde, key0,
                             payload_bits, n_t):
        """The m > 0 branch: each leaf's FedSONIA direction from the m
        compressed HVP columns, averaged over the workers; returns
        (directions, payload_bits), the columns' bits added after the
        gradients', column by column and leaf by leaf as the reference
        adds them."""
        m = fcfg.m
        p_leaves, treedef = tree_flatten(params)
        dev = p_leaves[0].device
        sqrt_m = _sqrt_m(m, dev)
        signs = [_sketch_signs(step_idx, i, p.numel(), m, dev)
                 for i, p in enumerate(p_leaves)]
        y_cols = [[] for _ in p_leaves]
        for col in range(m):
            tangent = tree_unflatten(treedef, [
                (sg[:, col].float() / sqrt_m).reshape(p.shape).to(p.dtype)
                for sg, p in zip(signs, p_leaves)])
            hvs = [tree_leaves(hvp_pytree(
                lambda pp, b=b: _loss_fn(pp, b, cfg, remat), params,
                tangent)) for b in batches]
            del tangent
            kcol = random.fold_in(key0, col)
            for i in range(len(p_leaves)):
                ys = [hv[i].float() for hv in hvs]
                for hv in hvs:
                    hv[i] = None
                if fcfg.compress:
                    levels, _, y_bar, payload_bits = quantized_mean(
                        random.fold_in(kcol, 1000 + i), ys, n_t,
                        payload_bits)
                    del levels
                else:
                    y_bar = mean_over_workers(ys, n_t)
                    payload_bits = payload_bits + spec_bits(
                        identity_spec(), ys[0].numel(), dev)
                del ys
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
        batches = [worker_rows(batch, w, n) for w in ids]
        losses, grads = [], []
        for b in batches:
            loss, g = value_and_grad(params, b, cfg, remat)
            losses.append(loss)
            grads.append(tree_flatten(g)[0])
        del g
        treedef = tree_flatten(params)[1]
        h_own = tree_leaves(shifts["own"])
        if h_own[0].shape[0] != len(ids):
            raise ValueError(f"shifts hold {h_own[0].shape[0]} workers' own "
                             f"shifts, this process {len(ids)} workers")
        h_mean = tree_leaves(shifts["mean"])
        dev = losses[0].device
        n_t = torch.full((), float(n), dtype=torch.float32, device=dev)
        key0 = random.fold_in(random.key(29, dev), int(step_idx))
        payload_bits = torch.zeros((), dtype=torch.float32, device=dev)
        g_tilde, new_own, new_mean = [], [], []
        for i, (ho, hm) in enumerate(zip(h_own, h_mean)):
            gs = [gw[i].float() for gw in grads]
            for gw in grads:                 # free each gradient leaf
                gw[i] = None
            if not fcfg.compress:
                g_tilde.append(mean_over_workers(gs, n_t))
                new_own.append(ho)
                new_mean.append(hm)
                payload_bits = payload_bits + spec_bits(identity_spec(),
                                                        gs[0].numel(), dev)
                continue
            deltas = [g - h.float() for g, h in zip(gs, ho)]
            del gs
            levels, scale, q_mean, payload_bits = quantized_mean(
                random.fold_in(key0, i), deltas, n_t, payload_bits)  # c̄
            del deltas
            own = []
            for h, lv in zip(ho, levels):
                q_own = q_mean if lone else decode_int8(lv, scale)  # Q(δ_j)
                own.append((h.float() + fcfg.gamma * q_own).to(h.dtype))
            del levels
            g_tilde.append(q_mean + hm.float())
            new_own.append(torch.stack(own))
            new_mean.append((hm.float() + fcfg.gamma * q_mean).to(hm.dtype))
        new_shifts = {"own": tree_unflatten(treedef, new_own),
                      "mean": tree_unflatten(treedef, new_mean)}
        if fcfg.m > 0:
            directions, payload_bits = _sketched_directions(
                params, batches, step_idx, g_tilde, key0, payload_bits, n_t)
            new_params = tree_map(
                lambda p, u: (p.float() + fcfg.alpha * u).to(p.dtype),
                params, tree_unflatten(treedef, directions))
        else:
            new_params = tree_map(
                lambda p, g: (p.float() + fcfg.alpha * -g).to(p.dtype),
                params, tree_unflatten(treedef, g_tilde))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in g_tilde))
        metrics = {"loss": mean_over_workers(losses, n_t),
                   "grad_norm": gnorm, "uplink_mbits": payload_bits / 1e6}
        return new_params, new_shifts, metrics

    return step
