"""The paper's first- and second-order baselines, synchronous and dense
(counterpart of ``repro.optim.baselines``).

* DIANA — first-order compressed gradient differences (the "CGD" part of
  FLECS-CGD without second-order preconditioning).
* FedNL — per-worker d×d Hessian learning with compressed Hessian
  differences (top-k of the d² entries by default).
* GD — uncompressed synchronous gradient descent.

Each method is a (config, hparams, sweep step) triple as in
``repro_torch.core.flecs``: a static config dataclass, an hparam NamedTuple
(a point of floats and scalar specs from ``*_hparams_from_config``, or a
[G] grid of tensors and grid specs from ``*_hparam_grid``), and one round
``make_*_sweep_step(...)(hp, state, keys [G, 2])`` that steps every grid
point of a batched state at once (``driver.run_sweep``).  The legacy
``make_*_step`` entries are that round's [1] grid at a concrete point
(``driver.specialize``): the same ops and key stream.  Every method keeps a
per-worker bit ledger ``bits_per_node`` [n], exact to the reference's
float32 expressions in their order.

The oracles are the batched closed forms of ``repro_torch.data.logreg``:
``local_grad(w [G, d]) -> [G, n, d]`` and, for FedNL,
``local_hessian(w [G, d]) -> [G, n, d, d]``.  A minibatch gradient oracle
(``make_oracles(batch=B)``) draws worker i's rows from ``fold_in(k_g, i)``,
as the reference does; FedNL's Hessian stays full-batch, as the
reference's.

Not ported: the sharded and cohort engines (ROADMAP.md, queue 1: 'cohort,
hierarchy and sharding') and the async ones (queue 1: 'async engine'); their
makers raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.compressors import (FAMILY_TOPK, CompressorSpec,
                                          compress_split, grid_spec,
                                          make_spec, spec_bits_host,
                                          spec_bits_many)
from repro_torch.core.directions import inverse_apply
from repro_torch.core.driver import (bits_dtype, call_oracle, grid_size,
                                     masked_mean, resolve_participation,
                                     specialize, validate_ps)
from repro_torch.core.flecs import dither_grid
from repro_torch.core.linalg import eigh


def _grid_axes(*axes, ps=None):
    """Cartesian product of 1-D axes (+ an optional participation axis),
    each raveled to a float32 [G] tensor (None for an absent p axis)."""
    validate_ps(ps)
    mesh = np.meshgrid(*[np.asarray(a, np.float32).reshape(-1)
                         for a in axes],
                       np.asarray([1.0] if ps is None else ps,
                                  np.float32).reshape(-1),
                       indexing="ij")
    flat = [torch.as_tensor(m.ravel()) for m in mesh]
    return flat[:-1] + [None if ps is None else flat[-1]]


def _not_ported(what: str, label: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: '{label}')")


def _k_next(k):
    return None if k is None else k + 1


def _init(w0: torch.Tensor, n_workers: int) -> dict:
    return dict(w=w0.to(torch.float32), k=0,
                bits_per_node=torch.zeros(n_workers, dtype=bits_dtype(),
                                          device=w0.device))


# ---------------------------------------------------------------------------
# DIANA
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DianaConfig:
    """Static structure + scalar defaults for DIANA."""
    alpha: float = 1.0
    gamma: float = 0.5
    compressor: str = "dither64"      # name or CompressorSpec
    participation: float = 1.0
    sampling: str = "bernoulli"       # "bernoulli" | "choice" (exact-k)


class DianaHParams(NamedTuple):
    """Per-round DIANA knobs: a point or a [G] grid; ``p`` None defers to
    the config's participation, ``bit_budget`` engages the budget freeze."""
    alpha: object
    gamma: object
    spec: CompressorSpec
    p: object = None
    bit_budget: object = None


def diana_hparams_from_config(cfg: DianaConfig) -> DianaHParams:
    return DianaHParams(cfg.alpha, cfg.gamma, make_spec(cfg.compressor))


def diana_hparam_grid(alphas=(1.0,), gammas=(0.5,), levels=(64.0,),
                      ps=None) -> DianaHParams:
    """Cartesian (alpha × gamma × dither level [× p]) grid, [G] leaves."""
    a, g, s, p = _grid_axes(alphas, gammas, levels, ps=ps)
    return DianaHParams(a, g, dither_grid(s.numpy()), p)


def diana_round_bits(cfg: DianaConfig, hp: DianaHParams, d: int):
    """Per-participating-worker uplink bits a round at each grid point
    (float32 numpy [G], priced on the host): one compressed gradient
    difference."""
    return spec_bits_host(hp.spec, d)


class DianaState(NamedTuple):
    w: torch.Tensor
    h: torch.Tensor               # [n, d]
    k: object
    bits_per_node: torch.Tensor   # [n]


def _diana_round(cfg: DianaConfig, local_grad: Callable, hp: DianaHParams,
                 state: DianaState, keys: torch.Tensor):
    """One DIANA round (the reference's dense branch) at every point of a
    batched state."""
    n, d = state.h.shape[-2:]
    k_g, k_q, k_p = random.split(keys, 3).unbind(dim=-2)
    mask = resolve_participation(k_p, n, cfg.participation, cfg.sampling,
                                 hp.p)                              # [G, n]
    g = call_oracle(local_grad, k_g, n, state.w)
    c = compress_split(hp.spec, k_q, g - state.h)
    g_tilde = masked_mean(c + state.h, mask)
    w = state.w - hp.alpha[:, None] * g_tilde
    h = state.h + hp.gamma[:, None, None] * mask[..., None] * c
    bits = state.bits_per_node + mask.to(
        state.bits_per_node.dtype) * spec_bits_many(hp.spec, d)[:, None]
    new = DianaState(w, h, _k_next(state.k), bits)
    return new, {"g_tilde_norm": torch.linalg.norm(g_tilde, dim=-1),
                 "n_active": torch.sum(mask, dim=-1),
                 "bits_per_node": bits}


def make_diana_sweep_step(cfg: DianaConfig, local_grad: Callable):
    """Build step(hp, state, keys) over a [G] grid — the single DIANA round
    ``make_diana_step`` specialises."""
    def step(hp: DianaHParams, state: DianaState, keys: torch.Tensor):
        return _diana_round(cfg, local_grad, hp, state, keys)

    return step


def make_diana_sharded_sweep_step(*args, **kwargs):
    raise _not_ported("the sharded DIANA engine",
                      "cohort, hierarchy and sharding")


def make_diana_cohort_sweep_step(*args, **kwargs):
    raise _not_ported("the cohort DIANA engine",
                      "cohort, hierarchy and sharding")


def make_diana_async_sweep_step(*args, **kwargs):
    raise _not_ported("async DIANA", "async engine")


def make_diana_step(alpha: float, gamma: float, compressor,
                    local_grad: Callable, participation: float = 1.0,
                    sampling: str = "bernoulli"):
    """Legacy entry point: the sweep step at a concrete hparams point."""
    cfg = DianaConfig(alpha, gamma, compressor, participation, sampling)
    return specialize(make_diana_sweep_step(cfg, local_grad),
                      diana_hparams_from_config(cfg))


def init_diana(w0: torch.Tensor, n_workers: int) -> DianaState:
    base = _init(w0, n_workers)
    return DianaState(base["w"], torch.zeros(
        (n_workers, w0.shape[0]), dtype=torch.float32, device=w0.device),
        base["k"], base["bits_per_node"])


# ---------------------------------------------------------------------------
# FedNL
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedNLConfig:
    """Static structure + scalar defaults for FedNL (μ is structural: the
    positive-definite safeguard of the projected direction)."""
    alpha: float = 1.0
    compressor: str = "topk0.25"
    mu: float = 1e-3
    participation: float = 1.0
    sampling: str = "bernoulli"


class FedNLHParams(NamedTuple):
    """Per-round FedNL knobs: a point or a [G] grid."""
    alpha: object
    spec: CompressorSpec
    p: object = None
    bit_budget: object = None


def fednl_hparams_from_config(cfg: FedNLConfig) -> FedNLHParams:
    return FedNLHParams(cfg.alpha, make_spec(cfg.compressor))


def fednl_hparam_grid(alphas=(1.0,), fracs=(0.25,), ps=None) -> FedNLHParams:
    """Cartesian (alpha × top-k fraction [× p]) grid, [G] leaves."""
    a, f, p = _grid_axes(alphas, fracs, ps=ps)
    f = f.numpy()
    return FedNLHParams(a, grid_spec((FAMILY_TOPK,) * f.shape[0],
                                     np.ones_like(f), f), p)


def fednl_round_bits(cfg: FedNLConfig, hp: FedNLHParams, d: int):
    """FedNL's price a round (float32 numpy [G], on the host): an
    uncompressed gradient (32·d) plus the compressed d×d Hessian
    difference, dimension-aware."""
    return np.float32(32.0 * d) + spec_bits_host(hp.spec, d * d)


class FedNLState(NamedTuple):
    w: torch.Tensor
    H: torch.Tensor               # [n, d, d] per-worker Hessian estimates
    k: object
    bits_per_node: torch.Tensor   # [n]


def make_fednl_sweep_step(cfg: FedNLConfig, local_grad: Callable,
                          local_hessian: Callable):
    """FedNL (the regularised projected direction) over a [G] grid:
    H^i_{k+1} = H^i_k + C(∇²f_i(w_k) - H^i_k);  w⁺ = w - α [H̄]_μ^{-1} ḡ."""
    def step(hp: FedNLHParams, state: FedNLState, keys: torch.Tensor):
        n, d = state.H.shape[-3:-1]
        k_g, k_c, k_p = random.split(keys, 3).unbind(dim=-2)
        mask = resolve_participation(k_p, n, cfg.participation,
                                     cfg.sampling, hp.p)          # [G, n]
        g_all = call_oracle(local_grad, k_g, n, state.w)          # [G, n, d]
        D = compress_split(hp.spec, k_c, local_hessian(state.w) - state.H)
        H_new = state.H + mask[..., None, None] * D
        del D
        g_bar = masked_mean(g_all, mask)
        H_bar = masked_mean(H_new, mask)
        # positive-definite safeguard: H̄ + μI on the symmetric part
        Hs = 0.5 * (H_bar + H_bar.mT) + cfg.mu * torch.eye(
            d, dtype=torch.float32, device=H_bar.device)
        lam, V = eigh(Hs)
        p = -inverse_apply(V, torch.clamp(torch.abs(lam), min=cfg.mu), g_bar)
        w = state.w + hp.alpha[:, None] * p
        # uncompressed gradient + dimension-aware compressed Hessian diff
        bits = state.bits_per_node + mask.to(state.bits_per_node.dtype) * (
            d * 32.0 + spec_bits_many(hp.spec, d * d))[:, None]
        new = FedNLState(w, H_new, _k_next(state.k), bits)
        return new, {"g_tilde_norm": torch.linalg.norm(g_bar, dim=-1),
                     "n_active": torch.sum(mask, dim=-1),
                     "bits_per_node": bits}

    return step


def make_fednl_async_sweep_step(*args, **kwargs):
    raise _not_ported("async FedNL", "async engine")


def make_fednl_step(alpha: float, compressor, local_grad: Callable,
                    local_hessian: Callable, mu: float,
                    participation: float = 1.0, sampling: str = "bernoulli"):
    """Legacy entry point: the sweep step at a concrete hparams point."""
    cfg = FedNLConfig(alpha, compressor, mu, participation, sampling)
    return specialize(make_fednl_sweep_step(cfg, local_grad, local_hessian),
                      fednl_hparams_from_config(cfg))


def init_fednl(w0: torch.Tensor, n_workers: int) -> FedNLState:
    base = _init(w0, n_workers)
    d = w0.shape[0]
    return FedNLState(base["w"], torch.zeros(
        (n_workers, d, d), dtype=torch.float32, device=w0.device),
        base["k"], base["bits_per_node"])


# ---------------------------------------------------------------------------
# Distributed GD
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GDConfig:
    """Static structure + scalar defaults for uncompressed distributed GD."""
    alpha: float = 2.0
    participation: float = 1.0
    sampling: str = "bernoulli"


class GDHParams(NamedTuple):
    """Per-round GD knobs: a point or a [G] grid."""
    alpha: object
    p: object = None
    bit_budget: object = None


def gd_hparams_from_config(cfg: GDConfig) -> GDHParams:
    return GDHParams(cfg.alpha)


def gd_hparam_grid(alphas=(2.0,), ps=None) -> GDHParams:
    """Cartesian (alpha [× p]) grid, [G] leaves."""
    a, p = _grid_axes(alphas, ps=ps)
    return GDHParams(a, p)


def gd_round_bits(cfg: GDConfig, hp: GDHParams, d: int):
    """One 32-bit float gradient a round, at each grid point."""
    return np.full((grid_size(hp),), np.float32(32.0 * d), np.float32)


class GDState(NamedTuple):
    w: torch.Tensor
    k: object
    bits_per_node: torch.Tensor   # [n]


def make_gd_sweep_step(cfg: GDConfig, local_grad: Callable, n_workers: int):
    """Uncompressed synchronous GD over a [G] grid."""
    def step(hp: GDHParams, state: GDState, keys: torch.Tensor):
        d = state.w.shape[-1]
        k_g, k_p = random.split(keys, 2).unbind(dim=-2)
        mask = resolve_participation(k_p, n_workers, cfg.participation,
                                     cfg.sampling, hp.p)
        g = masked_mean(call_oracle(local_grad, k_g, n_workers, state.w),
                        mask)
        bits = state.bits_per_node + mask.to(
            state.bits_per_node.dtype) * (d * 32.0)
        new = GDState(state.w - hp.alpha[:, None] * g, _k_next(state.k),
                      bits)
        return new, {"g_tilde_norm": torch.linalg.norm(g, dim=-1),
                     "n_active": torch.sum(mask, dim=-1),
                     "bits_per_node": bits}

    return step


def make_gd_cohort_sweep_step(*args, **kwargs):
    raise _not_ported("the cohort GD engine",
                      "cohort, hierarchy and sharding")


def make_gd_async_sweep_step(*args, **kwargs):
    raise _not_ported("async GD", "async engine")


def make_gd_step(alpha: float, local_grad: Callable, n_workers: int,
                 participation: float = 1.0, sampling: str = "bernoulli"):
    """Legacy entry point: the sweep step at a concrete hparams point."""
    cfg = GDConfig(alpha, participation, sampling)
    return specialize(make_gd_sweep_step(cfg, local_grad, n_workers),
                      gd_hparams_from_config(cfg))


def init_gd(w0: torch.Tensor, n_workers: int) -> GDState:
    base = _init(w0, n_workers)
    return GDState(base["w"], base["k"], base["bits_per_node"])
