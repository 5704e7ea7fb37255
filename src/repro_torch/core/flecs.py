"""FLECS-CGD, Algorithm 1 — exact mode, synchronous dense engine
(counterpart of ``repro.core.flecs``).

One state + step pair implements FLECS (gradient compressor = identity)
and FLECS-CGD (gradient compressor = random dithering, with the shift h
update), both Hessian updates (Alg 2 truncated L-SR1 / Alg 3 direct) and
both directions (Alg 4 truncated inverse / Alg 5 FedSONIA), selected in
:class:`FlecsConfig` as in the reference.

The n workers of a federation are a leading batch dimension (the
reference vmaps them), and a sweep's [G] grid of hparams another one before
it: :func:`make_flecs_sweep_step` steps every grid point of a batched state
at once, and :func:`make_flecs_step` is its [1] grid at the config's point
(``driver.specialize``), as the reference's legacy step is its sweep step
specialised.  Whole runs go through ``repro_torch.core.driver``
(``run_experiment``, ``run_sweep``: Python loops where the reference
scans).  The key stream is the reference's: each round splits each point's
key into ``k_g, k_h, k_q, k_c, k_p``, and worker i compresses with
``split(k_q, n)[i]`` and ``split(k_c, n)[i]``, so masks, sketches and
compressor outputs match the reference element for element; the bit
ledgers match exactly.  On a CUDA device the compressors and the ledger
run through the kernels of ``repro_torch.kernels.compressor`` (the scalar
entries at G = 1, the grouped ones over a grid); the dither kernel splits
``k_q`` and ``k_c`` and draws its uniforms itself
(``compressors.compress_split``).

The sketch S_k is seeded with the round counter k.  Every live grid point
has taken the same number of rounds (a point frozen by its bit budget
stops counting, and its round's outputs are discarded), so one S_t a round
serves the batch: ``FlecsState.t`` is that count on the host, and ``k``
holds each point's own count (its frozen value where a budget froze it).

Communication accounting (per participating worker per round, bits;
``FlecsState.bits_per_node`` is [n]):
  c_k^i : spec_bits(grad_spec, d)     (gradient difference, compressed)
  C_k^i : spec_bits(hess_spec, d·m)   (sketched-Hessian difference)
  M_k^i : m² float32
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random

from repro_torch.core.compressors import (FAMILY_DITHER, CompressorSpec,
                                          compress_split, grid_spec,
                                          make_spec, spec_bits,
                                          spec_bits_host, spec_bits_many)
from repro_torch.core.directions import (fedsonia_direction,
                                         truncated_inverse_direction,
                                         truncated_inverse_direction_floored)
from repro_torch.core.driver import (bits_dtype, call_oracle, masked_mean,
                                     resolve_participation, specialize,
                                     validate_ps)
from repro_torch.core.sketch import sketch
from repro_torch.core.updates import direct_update, truncated_lsr1_update
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FlecsConfig:
    m: int = 1                        # memory size (sketch columns)
    omega: float = 1e-5               # lower truncation (ω)
    Omega: float = 1e8                # upper truncation (Ω)
    alpha: float = 1.0                # iterate step size
    beta: float = 1.0                 # direct-update learning rate
    gamma: float = 1.0                # shift learning rate (≤ 1/(ω_Q+1))
    rho: Optional[float] = None       # FedSONIA complement step (default 1/Ω)
    grad_compressor: str = "dither64"     # "identity" => plain FLECS
    hess_compressor: str = "dither64"
    hessian_update: str = "direct"    # "direct" (Alg 3) | "lsr1" (Alg 2)
    direction: str = "fedsonia"       # "fedsonia" (Alg 5) | "truncated_inverse"
    sketch_kind: str = "rademacher"
    tinv_floor: float = 0.0           # curvature floor for Alg 4
    participation: float = 1.0        # per-round client sampling probability
    sampling: str = "bernoulli"       # "bernoulli" | "choice" (exact-k)
    hierarchy: Optional[object] = None    # two-tier aggregation: not ported

    @property
    def rho_val(self):
        return 1.0 / self.Omega if self.rho is None else self.rho


class FlecsHParams(NamedTuple):
    """Per-round hyperparameters: step sizes alpha (iterate) and gamma
    (shift), the direct-update rate beta, both compressor specs, and
    optionally a Bernoulli participation probability p (None: the config's
    static ``participation``) and a per-node bit budget (None: unbounded;
    else the budget-freeze mode, ``driver.freeze_on_bit_budget``).

    A point holds floats and scalar specs (:func:`hparams_from_config`); a
    grid ([G] points, :func:`hparam_grid`) float32 [G] tensors and grid
    specs."""
    alpha: object
    gamma: object
    beta: object
    grad_spec: CompressorSpec
    hess_spec: CompressorSpec
    p: object = None
    bit_budget: object = None

    @property
    def grad_s(self):
        """Gradient dithering level axis (the pre-spec sweep API)."""
        return self.grad_spec.s

    @property
    def hess_s(self):
        return self.hess_spec.s


def hparams_from_config(cfg: FlecsConfig) -> FlecsHParams:
    """The hparams point a static ``make_flecs_step(cfg)`` runs at."""
    return FlecsHParams(cfg.alpha, cfg.gamma, cfg.beta,
                        make_spec(cfg.grad_compressor),
                        make_spec(cfg.hess_compressor))


def dither_grid(levels) -> CompressorSpec:
    """A grid spec of dither<s> at each of ``levels``."""
    levels = np.asarray(levels, np.float32).reshape(-1)
    return grid_spec((FAMILY_DITHER,) * levels.shape[0], levels,
                     np.ones_like(levels))


def hparam_grid(alphas, gammas, grad_levels, betas=(1.0,),
                hess_levels=(64.0,), ps=None,
                edge_levels=None) -> FlecsHParams:
    """Cartesian product of the sweep axes (the reference's ``meshgrid``,
    ``indexing="ij"``), flattened to [G] leaves on the CPU (``run_sweep``
    moves them to the state's device).  ``grad_levels`` / ``hess_levels``
    build dithering specs; ``ps`` adds a Bernoulli participation axis."""
    if edge_levels is not None:
        raise NotImplementedError(
            "edge_levels (hierarchical aggregation) is not ported yet "
            "(ROADMAP.md, queue 1: 'cohort, hierarchy and sharding')")
    validate_ps(ps)
    axes = [np.asarray(v, np.float32).reshape(-1) for v in (
        alphas, gammas, grad_levels, betas, hess_levels,
        [1.0] if ps is None else ps)]
    a, g, s, b, hs, p = (m.ravel() for m in np.meshgrid(*axes,
                                                         indexing="ij"))
    t = torch.as_tensor
    return FlecsHParams(t(a), t(g), t(b), dither_grid(s), dither_grid(hs),
                        None if ps is None else t(p))


class FlecsState(NamedTuple):
    """An unbatched state (``init_state``, ``make_flecs_step``) or a
    batched one (a sweep's: every tensor with a leading [G] axis, ``k`` an
    int32 [G] tensor or None, ``t`` the round every live point has
    reached; see ``driver.batch_state``)."""
    w: torch.Tensor        # [d]
    h: torch.Tensor        # [n, d]    per-worker gradient shifts
    B: torch.Tensor        # [n, d, d] per-worker Hessian approximations
    k: object              # iteration counter (seeds the sketch)
    bits_per_node: torch.Tensor   # [n] cumulative communicated bits
    t: int = 0             # batched states: the sketch's round counter


def init_state(w0: torch.Tensor, n_workers: int) -> FlecsState:
    """Zero shifts, zero curvature and empty ledgers on ``w0``'s device."""
    d = w0.shape[0]
    dev = w0.device
    return FlecsState(
        w=w0.to(torch.float32),
        h=torch.zeros((n_workers, d), dtype=torch.float32, device=dev),
        B=torch.zeros((n_workers, d, d), dtype=torch.float32, device=dev),
        k=0,
        bits_per_node=torch.zeros(n_workers, dtype=bits_dtype(), device=dev),
    )


def _round_bits(grad_spec: CompressorSpec, hess_spec: CompressorSpec,
                d: int, m: int, device) -> torch.Tensor:
    """Per-participating-worker uplink bits of one round (0-d, float32)."""
    return (spec_bits(grad_spec, d, device)          # c_k^i
            + spec_bits(hess_spec, d * m, device)    # C_k^i (dim-aware)
            + 32.0 * m * m)                          # M_k^i (float32)


def bits_per_round(cfg: FlecsConfig, d: int, device=None) -> float:
    """Deterministic per-participating-worker uplink bits of one round."""
    return float(_round_bits(make_spec(cfg.grad_compressor),
                             make_spec(cfg.hess_compressor), d, cfg.m,
                             resolve_device(device)))


def hparams_round_bits(cfg: FlecsConfig, hp: FlecsHParams, d: int):
    """Per-participating-worker uplink bits of one round at each point of a
    grid (float32 numpy [G]), priced on the host from the specs' host
    copies in the ledger's own float32 arithmetic — the price behind
    plan-level bit budgets."""
    return (spec_bits_host(hp.grad_spec, d)
            + spec_bits_host(hp.hess_spec, d * cfg.m)
            + np.float32(32.0 * cfg.m * cfg.m))


def _worker_messages(local_grad: Callable, local_hvp: Callable,
                     grad_spec: CompressorSpec, hess_spec: CompressorSpec,
                     w, h, B, S, k_g, k_h, k_q, k_c):
    """Worker compute phase of Algorithm 1 for all n workers of every grid
    point at once.  Minibatch oracles draw worker i's rows from
    ``fold_in(k_g, i)`` (gradient) and ``fold_in(k_h, i)`` (HVP).

    Returns (c [G,n,d], M [G,n,m,m], C [G,n,d,m], BS [G,n,d,m]): the
    compressed gradient differences, the exact Grams SᵀY, the compressed
    Hessian-sketch differences and B S, at the iterates ``w`` [G, d]."""
    n = h.shape[-2]
    g = call_oracle(local_grad, k_g, n, w)              # [G, n, d]
    Y = call_oracle(local_hvp, k_h, n, w, S)            # [G, n, d, m]
    M = S.mT @ Y                                        # [n, m, m] (exact)
    c = compress_split(grad_spec, k_q, g - h)
    BS = B @ S
    Cm = compress_split(hess_spec, k_c, Y - BS)
    return c, M, Cm, BS


def _direction(cfg: FlecsConfig, g_tilde, Y_tilde, M_bar, B_bar):
    """Search direction (Alg 4 variants / Alg 5) from the server
    aggregates."""
    if cfg.direction == "truncated_inverse":
        if cfg.tinv_floor > 0:
            return truncated_inverse_direction_floored(
                B_bar, g_tilde, cfg.omega, cfg.Omega, cfg.tinv_floor)
        return truncated_inverse_direction(B_bar, g_tilde, cfg.omega,
                                           cfg.Omega)
    return fedsonia_direction(Y_tilde, M_bar, g_tilde, cfg.omega,
                              cfg.Omega, cfg.rho_val)


def _update_B(cfg: FlecsConfig, beta, B, Y_tilde_i, M_all, S):
    """Per-worker Hessian-approximation update (Alg 2 / Alg 3), batched."""
    if cfg.hessian_update == "direct":
        return direct_update(B, Y_tilde_i, M_all, beta)
    return truncated_lsr1_update(B, Y_tilde_i, M_all, S, cfg.omega)[0]


def _flecs_round(cfg: FlecsConfig, local_grad: Callable, local_hvp: Callable,
                 hp: FlecsHParams, state: FlecsState, keys: torch.Tensor):
    """One round of Algorithm 1 with client sampling (the reference's
    dense ``axis=None`` round) at every point of a batched state; ``hp`` a
    [G] grid on the state's device, ``keys`` [G, 2]."""
    n, d = state.h.shape[-2:]
    m = cfg.m
    S = sketch(cfg.sketch_kind, d, m, state.t, state.w.device)

    k_g, k_h, k_q, k_c, k_p = random.split(keys, 5).unbind(dim=-2)
    mask = resolve_participation(k_p, n, cfg.participation, cfg.sampling,
                                 hp.p)                          # [G, n]

    c_all, M_all, C_all, BS_all = _worker_messages(
        local_grad, local_hvp, hp.grad_spec, hp.hess_spec,
        state.w, state.h, state.B, S, k_g, k_h, k_q, k_c)

    g_tilde_i = c_all + state.h                          # [G, n, d]
    Y_tilde_i = C_all + BS_all                           # [G, n, d, m]
    B_upd = _update_B(cfg, hp.beta.reshape(-1, 1, 1, 1), state.B, Y_tilde_i,
                      M_all, S)
    # only sampled workers communicated a Hessian difference this round
    B_new = torch.where(mask[..., None, None] > 0, B_upd, state.B)
    del B_upd

    g_tilde = masked_mean(g_tilde_i, mask)
    Y_tilde = masked_mean(Y_tilde_i, mask)
    M_bar = masked_mean(M_all, mask)
    # B̄ ([G, d, d]) is only consumed by the truncated-inverse direction
    B_bar = (masked_mean(B_new, mask)
             if cfg.direction == "truncated_inverse" else None)

    p = _direction(cfg, g_tilde, Y_tilde, M_bar, B_bar)
    w_new = state.w + hp.alpha[:, None] * p
    h_new = state.h + hp.gamma[:, None, None] * mask[..., None] * c_all

    round_bits = (spec_bits_many(hp.grad_spec, d)        # c_k^i
                  + spec_bits_many(hp.hess_spec, d * m)  # C_k^i (dim-aware)
                  + 32.0 * m * m)                        # M_k^i (float32)
    bits_new = (state.bits_per_node
                + mask.to(state.bits_per_node.dtype) * round_bits[:, None])
    new_state = FlecsState(w_new, h_new, B_new,
                           None if state.k is None else state.k + 1,
                           bits_new, state.t + 1)
    aux = {"g_tilde_norm": torch.linalg.norm(g_tilde, dim=-1),
           "dir_norm": torch.linalg.norm(p, dim=-1),
           "n_active": torch.sum(mask, dim=-1),
           "bits_per_node": bits_new}
    return new_state, aux


def make_flecs_sweep_step(cfg: FlecsConfig, local_grad: Callable,
                          local_hvp: Callable):
    """Build step(hp, state, keys) -> (state, aux) over a [G] grid: hp a
    ``FlecsHParams`` grid, state batched, keys [G, 2] — the single round
    implementation every other step maker specialises
    (``driver.run_sweep``).  Oracles: ``local_grad(w [G, d]) -> [G, n,
    d]``, ``local_hvp(w [G, d], S [d, m]) -> [G, n, d, m]``, or the
    minibatch pair of ``make_oracles(batch=B)``, which also take the
    workers' keys."""
    if cfg.hierarchy is not None:
        raise NotImplementedError(
            "FlecsConfig.hierarchy is not ported yet (ROADMAP.md, queue 1: "
            "'cohort, hierarchy and sharding')")

    def step(hp: FlecsHParams, state: FlecsState, keys: torch.Tensor):
        return _flecs_round(cfg, local_grad, local_hvp, hp, state, keys)

    return step


def make_flecs_step(cfg: FlecsConfig,
                    local_grad: Callable,      # (w) -> g [..., n, d]
                    local_hvp: Callable):      # (w, S) -> [..., n, d, m]
    """Build step(state, key) -> (state, aux) at the config's hparams: the
    sweep step's [1] grid at ``hparams_from_config(cfg)`` on an unbatched
    state (``driver.specialize``), the same ops and key stream."""
    return specialize(make_flecs_sweep_step(cfg, local_grad, local_hvp),
                      hparams_from_config(cfg))
