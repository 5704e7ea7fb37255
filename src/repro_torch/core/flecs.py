"""FLECS-CGD, Algorithm 1 — exact mode, synchronous dense engine
(counterpart of ``repro.core.flecs``).

One state + step pair implements FLECS (gradient compressor = identity)
and FLECS-CGD (gradient compressor = random dithering, with the shift h
update), both Hessian updates (Alg 2 truncated L-SR1 / Alg 3 direct) and
both directions (Alg 4 truncated inverse / Alg 5 FedSONIA), selected in
:class:`FlecsConfig` as in the reference.

The n workers of a federation are a leading batch dimension (the
reference vmaps them) and whole runs go through
``repro_torch.core.driver.run_experiment`` (a Python loop where the
reference scans).  The key stream is the reference's: each round splits
its key into ``k_g, k_h, k_q, k_c, k_p``, and worker i compresses with
``split(k_q, n)[i]`` and ``split(k_c, n)[i]``, so masks, sketches and
compressor outputs match the reference element for element; the bit
ledgers match exactly.  On a CUDA device the compressors and the ledger
run through the kernels of ``repro_torch.kernels.compressor``; the dither
kernel splits ``k_q`` and ``k_c`` and draws its uniforms itself
(``compressors.compress_split``).

Communication accounting (per participating worker per round, bits;
``FlecsState.bits_per_node`` is [n]):
  c_k^i : spec_bits(grad_spec, d)     (gradient difference, compressed)
  C_k^i : spec_bits(hess_spec, d·m)   (sketched-Hessian difference)
  M_k^i : m² float32
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import random
from repro_torch.core.compressors import (CompressorSpec, compress_split,
                                          make_spec, spec_bits)
from repro_torch.core.directions import (fedsonia_direction,
                                         truncated_inverse_direction,
                                         truncated_inverse_direction_floored)
from repro_torch.core.driver import (bits_dtype, masked_mean,
                                     participation_mask)
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
    sampling: str = "bernoulli"       # "bernoulli" ("choice" is not ported)
    hierarchy: Optional[object] = None    # two-tier aggregation: not ported

    @property
    def rho_val(self):
        return 1.0 / self.Omega if self.rho is None else self.rho


class FlecsHParams(NamedTuple):
    """Per-round hyperparameters: step sizes alpha (iterate) and gamma
    (shift), the direct-update rate beta, and both compressor specs."""
    alpha: float
    gamma: float
    beta: float
    grad_spec: CompressorSpec
    hess_spec: CompressorSpec


def hparams_from_config(cfg: FlecsConfig) -> FlecsHParams:
    return FlecsHParams(cfg.alpha, cfg.gamma, cfg.beta,
                        make_spec(cfg.grad_compressor),
                        make_spec(cfg.hess_compressor))


class FlecsState(NamedTuple):
    w: torch.Tensor        # [d]
    h: torch.Tensor        # [n, d]    per-worker gradient shifts
    B: torch.Tensor        # [n, d, d] per-worker Hessian approximations
    k: int                 # iteration counter (seeds the sketch)
    bits_per_node: torch.Tensor   # [n] cumulative communicated bits


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


def _worker_messages(local_grad: Callable, local_hvp: Callable,
                     grad_spec: CompressorSpec, hess_spec: CompressorSpec,
                     w, h, B, S, k_q, k_c):
    """Worker compute phase of Algorithm 1 for all n workers at once.

    Returns (c [n,d], M [n,m,m], C [n,d,m], BS [n,d,m]): the compressed
    gradient differences, the exact Grams SᵀY, the compressed
    Hessian-sketch differences and B S, at the iterate ``w``."""
    g = local_grad(w)                                   # [n, d]
    Y = local_hvp(w, S)                                 # [n, d, m]
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
                 hp: FlecsHParams, state: FlecsState, key: torch.Tensor):
    """One round of Algorithm 1 with client sampling (the reference's
    dense ``axis=None`` round)."""
    n, d = state.h.shape
    m = cfg.m
    dev = state.w.device
    S = sketch(cfg.sketch_kind, d, m, state.k, dev)     # shared via seed

    _, _, k_q, k_c, k_p = random.split(key, 5)   # k_g, k_h: full-batch oracles
    mask = participation_mask(k_p, n, cfg.participation, cfg.sampling)

    c_all, M_all, C_all, BS_all = _worker_messages(
        local_grad, local_hvp, hp.grad_spec, hp.hess_spec,
        state.w, state.h, state.B, S, k_q, k_c)

    g_tilde_i = c_all + state.h                          # [n, d]
    Y_tilde_i = C_all + BS_all                           # [n, d, m]
    B_upd = _update_B(cfg, hp.beta, state.B, Y_tilde_i, M_all, S)
    # only sampled workers communicated a Hessian difference this round
    B_new = torch.where(mask[:, None, None] > 0, B_upd, state.B)
    del B_upd

    g_tilde = masked_mean(g_tilde_i, mask)
    Y_tilde = masked_mean(Y_tilde_i, mask)
    M_bar = masked_mean(M_all, mask)
    # B̄ ([d, d]) is only consumed by the truncated-inverse direction
    B_bar = (masked_mean(B_new, mask)
             if cfg.direction == "truncated_inverse" else None)

    p = _direction(cfg, g_tilde, Y_tilde, M_bar, B_bar)
    w_new = state.w + hp.alpha * p
    h_new = state.h + hp.gamma * mask[:, None] * c_all

    round_bits = _round_bits(hp.grad_spec, hp.hess_spec, d, m, dev)
    bits_new = (state.bits_per_node
                + mask.to(state.bits_per_node.dtype) * round_bits)
    new_state = FlecsState(w_new, h_new, B_new, state.k + 1, bits_new)
    aux = {"g_tilde_norm": torch.linalg.norm(g_tilde),
           "dir_norm": torch.linalg.norm(p),
           "n_active": torch.sum(mask),
           "bits_per_node": bits_new}
    return new_state, aux


def make_flecs_step(cfg: FlecsConfig,
                    local_grad: Callable,      # (w) -> g [n, d]
                    local_hvp: Callable):      # (w, S [d, m]) -> Y [n, d, m]
    """Build step(state, key) -> (state, aux) at the config's hparams."""
    if cfg.hierarchy is not None:
        raise NotImplementedError(
            "FlecsConfig.hierarchy is not ported yet (ROADMAP.md, queue 1: "
            "'cohort, hierarchy and sharding')")
    hp = hparams_from_config(cfg)

    def step(state: FlecsState, key: torch.Tensor) -> tuple:
        return _flecs_round(cfg, local_grad, local_hvp, hp, state, key)

    return step
