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

Asynchronous buffered aggregation (FedBuff-style, the reference's
``make_flecs_async_sweep_step``): a sampled worker's message (c, Ỹ, M)
arrives a delay after it was computed, its shift h^i and approximation B^i
are updated and its bits charged at the arrival round, arrivals buffer on
the server, and once ``buffer_k`` of them have buffered the server steps
from their means.  A worker with a message in flight is busy and is not
sampled.  tau, buffer_k, the step sizes, beta and the specs are per grid
point (:class:`FlecsAsyncHParams`, :func:`async_hparam_grid`), and an
optional ``core.traffic.TrafficModel`` adds arrival processes,
availability and admission.  At tau = 0 (buffer_k = n at full
participation, or buffer_k = 1 under sampling) the async round is the
synchronous one, bit for bit: the same key splits, the same ``masked_sum``
algebra.  The reference skips the worker compute, the B update and the
direction where its ``lax.cond`` finds no sender, arrival or flush (under
``vmap`` it computes both branches and selects); here one host read a
round (``traffic.route_round``) tells whether any grid point needs each,
and the branch is skipped where none does, its keys untouched.

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
from repro_torch.core.driver import (StalenessSchedule, bits_dtype,
                                     call_oracle, damped_alpha,
                                     fedbuff_accumulate, init_buffer,
                                     masked_mean, resolve_participation,
                                     specialize, validate_ps)
from repro_torch.core.sketch import sketch
from repro_torch.core.traffic import (TrafficModel, deliver, round_aux,
                                      route_round)
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


def _grid_round_bits(hp: FlecsHParams, d: int, m: int) -> torch.Tensor:
    """Per-participating-worker bits of one round at each grid point
    ([G], on the device: the grouped ledger kernels)."""
    return (spec_bits_many(hp.grad_spec, d)             # c_k^i
            + spec_bits_many(hp.hess_spec, d * m)       # C_k^i (dim-aware)
            + 32.0 * m * m)                             # M_k^i (float32)


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

    bits_new = (state.bits_per_node + mask.to(state.bits_per_node.dtype)
                * _grid_round_bits(hp, d, m)[:, None])
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


# ---------------------------------------------------------------------------
# Asynchronous buffered aggregation (FedBuff-style staleness)
# ---------------------------------------------------------------------------

class FlecsAsyncHParams(NamedTuple):
    """An async point or [G] grid: the synchronous hparams ``hp`` (alpha
    possibly auto-damped, ``driver.damped_alpha``), the delay bound ``tau``
    (int32), the FedBuff flush threshold ``buffer_k`` (float32) and the
    traffic model's numbers (``core.traffic.TrafficHParams``, or None)."""
    hp: FlecsHParams
    tau: object
    buffer_k: object
    traffic: object = None


def async_hparams_from_config(cfg: FlecsConfig, tau: int,
                              buffer_k) -> FlecsAsyncHParams:
    return FlecsAsyncHParams(hparams_from_config(cfg),
                             torch.tensor(int(tau), dtype=torch.int32),
                             torch.tensor(float(buffer_k),
                                          dtype=torch.float32))


def async_hparam_grid(taus, buffer_ks, *, alpha=1.0, gamma=1.0, beta=1.0,
                      grad_s=64.0, hess_s=64.0, ps=None,
                      auto_damp=None) -> FlecsAsyncHParams:
    """Cartesian (tau × buffer_k [× p]) staleness grid, [G] leaves on the
    CPU.  ``auto_damp=(sampled_frac, n_workers)`` sets each point's alpha
    to ``damped_alpha(alpha, frac, K_eff, n_workers)``, K_eff the updates a
    flush averages: max(K, round(p·n)) at tau = 0 (the whole sampled cohort
    lands at once), K otherwise; with a ``ps`` axis each point's own p."""
    validate_ps(ps)
    t, K, p = (a.ravel() for a in np.meshgrid(
        np.asarray(taus, np.int32).reshape(-1),
        np.asarray(buffer_ks, np.float32).reshape(-1),
        np.asarray([1.0] if ps is None else ps, np.float32).reshape(-1),
        indexing="ij"))
    t, K, p = torch.as_tensor(t), torch.as_tensor(K), torch.as_tensor(p)
    G = t.shape[0]
    if auto_damp is not None:
        frac, n_workers = auto_damp
        if ps is None:
            cohort = torch.tensor(float(max(1, round(frac * n_workers))))
            frac_pt = frac
        else:
            cohort = torch.clamp(torch.round(p * n_workers), min=1.0)
            frac_pt = p
        K_eff = torch.where(t == 0, torch.maximum(K, cohort), K)
        alphas = damped_alpha(alpha, frac_pt, K_eff, n_workers)
    else:
        alphas = torch.full((G,), alpha, dtype=torch.float32)

    def full(v):
        return torch.full((G,), v, dtype=torch.float32)

    hp = FlecsHParams(alphas, full(gamma), full(beta),
                      dither_grid(np.full(G, grad_s, np.float32)),
                      dither_grid(np.full(G, hess_s, np.float32)),
                      None if ps is None else p)
    return FlecsAsyncHParams(hp, t, K)


class FlecsAsyncState(NamedTuple):
    """The synchronous state with the in-flight and FedBuff buffers.

    buf holds each worker's message {c [n, d], Y [n, d, m], M [n, m, m],
    t [n]} under its arrival slot (t the compute round: the age of an
    update, and the sketch the L-SR1 update regenerates); acc_* are the
    FedBuff sums since the last flush, acc_n their count; traffic the
    availability chain's state (or None); t the round on the host."""
    w: torch.Tensor
    h: torch.Tensor
    B: torch.Tensor
    k: object
    bits_per_node: torch.Tensor
    buf: object
    acc_g: torch.Tensor    # [d]    sum of arrived g̃^i = c^i + h^i
    acc_Y: torch.Tensor    # [d, m] sum of arrived Ỹ^i
    acc_M: torch.Tensor    # [m, m] sum of arrived M^i
    acc_B: torch.Tensor    # [d, d] sum of arrived workers' updated B^i
    acc_n: torch.Tensor    # buffered-update count
    traffic: object = None
    t: int = 0


def init_async_state(w0: torch.Tensor, n_workers: int, m: int,
                     max_delay: int) -> FlecsAsyncState:
    """Empty buffers for delays up to ``max_delay``, on ``w0``'s device."""
    base = init_state(w0, n_workers)
    d = w0.shape[0]

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=w0.device)

    proto = {"c": z(n_workers, d), "Y": z(n_workers, d, m),
             "M": z(n_workers, m, m), "t": z(n_workers)}
    return FlecsAsyncState(base.w, base.h, base.B, 0, base.bits_per_node,
                           init_buffer(proto, max_delay), z(d), z(d, m),
                           z(m, m), z(d, d), z(), None, 0)


def make_flecs_async_sweep_step(cfg: FlecsConfig, local_grad: Callable,
                                local_hvp: Callable,
                                delay_kind: str = "fixed", q: float = 0.5,
                                traffic: Optional[TrafficModel] = None):
    """Build step(ahp, state, keys) -> (state, aux) over a [G] grid: ahp a
    ``FlecsAsyncHParams`` grid, state a batched ``FlecsAsyncState`` whose
    buffer has max(tau) + 1 slots, keys [G, 2].

    A round: (1) sample clients, busy ones excluded, traffic applied; (2)
    the senders compute (c, Ỹ, M) at the current iterate as the
    synchronous round does; (3) messages go to their arrival slots; (4)
    this round's admitted arrivals update h^i and B^i (the L-SR1 update on
    each message's compute-round sketch), are billed, and join the FedBuff
    sums; (5) a point whose count reaches buffer_k steps from the means and
    resets them."""
    if cfg.hierarchy is not None:
        raise NotImplementedError(
            "FlecsConfig.hierarchy is not ported yet (ROADMAP.md, queue 1: "
            "'cohort, hierarchy and sharding')")

    def step(ahp: FlecsAsyncHParams, state: FlecsAsyncState,
             keys: torch.Tensor):
        hp = ahp.hp
        n, d = state.h.shape[-2:]
        m = cfg.m
        t = state.t
        dev = state.w.device
        S = sketch(cfg.sketch_kind, d, m, t, dev)
        k_g, k_h, k_q, k_c, k_p = random.split(keys, 5).unbind(dim=-2)
        mask = resolve_participation(k_p, n, cfg.participation,
                                     cfg.sampling, hp.p)
        route = route_round(delay_kind, q, traffic, ahp, state, keys, mask)

        msgs = None
        if route.sends.any():
            c_all, M_all, C_all, BS_all = _worker_messages(
                local_grad, local_hvp, hp.grad_spec, hp.hess_spec,
                state.w, state.h, state.B, S, k_g, k_h, k_q, k_c)
            msgs = {"c": c_all, "Y": C_all + BS_all, "M": M_all}
            del C_all, BS_all
        buf, msg = deliver(route, state.buf, msgs)
        del msgs
        arrived = route.arrived

        # arrivals: per-worker server state, billed at the arrival round
        B_new = state.B
        if route.arrives:
            S_msg = S if route.tau_zero or cfg.hessian_update == "direct" \
                else sketch(cfg.sketch_kind, d, m, msg["t"].to(torch.int64),
                            dev)
            B_upd = _update_B(cfg, hp.beta.reshape(-1, 1, 1, 1), state.B,
                              msg["Y"], msg["M"], S_msg)
            B_new = torch.where(arrived[..., None, None] > 0, B_upd, state.B)
            del B_upd
        h_new = state.h + hp.gamma[:, None, None] * arrived[..., None] \
            * msg["c"]
        bits_new = (state.bits_per_node + arrived.to(
            state.bits_per_node.dtype) * _grid_round_bits(hp, d, m)[:, None])

        acc, acc_n, means, flush, reset = fedbuff_accumulate(
            {"g": state.acc_g, "Y": state.acc_Y, "M": state.acc_M,
             "B": state.acc_B}, state.acc_n,
            {"g": msg["c"] + state.h, "Y": msg["Y"], "M": msg["M"],
             "B": B_new}, arrived, ahp.buffer_k)

        # the direction only where a point flushes this round
        w_new = state.w
        dir_norm = torch.zeros_like(state.acc_n)
        if route.flushes:
            p = _direction(cfg, means["g"], means["Y"], means["M"],
                           means["B"])
            w_new = torch.where(flush[:, None],
                                state.w + hp.alpha[:, None] * p, state.w)
            dir_norm = torch.where(flush, torch.linalg.norm(p, dim=-1),
                                   dir_norm)

        new_state = FlecsAsyncState(
            w_new, h_new, B_new, None if state.k is None else state.k + 1,
            bits_new, buf, reset(acc["g"]), reset(acc["Y"]),
            reset(acc["M"]), reset(acc["B"]), reset(acc_n), route.tstate,
            t + 1)
        return new_state, round_aux(route, new_state.acc_n, flush, t,
                                    bits_new,
                                    torch.linalg.norm(means["g"], dim=-1),
                                    dir_norm)

    return step


def make_flecs_async_step(cfg: FlecsConfig, local_grad: Callable,
                          local_hvp: Callable, schedule: StalenessSchedule,
                          buffer_k):
    """Build step(state, key) -> (state, aux) at (cfg, schedule.tau,
    buffer_k): the async sweep step's [1] grid on an unbatched
    ``FlecsAsyncState`` (``driver.specialize``)."""
    return specialize(
        make_flecs_async_sweep_step(cfg, local_grad, local_hvp,
                                    delay_kind=schedule.kind, q=schedule.q),
        async_hparams_from_config(cfg, schedule.tau, buffer_k))
