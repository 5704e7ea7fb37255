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

Asynchronous buffered aggregation (FedBuff-style): ``make_*_async_sweep_step``
gives each method the engine of ``core.flecs.make_flecs_async_sweep_step``
(delays from ``driver.sample_delays``, the in-flight ``MessageBuffer``,
busy workers not sampled, bits billed and shifts / Hessian estimates
updated at the arrival round, a server step once ``buffer_k`` updates have
buffered, an optional ``core.traffic.TrafficModel``); ``*AsyncHParams``
wrap the sync hparams with tau and buffer_k, and ``make_*_async_step`` is
the [1] grid at a concrete point.  At tau = 0 they are the synchronous
steps bit for bit.  The worker compute is skipped where no grid point
sends, FedNL's eigh where none flushes (one host read a round,
``traffic.route_round``).

Population scale, as in ``repro_torch.core.flecs``: DIANA has a sharded
engine (``make_diana_sharded_sweep_step`` and ``diana_sharded_state_specs``
for ``driver.run_sharded_sweep``), DIANA and GD cohort engines
(``make_*_cohort_sweep_step``: a stratified cohort of the N-client
population a round, the [G, N] tables updated in place).  FedNL has
neither, as in the reference: its per-worker d×d estimates make its state
O(n·d²).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.compressors import (FAMILY_TOPK, CompressorSpec,
                                          compress_split, grid_spec,
                                          make_spec, spec_bits_host,
                                          spec_bits_many)
from repro_torch.core.directions import inverse_apply
from repro_torch.core.driver import (COHORT_SALT, WORKERS,
                                     StalenessSchedule, WorkerGroup,
                                     bits_dtype, call_oracle, cohort_indices,
                                     fedbuff_accumulate, gather_workers,
                                     grid_size, init_buffer, masked_mean,
                                     resolve_participation, shard_rows,
                                     specialize, sum_workers,
                                     validate_cohort, validate_ps,
                                     worker_group)
from repro_torch.core.flecs import cohort_add_, cohort_rows, dither_grid
from repro_torch.core.linalg import eigh
from repro_torch.core.traffic import (TrafficModel, deliver, round_aux,
                                      route_round)


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


def _k_next(k):
    return None if k is None else k + 1


def _init(w0: torch.Tensor, n_workers: int) -> dict:
    return dict(w=w0.to(torch.float32), k=0,
                bits_per_node=torch.zeros(n_workers, dtype=bits_dtype(),
                                          device=w0.device))


def _async_hparams(cls, hp, tau, buffer_k):
    """An async point: ``hp`` with tau (int32) and buffer_k (float32)."""
    return cls(hp, torch.tensor(int(tau), dtype=torch.int32),
               torch.tensor(float(buffer_k), dtype=torch.float32))


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
                 state: DianaState, keys: torch.Tensor,
                 group: Optional[WorkerGroup] = None,
                 n_total: Optional[int] = None):
    """One DIANA round at every point of a batched state: dense
    (``group=None``) or this rank's block of the ``n_total`` federation, as
    ``flecs._flecs_round``: global ids and key stream, the shifted
    gradients gathered from every rank, the server mean replicated."""
    n_loc, d = state.h.shape[-2:]
    n = n_loc if group is None else n_total
    k_g, k_q, k_p = random.split(keys, 3).unbind(dim=-2)
    mask = resolve_participation(k_p, n, cfg.participation, cfg.sampling,
                                 hp.p)                              # [G, n]
    ids, mask_loc = None, mask
    if group is not None:
        ids = shard_rows(group, n, state.w.device)
        mask_loc = mask[:, group.rank * n_loc:(group.rank + 1) * n_loc]
    g = call_oracle(local_grad, k_g, n_loc, state.w, ids=ids)
    c = compress_split(hp.spec, k_q, g - state.h, ids=ids)
    g_i = c + state.h
    if group is None:
        n_active = torch.sum(mask, dim=-1)
    else:
        g_i = gather_workers(g_i, group)
        n_active = sum_workers(torch.sum(mask_loc, dim=-1), group)
    g_tilde = masked_mean(g_i, mask)
    w = state.w - hp.alpha[:, None] * g_tilde
    h = state.h + hp.gamma[:, None, None] * mask_loc[..., None] * c
    bits = state.bits_per_node + mask_loc.to(
        state.bits_per_node.dtype) * spec_bits_many(hp.spec, d)[:, None]
    new = DianaState(w, h, _k_next(state.k), bits)
    return new, {"g_tilde_norm": torch.linalg.norm(g_tilde, dim=-1),
                 "n_active": n_active,
                 "bits_per_node": bits}


def make_diana_sweep_step(cfg: DianaConfig, local_grad: Callable):
    """Build step(hp, state, keys) over a [G] grid — the single DIANA round
    ``make_diana_step`` specialises."""
    def step(hp: DianaHParams, state: DianaState, keys: torch.Tensor):
        return _diana_round(cfg, local_grad, hp, state, keys)

    return step


def make_diana_sharded_sweep_step(cfg: DianaConfig, local_grad: Callable,
                                  n_total: int,
                                  group: Optional[WorkerGroup] = None):
    """The DIANA sweep step for ``driver.run_sharded_sweep``: the state's
    worker leaves hold this rank's block of the ``n_total`` federation."""
    def step(hp: DianaHParams, state: DianaState, keys: torch.Tensor):
        return _diana_round(cfg, local_grad, hp, state, keys,
                            group=group or worker_group(), n_total=n_total)

    return step


def diana_sharded_state_specs() -> DianaState:
    """``driver.run_sharded_sweep``'s spec tree for ``DianaState``."""
    return DianaState(w="", h=WORKERS, k="", bits_per_node=WORKERS)


def _cohort_draw(cfg, hp, k_p, n_total: int, cohort: int):
    """The cohort (``fold_in(k_p, COHORT_SALT)``, [G, K] ids) and its
    participation mask (over the cohort axis, from k_p)."""
    idx = cohort_indices(random.fold_in(k_p, COHORT_SALT), n_total, cohort)
    mask = resolve_participation(k_p, n_total, cfg.participation,
                                 cfg.sampling, hp.p, cohort=cohort)
    return idx, mask


def make_diana_cohort_sweep_step(cfg: DianaConfig, local_grad: Callable,
                                 n_total: int, cohort: int):
    """Cohort-subsampled DIANA over an N-client population: a round
    gathers the cohort's rows of the persistent [G, N, d] shift table and
    [G, N] ledger, computes on them and adds the updates back in place
    (``step.in_place``), with no [N, ...] temporary.  Selection,
    participation and keys as ``flecs.make_flecs_cohort_sweep_step``'s."""
    validate_cohort(n_total, cohort)

    def step(hp: DianaHParams, state: DianaState, keys: torch.Tensor):
        d = state.w.shape[-1]
        k_g, k_q, k_p = random.split(keys, 3).unbind(dim=-2)
        idx, mask = _cohort_draw(cfg, hp, k_p, n_total, cohort)
        h_c = cohort_rows(state.h, idx)                        # [G, K, d]
        g = call_oracle(local_grad, k_g, cohort, state.w, ids=idx)
        c = compress_split(hp.spec, k_q, g - h_c, ids=idx)
        g_tilde = masked_mean(c + h_c, mask)
        w = state.w - hp.alpha[:, None] * g_tilde
        cohort_add_(state.h, idx, hp.gamma[:, None, None]
                    * mask[..., None] * c)
        per_round = mask.to(state.bits_per_node.dtype) * spec_bits_many(
            hp.spec, d)[:, None]
        cohort_add_(state.bits_per_node, idx, per_round)
        new = DianaState(w, state.h, _k_next(state.k), state.bits_per_node)
        return new, {"g_tilde_norm": torch.linalg.norm(g_tilde, dim=-1),
                     "n_active": torch.sum(mask, dim=-1),
                     "cohort_bits": torch.sum(per_round, dim=-1)}

    step.in_place = True
    return step


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


class DianaAsyncHParams(NamedTuple):
    """Async point or [G] grid: the sync hparams, tau, buffer_k and the
    traffic model's numbers (or None)."""
    hp: DianaHParams
    tau: object
    buffer_k: object
    traffic: object = None


class DianaAsyncState(NamedTuple):
    w: torch.Tensor
    h: torch.Tensor               # [n, d]
    k: object
    bits_per_node: torch.Tensor   # [n]
    buf: object                   # in-flight {c [n, d], t [n]}
    acc_g: torch.Tensor           # [d] FedBuff sum of arrived c^i + h^i
    acc_n: torch.Tensor           # buffered-update count
    traffic: object = None        # availability chain state
    t: int = 0                    # the round, on the host


def init_diana_async(w0: torch.Tensor, n_workers: int,
                     max_delay: int) -> DianaAsyncState:
    base = init_diana(w0, n_workers)
    d = w0.shape[0]
    f32 = dict(dtype=torch.float32, device=w0.device)
    proto = {"c": torch.zeros((n_workers, d), **f32),
             "t": torch.zeros((n_workers,), **f32)}
    return DianaAsyncState(base.w, base.h, 0, base.bits_per_node,
                           init_buffer(proto, max_delay),
                           torch.zeros((d,), **f32), torch.zeros((), **f32))


def make_diana_async_sweep_step(cfg: DianaConfig, local_grad: Callable,
                                delay_kind: str = "fixed", q: float = 0.5,
                                traffic: Optional[TrafficModel] = None):
    """DIANA with FedBuff-style buffered aggregation over a [G] grid:
    compressed gradient differences arrive late, are billed and update
    the shifts h^i at the arrival round, and the server steps once
    ``buffer_k`` updates have buffered."""
    def step(ahp: DianaAsyncHParams, state: DianaAsyncState,
             keys: torch.Tensor):
        hp = ahp.hp
        n, d = state.h.shape[-2:]
        k_g, k_q, k_p = random.split(keys, 3).unbind(dim=-2)
        mask = resolve_participation(k_p, n, cfg.participation,
                                     cfg.sampling, hp.p)
        route = route_round(delay_kind, q, traffic, ahp, state, keys, mask)
        msgs = None
        if route.sends.any():
            g = call_oracle(local_grad, k_g, n, state.w)
            msgs = {"c": compress_split(hp.spec, k_q, g - state.h)}
        buf, msg = deliver(route, state.buf, msgs)
        arrived = route.arrived
        h = state.h + hp.gamma[:, None, None] * arrived[..., None] * msg["c"]
        bits = state.bits_per_node + arrived.to(
            state.bits_per_node.dtype) * spec_bits_many(hp.spec, d)[:, None]
        acc_g, acc_n, g_tilde, flush, reset = fedbuff_accumulate(
            state.acc_g, state.acc_n, msg["c"] + state.h, arrived,
            ahp.buffer_k)
        w = torch.where(flush[:, None],
                        state.w - hp.alpha[:, None] * g_tilde, state.w)
        new = DianaAsyncState(w, h, _k_next(state.k), bits, buf,
                              reset(acc_g), reset(acc_n), route.tstate,
                              state.t + 1)
        return new, round_aux(route, new.acc_n, flush, state.t, bits,
                              torch.linalg.norm(g_tilde, dim=-1))

    return step


def make_diana_async_step(alpha: float, gamma: float, compressor,
                          local_grad: Callable, schedule: StalenessSchedule,
                          buffer_k, participation: float = 1.0,
                          sampling: str = "bernoulli"):
    """Legacy async entry point (``compressor`` a name, spec or
    ``Compressor``): the async sweep step's [1] grid at the concrete
    (cfg, schedule.tau, buffer_k) point."""
    cfg = DianaConfig(alpha, gamma, compressor, participation, sampling)
    return specialize(
        make_diana_async_sweep_step(cfg, local_grad,
                                    delay_kind=schedule.kind, q=schedule.q),
        _async_hparams(DianaAsyncHParams, diana_hparams_from_config(cfg),
                       schedule.tau, buffer_k))


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


def _newton_direction(H_bar: torch.Tensor, g_bar: torch.Tensor,
                      mu: float) -> torch.Tensor:
    """FedNL's regularised projected direction -[H̄]_μ^{-1} ḡ: eigh of the
    symmetric part plus μI, |λ| floored at μ."""
    d = H_bar.shape[-1]
    Hs = 0.5 * (H_bar + H_bar.mT) + mu * torch.eye(
        d, dtype=torch.float32, device=H_bar.device)
    lam, V = eigh(Hs)
    return -inverse_apply(V, torch.clamp(torch.abs(lam), min=mu), g_bar)


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
        p = _newton_direction(masked_mean(H_new, mask), g_bar, cfg.mu)
        w = state.w + hp.alpha[:, None] * p
        # uncompressed gradient + dimension-aware compressed Hessian diff
        bits = state.bits_per_node + mask.to(state.bits_per_node.dtype) * (
            d * 32.0 + spec_bits_many(hp.spec, d * d))[:, None]
        new = FedNLState(w, H_new, _k_next(state.k), bits)
        return new, {"g_tilde_norm": torch.linalg.norm(g_bar, dim=-1),
                     "n_active": torch.sum(mask, dim=-1),
                     "bits_per_node": bits}

    return step


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


class FedNLAsyncHParams(NamedTuple):
    """Async point or [G] grid: the sync hparams, tau, buffer_k and the
    traffic model's numbers (or None)."""
    hp: FedNLHParams
    tau: object
    buffer_k: object
    traffic: object = None


class FedNLAsyncState(NamedTuple):
    w: torch.Tensor
    H: torch.Tensor               # [n, d, d] per-worker Hessian estimates
    k: object
    bits_per_node: torch.Tensor   # [n]
    buf: object                   # in-flight {g [n, d], D [n, d, d], t [n]}
    acc_g: torch.Tensor           # [d] FedBuff sum of arrived gradients
    acc_H: torch.Tensor           # [d, d] FedBuff sum of arrived H^i
    acc_n: torch.Tensor           # buffered-update count
    traffic: object = None        # availability chain state
    t: int = 0                    # the round, on the host


def init_fednl_async(w0: torch.Tensor, n_workers: int,
                     max_delay: int) -> FedNLAsyncState:
    base = init_fednl(w0, n_workers)
    d = w0.shape[0]
    f32 = dict(dtype=torch.float32, device=w0.device)
    proto = {"g": torch.zeros((n_workers, d), **f32),
             "D": torch.zeros((n_workers, d, d), **f32),
             "t": torch.zeros((n_workers,), **f32)}
    return FedNLAsyncState(base.w, base.H, 0, base.bits_per_node,
                           init_buffer(proto, max_delay),
                           torch.zeros((d,), **f32),
                           torch.zeros((d, d), **f32),
                           torch.zeros((), **f32))


def make_fednl_async_sweep_step(cfg: FedNLConfig, local_grad: Callable,
                                local_hessian: Callable,
                                delay_kind: str = "fixed", q: float = 0.5,
                                traffic: Optional[TrafficModel] = None):
    """FedNL with FedBuff-style buffered aggregation over a [G] grid: the
    compressed Hessian differences arrive late, the server-side H^i learns
    and the full wire price (gradient plus compressed difference) is
    billed at the arrival round, arrived (gradient, H^i) pairs buffer, and
    a flush takes the regularised Newton step from their means (its eigh
    only where a point flushes)."""
    def step(ahp: FedNLAsyncHParams, state: FedNLAsyncState,
             keys: torch.Tensor):
        hp = ahp.hp
        n, d = state.H.shape[-3:-1]
        k_g, k_c, k_p = random.split(keys, 3).unbind(dim=-2)
        mask = resolve_participation(k_p, n, cfg.participation,
                                     cfg.sampling, hp.p)
        route = route_round(delay_kind, q, traffic, ahp, state, keys, mask)
        msgs = None
        if route.sends.any():
            g_all = call_oracle(local_grad, k_g, n, state.w)
            msgs = {"g": g_all, "D": compress_split(
                hp.spec, k_c, local_hessian(state.w) - state.H)}
        buf, msg = deliver(route, state.buf, msgs)
        del msgs
        arrived = route.arrived
        H_new = state.H + arrived[..., None, None] * msg["D"]
        bits = state.bits_per_node + arrived.to(state.bits_per_node.dtype) * (
            d * 32.0 + spec_bits_many(hp.spec, d * d))[:, None]
        acc, acc_n, means, flush, reset = fedbuff_accumulate(
            {"g": state.acc_g, "H": state.acc_H}, state.acc_n,
            {"g": msg["g"], "H": H_new}, arrived, ahp.buffer_k)
        w = state.w
        dir_norm = torch.zeros_like(state.acc_n)
        if route.flushes:
            p = _newton_direction(means["H"], means["g"], cfg.mu)
            w = torch.where(flush[:, None], state.w + hp.alpha[:, None] * p,
                            state.w)
            dir_norm = torch.where(flush, torch.linalg.norm(p, dim=-1),
                                   dir_norm)
        new = FedNLAsyncState(w, H_new, _k_next(state.k), bits, buf,
                              reset(acc["g"]), reset(acc["H"]), reset(acc_n),
                              route.tstate, state.t + 1)
        return new, round_aux(route, new.acc_n, flush, state.t, bits,
                              torch.linalg.norm(means["g"], dim=-1),
                              dir_norm)

    return step


def make_fednl_async_step(alpha: float, compressor, local_grad: Callable,
                          local_hessian: Callable, mu: float,
                          schedule: StalenessSchedule, buffer_k,
                          participation: float = 1.0,
                          sampling: str = "bernoulli"):
    """Legacy async entry point: the async sweep step's [1] grid at the
    concrete (cfg, schedule.tau, buffer_k) point."""
    cfg = FedNLConfig(alpha, compressor, mu, participation, sampling)
    return specialize(
        make_fednl_async_sweep_step(cfg, local_grad, local_hessian,
                                    delay_kind=schedule.kind, q=schedule.q),
        _async_hparams(FedNLAsyncHParams, fednl_hparams_from_config(cfg),
                       schedule.tau, buffer_k))


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


def make_gd_cohort_sweep_step(cfg: GDConfig, local_grad: Callable,
                              n_total: int, cohort: int):
    """Cohort-subsampled uncompressed GD: only the cohort's gradients a
    round; the persistent [G, N] ledger updated in place.  Selection and
    participation as the DIANA and FLECS cohort engines'."""
    validate_cohort(n_total, cohort)

    def step(hp: GDHParams, state: GDState, keys: torch.Tensor):
        d = state.w.shape[-1]
        k_g, k_p = random.split(keys, 2).unbind(dim=-2)
        idx, mask = _cohort_draw(cfg, hp, k_p, n_total, cohort)
        g = masked_mean(call_oracle(local_grad, k_g, cohort, state.w,
                                    ids=idx), mask)
        per_round = mask.to(state.bits_per_node.dtype) * (d * 32.0)
        cohort_add_(state.bits_per_node, idx, per_round)
        new = GDState(state.w - hp.alpha[:, None] * g, _k_next(state.k),
                      state.bits_per_node)
        return new, {"g_tilde_norm": torch.linalg.norm(g, dim=-1),
                     "n_active": torch.sum(mask, dim=-1),
                     "cohort_bits": torch.sum(per_round, dim=-1)}

    step.in_place = True
    return step


def make_gd_step(alpha: float, local_grad: Callable, n_workers: int,
                 participation: float = 1.0, sampling: str = "bernoulli"):
    """Legacy entry point: the sweep step at a concrete hparams point."""
    cfg = GDConfig(alpha, participation, sampling)
    return specialize(make_gd_sweep_step(cfg, local_grad, n_workers),
                      gd_hparams_from_config(cfg))


def init_gd(w0: torch.Tensor, n_workers: int) -> GDState:
    base = _init(w0, n_workers)
    return GDState(base["w"], base["k"], base["bits_per_node"])


class GDAsyncHParams(NamedTuple):
    """Async point or [G] grid: the sync hparams, tau, buffer_k and the
    traffic model's numbers (or None)."""
    hp: GDHParams
    tau: object
    buffer_k: object
    traffic: object = None


class GDAsyncState(NamedTuple):
    w: torch.Tensor
    k: object
    bits_per_node: torch.Tensor   # [n]
    buf: object                   # in-flight {g [n, d], t [n]}
    acc_g: torch.Tensor           # [d]
    acc_n: torch.Tensor
    traffic: object = None        # availability chain state
    t: int = 0                    # the round, on the host


def init_gd_async(w0: torch.Tensor, n_workers: int,
                  max_delay: int) -> GDAsyncState:
    base = init_gd(w0, n_workers)
    f32 = dict(dtype=torch.float32, device=w0.device)
    proto = {"g": torch.zeros((n_workers, w0.shape[0]), **f32),
             "t": torch.zeros((n_workers,), **f32)}
    return GDAsyncState(base.w, 0, base.bits_per_node,
                        init_buffer(proto, max_delay),
                        torch.zeros((w0.shape[0],), **f32),
                        torch.zeros((), **f32))


def make_gd_async_sweep_step(cfg: GDConfig, local_grad: Callable,
                             n_workers: int, delay_kind: str = "fixed",
                             q: float = 0.5,
                             traffic: Optional[TrafficModel] = None):
    """Uncompressed GD with buffered delayed gradients over a [G] grid,
    the classic stale-gradient baseline."""
    def step(ahp: GDAsyncHParams, state: GDAsyncState, keys: torch.Tensor):
        hp = ahp.hp
        d = state.w.shape[-1]
        k_g, k_p = random.split(keys, 2).unbind(dim=-2)
        mask = resolve_participation(k_p, n_workers, cfg.participation,
                                     cfg.sampling, hp.p)
        route = route_round(delay_kind, q, traffic, ahp, state, keys, mask)
        msgs = None
        if route.sends.any():
            msgs = {"g": call_oracle(local_grad, k_g, n_workers, state.w)}
        buf, msg = deliver(route, state.buf, msgs)
        arrived = route.arrived
        bits = state.bits_per_node + arrived.to(
            state.bits_per_node.dtype) * (d * 32.0)
        acc_g, acc_n, g, flush, reset = fedbuff_accumulate(
            state.acc_g, state.acc_n, msg["g"], arrived, ahp.buffer_k)
        w = torch.where(flush[:, None], state.w - hp.alpha[:, None] * g,
                        state.w)
        new = GDAsyncState(w, _k_next(state.k), bits, buf, reset(acc_g),
                           reset(acc_n), route.tstate, state.t + 1)
        return new, round_aux(route, new.acc_n, flush, state.t, bits,
                              torch.linalg.norm(g, dim=-1))

    return step


def make_gd_async_step(alpha: float, local_grad: Callable, n_workers: int,
                       schedule: StalenessSchedule, buffer_k,
                       participation: float = 1.0,
                       sampling: str = "bernoulli"):
    """Legacy async entry point: the async sweep step's [1] grid at the
    concrete (cfg, schedule.tau, buffer_k) point."""
    cfg = GDConfig(alpha, participation, sampling)
    return specialize(
        make_gd_async_sweep_step(cfg, local_grad, n_workers,
                                 delay_kind=schedule.kind, q=schedule.q),
        _async_hparams(GDAsyncHParams, gd_hparams_from_config(cfg),
                       schedule.tau, buffer_k))
