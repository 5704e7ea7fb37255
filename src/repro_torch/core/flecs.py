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

Population scale (the reference's hierarchy, cohort and sharded engines).
``FlecsConfig.hierarchy`` (``core.hierarchy``) puts an edge tier between
the workers and the server: each edge's partial sum re-compressed with the
traced ``FlecsHParams.edge_spec`` (``hparam_grid(edge_levels=)``), billed
on the [n_edges] ``edge_bits`` ledger; the async step does not read it, as
in the reference.  :func:`make_flecs_cohort_sweep_step` runs a stratified
cohort of K of N clients a round over a [N, d] shift table and one shared
d×d curvature (:class:`FlecsCohortState`), updated in place.
:func:`make_flecs_sharded_sweep_step` runs a rank's block of the workers
under ``driver.run_sharded_sweep``.  Both compress a worker's rows under
``split(k, N)[id]`` of its global id (the keyed kernel's row ids).

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
from repro_torch.core.driver import (COHORT_SALT, WORKERS,
                                     StalenessSchedule, WorkerGroup,
                                     bits_dtype, call_oracle, cohort_indices,
                                     damped_alpha, fedbuff_accumulate,
                                     gather_workers, init_buffer,
                                     masked_mean, resolve_participation,
                                     shard_rows, specialize, sum_workers,
                                     validate_cohort, validate_ps,
                                     worker_group)
from repro_torch.core.hierarchy import (EDGE_SALT, HierarchyConfig,
                                        charge_edges, edge_combine,
                                        edge_combine_cohort, edge_round_bits,
                                        init_edge_bits, validate_hierarchy)
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
    hierarchy: Optional[HierarchyConfig] = None
                                      # two-tier server tree: edges
                                      # re-compress per-edge partial sums,
                                      # billed on the edge_bits ledger
                                      # (core.hierarchy)

    @property
    def rho_val(self):
        return 1.0 / self.Omega if self.rho is None else self.rho


class FlecsHParams(NamedTuple):
    """Per-round hyperparameters: step sizes alpha (iterate) and gamma
    (shift), the direct-update rate beta, both compressor specs, and
    optionally a Bernoulli participation probability p (None: the config's
    static ``participation``), a per-node bit budget (None: unbounded;
    else the budget-freeze mode, ``driver.freeze_on_bit_budget``) and the
    edge-tier compressor of hierarchical aggregation (None for a config
    without ``hierarchy``).

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
    edge_spec: Optional[CompressorSpec] = None

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
                        make_spec(cfg.hess_compressor),
                        edge_spec=(None if cfg.hierarchy is None else
                                   make_spec(cfg.hierarchy.edge_compressor)))


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
    build dithering specs; ``ps`` adds a Bernoulli participation axis;
    ``edge_levels`` an edge-tier dithering axis (:func:`cross_edge_levels`;
    a config with ``hierarchy`` set)."""
    validate_ps(ps)
    axes = [np.asarray(v, np.float32).reshape(-1) for v in (
        alphas, gammas, grad_levels, betas, hess_levels,
        [1.0] if ps is None else ps)]
    a, g, s, b, hs, p = (m.ravel() for m in np.meshgrid(*axes,
                                                         indexing="ij"))
    t = torch.as_tensor
    hp = FlecsHParams(t(a), t(g), t(b), dither_grid(s), dither_grid(hs),
                      None if ps is None else t(p))
    return hp if edge_levels is None else cross_edge_levels(hp, edge_levels)


def cross_edge_levels(hp: FlecsHParams, edge_levels) -> FlecsHParams:
    """Cross a [G] grid with an edge-tier dithering axis (the reference's
    order, base-major): every point repeated E times, the E levels tiled
    over them, [G·E] leaves."""
    from repro_torch.core.driver import map_hparams
    E = len(edge_levels)
    hp = map_hparams(hp, lambda v: v.repeat_interleave(E, dim=0),
                     lambda sp: _repeat_spec(sp, E))
    G = hp.alpha.shape[0] // E
    return hp._replace(edge_spec=dither_grid(
        np.tile(np.asarray(edge_levels, np.float32).reshape(-1), G)))


def _repeat_spec(spec: CompressorSpec, reps: int) -> CompressorSpec:
    """A grid spec's points each repeated ``reps`` times (``jnp.repeat``)."""
    return grid_spec(tuple(f for f in spec.family for _ in range(reps)),
                     np.repeat(spec.s_host, reps),
                     np.repeat(spec.frac_host, reps), spec.s.device,
                     type(spec.params_host)(*(np.repeat(v, reps)
                                              for v in spec.params_host)))


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
    edge_bits: Optional[torch.Tensor] = None
                           # [n_edges] cumulative backhaul bits an edge
                           # (hierarchical aggregation only)


def init_state(w0: torch.Tensor, n_workers: int,
               n_edges: Optional[int] = None) -> FlecsState:
    """Zero shifts, zero curvature and empty ledgers on ``w0``'s device;
    ``n_edges`` allocates the backhaul ledger (pass
    ``cfg.hierarchy.n_edges`` iff the config aggregates hierarchically)."""
    d = w0.shape[0]
    dev = w0.device
    return FlecsState(
        w=w0.to(torch.float32),
        h=torch.zeros((n_workers, d), dtype=torch.float32, device=dev),
        B=torch.zeros((n_workers, d, d), dtype=torch.float32, device=dev),
        k=0,
        bits_per_node=torch.zeros(n_workers, dtype=bits_dtype(), device=dev),
        edge_bits=None if n_edges is None else init_edge_bits(n_edges, dev),
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
                     w, h, B, S, k_g, k_h, k_q, k_c, ids=None):
    """Worker compute phase of Algorithm 1 for all n workers of every grid
    point at once.  Minibatch oracles draw worker i's rows from
    ``fold_in(k_g, i)`` (gradient) and ``fold_in(k_h, i)`` (HVP).

    Returns (c [G,n,d], M [G,n,m,m], C [G,n,d,m], BS [G,n,d,m]): the
    compressed gradient differences, the exact Grams SᵀY, the compressed
    Hessian-sketch differences and B S, at the iterates ``w`` [G, d].

    ids: the rows' global worker ids where they are a subset of the
    federation (a shard's block [n], a cohort [G, n]): the oracles compute
    those workers, and row i is compressed with ``split(k, N)[ids[i]]``,
    the key the dense engine gives that worker (the keyed kernel's row ids
    on the card; for a cohort this is the reference's ``fold_in(k, id)``,
    the same pair below 2**32)."""
    n = h.shape[-2]
    g = call_oracle(local_grad, k_g, n, w, ids=ids)     # [G, n, d]
    Y = call_oracle(local_hvp, k_h, n, w, S, ids=ids)   # [G, n, d, m]
    M = S.mT @ Y                                        # [n, m, m] (exact)
    c = compress_split(grad_spec, k_q, g - h, ids=ids)
    BS = B @ S
    Cm = compress_split(hess_spec, k_c, Y - BS, ids=ids)
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


def _hierarchy_guards(cfg: FlecsConfig, hp, state, n: int) -> None:
    """The hierarchical rounds' contract checks (dense, sharded, cohort)."""
    if hp.edge_spec is None:
        raise ValueError(
            "FlecsConfig.hierarchy requires hparams carrying an edge_spec "
            "(hparams_from_config fills it from the config; grids pass "
            "edge_levels=...)")
    if state.edge_bits is None:
        raise ValueError(
            "FlecsConfig.hierarchy requires init_state(..., n_edges="
            "cfg.hierarchy.n_edges) so the backhaul ledger exists")
    validate_hierarchy(cfg.hierarchy, n)


def _edge_means(hp, state, keys, mask, parts, combine):
    """The hierarchical server: (g̃, Ỹ, M̄, edge_bits') from the per-worker
    (g̃^i, Ỹ^i, M^i) ``parts``, each two-tier summed by ``combine(spec,
    key, x)`` (-> (sum, edge_active)) under ``fold_in(fold_in(key,
    EDGE_SALT), 0/1/2)`` and divided by max(Σ mask, 1); the backhaul
    ledger charged ``edge_round_bits`` an active edge."""
    d, m = parts[1].shape[-2:]
    k_e = random.fold_in(keys, EDGE_SALT)
    denom = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    means, edge_active = [], None
    for j, x in enumerate(parts):
        total, active = combine(hp.edge_spec, random.fold_in(k_e, j), x)
        edge_active = active if edge_active is None else edge_active
        means.append(total / denom.reshape((-1,) + (1,) * (x.dim() - 2)))
    edge_bits = charge_edges(state.edge_bits, edge_active,
                             edge_round_bits(hp.edge_spec, d, m))
    return means[0], means[1], means[2], edge_bits


def _flecs_round(cfg: FlecsConfig, local_grad: Callable, local_hvp: Callable,
                 hp: FlecsHParams, state: FlecsState, keys: torch.Tensor,
                 group: Optional[WorkerGroup] = None,
                 n_total: Optional[int] = None):
    """One round of Algorithm 1 with client sampling at every point of a
    batched state; ``hp`` a [G] grid on the state's device, ``keys``
    [G, 2].

    group/n_total: under ``driver.run_sharded_sweep`` the state's worker
    leaves are this rank's contiguous block of the ``n_total``-worker
    federation.  The block computes its workers' messages under their
    global ids and the global key stream, the full-federation arrays are
    rebuilt with ``all_gather`` and the integer-exact active count summed
    over the ranks, and the server math runs replicated on the gathered
    arrays: the dense round's ops on the same values.  ``group=None`` is
    the dense round (the reference's ``axis=None``)."""
    n_loc, d = state.h.shape[-2:]
    n = n_loc if group is None else n_total
    m = cfg.m
    dev = state.w.device
    S = sketch(cfg.sketch_kind, d, m, state.t, dev)

    k_g, k_h, k_q, k_c, k_p = random.split(keys, 5).unbind(dim=-2)
    # the full-federation mask: the same draw on every rank
    mask = resolve_participation(k_p, n, cfg.participation, cfg.sampling,
                                 hp.p)                          # [G, n]
    if group is None:
        ids, mask_loc = None, mask
    else:
        ids = shard_rows(group, n, dev)
        mask_loc = mask[:, group.rank * n_loc:(group.rank + 1) * n_loc]

    c_all, M_all, C_all, BS_all = _worker_messages(
        local_grad, local_hvp, hp.grad_spec, hp.hess_spec,
        state.w, state.h, state.B, S, k_g, k_h, k_q, k_c, ids=ids)

    g_tilde_i = c_all + state.h                          # [G, n_loc, d]
    Y_tilde_i = C_all + BS_all                           # [G, n_loc, d, m]
    B_upd = _update_B(cfg, hp.beta.reshape(-1, 1, 1, 1), state.B, Y_tilde_i,
                      M_all, S)
    # only sampled workers communicated a Hessian difference this round
    B_new = torch.where(mask_loc[..., None, None] > 0, B_upd, state.B)
    del B_upd

    # full-federation aggregates (replicated under sharding)
    if group is None:
        g_i, Y_i, M_i = g_tilde_i, Y_tilde_i, M_all
        n_active = torch.sum(mask, dim=-1)
    else:
        g_i, Y_i, M_i = (gather_workers(x, group)
                         for x in (g_tilde_i, Y_tilde_i, M_all))
        # a sum of {0, 1} counts over the ranks: exact, == sum(mask)
        n_active = sum_workers(torch.sum(mask_loc, dim=-1), group)

    if cfg.hierarchy is not None:
        _hierarchy_guards(cfg, hp, state, n)
        E = cfg.hierarchy.n_edges
        g_tilde, Y_tilde, M_bar, edge_bits = _edge_means(
            hp, state, keys, mask, (g_i, Y_i, M_i),
            lambda spec, k, x: edge_combine(spec, k, x, mask, E))
    else:
        g_tilde = masked_mean(g_i, mask)
        Y_tilde = masked_mean(Y_i, mask)
        M_bar = masked_mean(M_i, mask)
        edge_bits = state.edge_bits
    # B̄ ([G, d, d]) is server-side curvature, not wire traffic: a flat
    # mean under hierarchy, consumed only by the truncated-inverse
    # direction (the only case that gathers B under sharding)
    B_bar = None
    if cfg.direction == "truncated_inverse":
        B_bar = masked_mean(B_new if group is None
                            else gather_workers(B_new, group), mask)

    p = _direction(cfg, g_tilde, Y_tilde, M_bar, B_bar)
    w_new = state.w + hp.alpha[:, None] * p
    h_new = state.h + hp.gamma[:, None, None] * mask_loc[..., None] * c_all

    bits_new = (state.bits_per_node + mask_loc.to(state.bits_per_node.dtype)
                * _grid_round_bits(hp, d, m)[:, None])
    new_state = FlecsState(w_new, h_new, B_new,
                           None if state.k is None else state.k + 1,
                           bits_new, state.t + 1, edge_bits)
    aux = {"g_tilde_norm": torch.linalg.norm(g_tilde, dim=-1),
           "dir_norm": torch.linalg.norm(p, dim=-1),
           "n_active": n_active,
           "bits_per_node": bits_new}
    if edge_bits is not None:
        aux["edge_bits"] = edge_bits
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
# Sharded engine (the worker axis over a process group)
# ---------------------------------------------------------------------------

def make_flecs_sharded_sweep_step(cfg: FlecsConfig, local_grad: Callable,
                                  local_hvp: Callable, n_total: int,
                                  group: Optional[WorkerGroup] = None):
    """The sweep step for ``driver.run_sharded_sweep``: the signature of
    ``make_flecs_sweep_step``'s, the state's worker leaves this rank's
    block of the ``n_total``-worker federation (``group``: the
    ``driver.worker_group`` of the run, the default group where None).
    The oracles take ``ids=`` (the block's global worker ids)."""
    def step(hp: FlecsHParams, state: FlecsState, keys: torch.Tensor):
        return _flecs_round(cfg, local_grad, local_hvp, hp, state, keys,
                            group=group or worker_group(), n_total=n_total)

    return step


def sharded_state_specs(hierarchy: bool = False) -> FlecsState:
    """``driver.run_sharded_sweep``'s spec tree for ``FlecsState``: the
    per-worker leaves (h, B, bits_per_node) shard over the ranks; the
    iterate, the counters and the [n_edges] backhaul ledger (its edges
    span ranks) stay replicated."""
    return FlecsState(w="", h=WORKERS, B=WORKERS, k="",
                      bits_per_node=WORKERS, t="",
                      edge_bits="" if hierarchy else None)


# ---------------------------------------------------------------------------
# Cohort engine (population-scale client subsampling)
# ---------------------------------------------------------------------------

class FlecsCohortState(NamedTuple):
    """Population-scale server state: O(N·d) per-client arrays and one
    SHARED d×d curvature, never O(N·d²).  N appears only in the shift
    table ``h`` and the uplink ledger ``bits_per_node``; a round gathers
    the cohort's rows, computes on [K, ...] arrays and adds the updates
    back in place at distinct ids.  The Hessian approximation is shared
    (the population variant of Algorithm 1): the directions only consume
    aggregate curvature."""
    w: torch.Tensor        # [d]
    h: torch.Tensor        # [N, d]  per-client gradient shifts
    B: torch.Tensor        # [d, d]  SHARED Hessian approximation
    k: object              # iteration counter
    bits_per_node: torch.Tensor   # [N] cumulative uplink bits per client
    t: int = 0             # batched states: the sketch's round counter
    edge_bits: Optional[torch.Tensor] = None   # [n_edges] backhaul ledger


def init_cohort_state(w0: torch.Tensor, n_total: int,
                      n_edges: Optional[int] = None) -> FlecsCohortState:
    d = w0.shape[0]
    dev = w0.device
    return FlecsCohortState(
        w=w0.to(torch.float32),
        h=torch.zeros((n_total, d), dtype=torch.float32, device=dev),
        B=torch.zeros((d, d), dtype=torch.float32, device=dev),
        k=0,
        bits_per_node=torch.zeros(n_total, dtype=bits_dtype(), device=dev),
        edge_bits=None if n_edges is None else init_edge_bits(n_edges, dev))


def cohort_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx [G, K] of each point's table [G, N, ...]: [G, K, ...]."""
    G, K = idx.shape
    return table[torch.arange(G, device=idx.device)[:, None], idx]


def cohort_add_(table: torch.Tensor, idx: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """``table[g, idx[g, k]] += rows[g, k]`` in place, for distinct ids
    (one add a cell: on the card one atomic a cell, so the bits do not
    depend on an order); no [N] temporary.  Returns ``table``."""
    G, N = table.shape[:2]
    flat = (idx + N * torch.arange(G, device=idx.device)[:, None]).reshape(-1)
    table.view((G * N,) + table.shape[2:]).index_add_(
        0, flat, rows.reshape((-1,) + table.shape[2:]))
    return table


def make_flecs_cohort_sweep_step(cfg: FlecsConfig, local_grad: Callable,
                                 local_hvp: Callable, n_total: int,
                                 cohort: int):
    """The cohort-subsampled sweep step: each round draws a size-K cohort
    of the N-client population (``driver.cohort_indices``: one client a
    stratum, from ``fold_in(k_p, COHORT_SALT)``), samples participation
    over the cohort axis only, and works on [K, ...] arrays, so a round's
    compute and memory above the persistent state do not depend on N.  The
    round key splits as the dense round's, and worker ``id`` compresses
    with ``fold_in(k, id)`` (the keyed kernel's row ids): at ``cohort ==
    n_total`` the selection is the identity and the masks and keys are the
    dense engine's.

    The persistent [G, N, d] shift table and [G, N] ledger are updated in
    place (``step.in_place``): ``driver.run_sweep``'s batched copy of the
    initial state is what the rounds own, the caller's stays untouched.
    The oracles take ``ids=`` ([G, K]).  Direct Hessian updates only (the
    L-SR1 update needs per-client state)."""
    if cfg.hessian_update != "direct":
        raise ValueError(
            "the cohort engine maintains a SHARED Hessian approximation "
            "and supports hessian_update='direct' only (L-SR1 needs "
            f"per-client state), got {cfg.hessian_update!r}")
    validate_cohort(n_total, cohort)

    def step(hp: FlecsHParams, state: FlecsCohortState, keys: torch.Tensor):
        d = state.w.shape[-1]
        m = cfg.m
        S = sketch(cfg.sketch_kind, d, m, state.t, state.w.device)
        k_g, k_h, k_q, k_c, k_p = random.split(keys, 5).unbind(dim=-2)
        idx = cohort_indices(random.fold_in(k_p, COHORT_SALT), n_total,
                             cohort)                            # [G, K]
        # over the cohort axis only, from the dense draw's key
        mask = resolve_participation(k_p, n_total, cfg.participation,
                                     cfg.sampling, hp.p, cohort=cohort)

        h_c = cohort_rows(state.h, idx)                         # [G, K, d]
        B_rows = state.B.unsqueeze(1)                           # [G, 1, d, d]
        c_c, M_c, C_c, BS_c = _worker_messages(
            local_grad, local_hvp, hp.grad_spec, hp.hess_spec,
            state.w, h_c, B_rows, S, k_g, k_h, k_q, k_c, ids=idx)
        g_tilde_i = c_c + h_c                                   # [G, K, d]
        Y_tilde_i = C_c + BS_c                                  # [G, K, d, m]
        B_upd = _update_B(cfg, hp.beta.reshape(-1, 1, 1, 1), B_rows,
                          Y_tilde_i, M_c, S)                    # [G, K, d, d]
        # the shared curvature: the mean of the active members' updates;
        # a round with nobody active leaves B as it was
        any_active = torch.sum(mask, dim=-1) > 0
        B_new = torch.where(any_active[:, None, None],
                            masked_mean(B_upd, mask), state.B)
        del B_upd

        if cfg.hierarchy is not None:
            _hierarchy_guards(cfg, hp, state, n_total)
            E = cfg.hierarchy.n_edges
            g_tilde, Y_tilde, M_bar, edge_bits = _edge_means(
                hp, state, keys, mask, (g_tilde_i, Y_tilde_i, M_c),
                lambda spec, k, x: edge_combine_cohort(
                    spec, k, x, mask, idx, n_total, E))
        else:
            g_tilde = masked_mean(g_tilde_i, mask)
            Y_tilde = masked_mean(Y_tilde_i, mask)
            M_bar = masked_mean(M_c, mask)
            edge_bits = state.edge_bits

        p = _direction(cfg, g_tilde, Y_tilde, M_bar, B_new)
        w_new = state.w + hp.alpha[:, None] * p
        # the cohort's updates added back in place, at distinct ids
        cohort_add_(state.h, idx, hp.gamma[:, None, None]
                    * mask[..., None] * c_c)
        per_round = (mask.to(state.bits_per_node.dtype)
                     * _grid_round_bits(hp, d, m)[:, None])
        cohort_add_(state.bits_per_node, idx, per_round)

        new_state = FlecsCohortState(
            w_new, state.h, B_new, None if state.k is None else state.k + 1,
            state.bits_per_node, state.t + 1, edge_bits)
        aux = {"g_tilde_norm": torch.linalg.norm(g_tilde, dim=-1),
               "dir_norm": torch.linalg.norm(p, dim=-1),
               "n_active": torch.sum(mask, dim=-1),
               "cohort_bits": torch.sum(per_round, dim=-1)}
        if edge_bits is not None:
            aux["edge_bits"] = edge_bits
        return new_state, aux

    step.in_place = True
    return step


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
    resets them.  A config's ``hierarchy`` is not read here (nor in the
    reference's async step): the flat server, no backhaul ledger."""
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
