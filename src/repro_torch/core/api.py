"""Method registry + ``ExperimentPlan``: every optimizer behind one
sweep-native API (counterpart of ``repro.core.api``, its synchronous
lowering).

* :class:`MethodSpec` — a method as data: ``init(problem, n, cfg)``, one
  sweep step ``step(hp, state, keys)``, an hparam grid constructor
  ``grid(...)`` and ``from_config(cfg)``, and its wire price
  ``round_bits``.  :func:`get_method` resolves ``"flecs" | "flecs_cgd" |
  "diana" | "fednl" | "gd"``.
* :class:`MethodRun` — one structural segment of a figure: a method, its
  static config and a [G] hparam grid.
* :class:`ExperimentPlan` + :func:`run_plan` — a figure as data, run on the
  problem's device.  The reference composes every run's ``vmap``ped scan
  into one jitted program; here each run is one batched program over its
  [G] grid (``driver.sweep_program``), the runs one after another.  The
  reference's compile counter (``plan_compiles``) is an artifact of jit and
  has no counterpart.
* ``ExperimentPlan.bit_budget`` — budget-fair comparisons: a budget grid
  crossed with every run's hparam grid (:func:`cross_bit_budget`, point
  ``b·G + g``) and enforced by the budget-freeze mode
  (``driver.freeze_on_bit_budget``), with each run's round count an upper
  bound from its wire price (``driver.iters_for_bit_budget``, priced on the
  host).

* ``ExperimentPlan.staleness`` — a ``driver.StalenessSchedule`` switches
  every run to its method's async engine (all five methods have one), with
  ``buffer_k`` broadcast over the run's grid; ``ExperimentPlan.traffic``
  (a ``core.traffic.TrafficModel``, which needs ``staleness``) layers
  arrivals, availability and admission on it, its numbers broadcast over
  the grid and the availability chain seeded in the state.  Budget runs
  stretch their round bound by (tau + 1) for the arrival billing.

Key streams (the reference's): run j of a plan sweeps with
``fold_in(key(plan.seed), j)``, and its grid point g steps with
``split(split(fold_in(key(seed), j), G)[g], iters)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import flecs
from repro_torch.core.compressors import (CompressorSpec, as_grid, is_grid,
                                          make_spec, tile_spec)
from repro_torch.core.driver import (StalenessSchedule, bits_dtype, grid1,
                                     grid_size, hparams_bit_budget,
                                     hparams_to, iters_for_bit_budget,
                                     sweep_keys, sweep_program, tile_hparams)
from repro_torch.core.traffic import (TrafficHParams, TrafficModel,
                                      init_traffic_state, traffic_hparams)
from repro_torch.optim import baselines


# ---------------------------------------------------------------------------
# MethodSpec registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """A federated method as data — everything :func:`run_plan` needs.

    init:        (problem, n_workers, cfg) -> the unbatched initial state
                 (iterate 0, on the problem's device), shared by the grid.
    sweep_step:  (problem, cfg) -> step(hp, state, keys [G, 2]).
    grid:        keyword axes -> [G] hparam grid (cartesian).
    from_config: cfg -> the hparams point of the legacy step.
    init_async / async_sweep_step / async_wrap: the FedBuff-style buffered
                 engine (None: the method has none):
                 ``init_async(problem, n, cfg, max_delay)``,
                 ``async_sweep_step(problem, cfg, delay_kind, q, traffic)``
                 and ``async_wrap(hp, tau, buffer_k)``, which broadcasts
                 the staleness axes over the grid.
    round_bits:  (problem, cfg, hp) -> per-participating-worker uplink bits
                 of one round at each grid point (float32 numpy [G], priced
                 on the host), which sets budget runs' lengths.
    """
    name: str
    config_cls: type
    default_config: Callable[[], Any]
    init: Callable[[Any, int, Any], Any]
    sweep_step: Callable[[Any, Any], Callable]
    grid: Callable[..., Any]
    from_config: Callable[[Any], Any]
    init_async: Optional[Callable] = None
    async_sweep_step: Optional[Callable] = None
    async_wrap: Optional[Callable] = None
    round_bits: Optional[Callable] = None


def _broadcast(hp, tau, buffer_k, wrapper):
    """Wrap a [G] grid with tau (int32 [G]) and buffer_k (float32 [G])."""
    G = grid_size(hp)
    return wrapper(hp, torch.full((G,), int(tau), dtype=torch.int32),
                   torch.full((G,), float(buffer_k), dtype=torch.float32))


def _bcast_spec(spec: CompressorSpec, G: int) -> CompressorSpec:
    """A scalar spec or a [1] grid as a [G] grid; a [G] grid as it is."""
    if is_grid(spec) and len(spec.family) == 1 and G > 1:
        return tile_spec(spec, G)
    return as_grid(spec, G)


def _flecs_grid(alphas=(1.0,), gammas=(1.0,), betas=(1.0,),
                grad_levels=(64.0,), hess_levels=(64.0,), ps=None,
                grad_specs=None, hess_specs=None,
                edge_levels=None) -> flecs.FlecsHParams:
    """FLECS grid with optional explicit spec arguments: a stacked spec
    (``compressors.stack_specs``) replaces its slot's level axis with a
    K-point axis (the other axes must then be scalar); a scalar spec pins
    the compressor for every grid point."""
    hp = flecs.hparam_grid(alphas, gammas, grad_levels, betas=betas,
                           hess_levels=hess_levels, ps=ps,
                           edge_levels=edge_levels)
    if grad_specs is None and hess_specs is None:
        return hp
    if grad_specs is not None and len(grad_levels) > 1:
        raise ValueError("grad_levels and grad_specs are mutually "
                         "exclusive ways to set the gradient compressor")
    if hess_specs is not None and len(hess_levels) > 1:
        raise ValueError("hess_levels and hess_specs are mutually "
                         "exclusive ways to set the Hessian compressor")
    G = hp.alpha.shape[0]
    Ks = [len(s.family) for s in (grad_specs, hess_specs)
          if s is not None and is_grid(s)]
    if len(set(Ks)) > 1:
        raise ValueError(f"grad_specs/hess_specs axes disagree: {Ks}")
    K = Ks[0] if Ks else 1
    if K > 1 and G > 1:
        raise ValueError(
            "a stacked spec axis replaces the level axes: pass scalar "
            "level/alpha/p axes (or build the FlecsHParams grid directly) "
            f"— got a level grid of size {G}")
    Gf = max(G, K)

    def fix(spec, default):
        return _bcast_spec(default if spec is None else make_spec(spec), Gf)

    def scal(a):
        return a.expand(Gf).contiguous()

    return flecs.FlecsHParams(
        scal(hp.alpha), scal(hp.gamma), scal(hp.beta),
        fix(grad_specs, hp.grad_spec), fix(hess_specs, hp.hess_spec),
        None if hp.p is None else scal(hp.p))


def _zeros_w(prob) -> torch.Tensor:
    return torch.zeros(prob.d, dtype=torch.float32, device=prob.A.device)


def _flecs_spec(name: str, default_grad: str) -> MethodSpec:
    def default_config():
        return flecs.FlecsConfig(grad_compressor=default_grad)

    def grid(alphas=(1.0,), gammas=(1.0,), betas=(1.0,), grad_levels=None,
             hess_levels=(64.0,), ps=None, grad_specs=None,
             hess_specs=None, edge_levels=None):
        """:func:`_flecs_grid` with the gradient compressor defaulting to
        this method's own."""
        if grad_levels is None and grad_specs is None:
            grad_specs = make_spec(default_grad)
        return _flecs_grid(
            alphas, gammas, betas,
            grad_levels if grad_levels is not None else (64.0,),
            hess_levels, ps, grad_specs, hess_specs, edge_levels)

    return MethodSpec(
        name=name,
        config_cls=flecs.FlecsConfig,
        default_config=default_config,
        init=lambda prob, n, cfg: flecs.init_state(_zeros_w(prob), n),
        sweep_step=lambda prob, cfg: flecs.make_flecs_sweep_step(
            cfg, *prob.make_oracles()),
        grid=grid,
        from_config=flecs.hparams_from_config,
        init_async=lambda prob, n, cfg, max_delay: flecs.init_async_state(
            _zeros_w(prob), n, cfg.m, max_delay),
        async_sweep_step=lambda prob, cfg, kind, q, traffic=None:
            flecs.make_flecs_async_sweep_step(cfg, *prob.make_oracles(),
                                              delay_kind=kind, q=q,
                                              traffic=traffic),
        async_wrap=lambda hp, tau, K: _broadcast(
            hp, tau, K, flecs.FlecsAsyncHParams),
        round_bits=lambda prob, cfg, hp: flecs.hparams_round_bits(
            cfg, hp, prob.d),
    )


_REGISTRY: Dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec) -> MethodSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"method {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_method(name: str) -> MethodSpec:
    """Resolve a registry name ("flecs", "flecs_cgd", "diana", "fednl",
    "gd") to its :class:`MethodSpec`."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown method {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


def method_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_method(_flecs_spec("flecs", "identity"))
register_method(_flecs_spec("flecs_cgd", "dither64"))

register_method(MethodSpec(
    name="diana",
    config_cls=baselines.DianaConfig,
    default_config=baselines.DianaConfig,
    init=lambda prob, n, cfg: baselines.init_diana(_zeros_w(prob), n),
    sweep_step=lambda prob, cfg: baselines.make_diana_sweep_step(
        cfg, prob.make_oracles()[0]),
    grid=baselines.diana_hparam_grid,
    from_config=baselines.diana_hparams_from_config,
    init_async=lambda prob, n, cfg, max_delay: baselines.init_diana_async(
        _zeros_w(prob), n, max_delay),
    async_sweep_step=lambda prob, cfg, kind, q, traffic=None:
        baselines.make_diana_async_sweep_step(
            cfg, prob.make_oracles()[0], delay_kind=kind, q=q,
            traffic=traffic),
    async_wrap=lambda hp, tau, K: _broadcast(
        hp, tau, K, baselines.DianaAsyncHParams),
    round_bits=lambda prob, cfg, hp: baselines.diana_round_bits(
        cfg, hp, prob.d),
))

register_method(MethodSpec(
    name="fednl",
    config_cls=baselines.FedNLConfig,
    default_config=baselines.FedNLConfig,
    init=lambda prob, n, cfg: baselines.init_fednl(_zeros_w(prob), n),
    sweep_step=lambda prob, cfg: baselines.make_fednl_sweep_step(
        cfg, prob.make_oracles()[0], prob.local_hessian),
    grid=baselines.fednl_hparam_grid,
    from_config=baselines.fednl_hparams_from_config,
    init_async=lambda prob, n, cfg, max_delay: baselines.init_fednl_async(
        _zeros_w(prob), n, max_delay),
    async_sweep_step=lambda prob, cfg, kind, q, traffic=None:
        baselines.make_fednl_async_sweep_step(
            cfg, prob.make_oracles()[0], prob.local_hessian,
            delay_kind=kind, q=q, traffic=traffic),
    async_wrap=lambda hp, tau, K: _broadcast(
        hp, tau, K, baselines.FedNLAsyncHParams),
    round_bits=lambda prob, cfg, hp: baselines.fednl_round_bits(
        cfg, hp, prob.d),
))

register_method(MethodSpec(
    name="gd",
    config_cls=baselines.GDConfig,
    default_config=baselines.GDConfig,
    init=lambda prob, n, cfg: baselines.init_gd(_zeros_w(prob), n),
    sweep_step=lambda prob, cfg: baselines.make_gd_sweep_step(
        cfg, prob.make_oracles()[0], prob.n_workers),
    grid=baselines.gd_hparam_grid,
    from_config=baselines.gd_hparams_from_config,
    init_async=lambda prob, n, cfg, max_delay: baselines.init_gd_async(
        _zeros_w(prob), n, max_delay),
    async_sweep_step=lambda prob, cfg, kind, q, traffic=None:
        baselines.make_gd_async_sweep_step(
            cfg, prob.make_oracles()[0], prob.n_workers,
            delay_kind=kind, q=q, traffic=traffic),
    async_wrap=lambda hp, tau, K: _broadcast(
        hp, tau, K, baselines.GDAsyncHParams),
    round_bits=lambda prob, cfg, hp: baselines.gd_round_bits(
        cfg, hp, prob.d),
))


# ---------------------------------------------------------------------------
# ExperimentPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MethodRun:
    """One structural segment of a plan.

    method:  registry name or a :class:`MethodSpec`.
    cfg:     static config (None => the method's default).
    hparams: [G] hparam grid (None => ``from_config(cfg)`` as a [1] grid);
             in an async plan it may be the method's async hparams (with
             ``tau``), else it is wrapped with the plan's tau and buffer_k.
    iters:   per-run override of the plan's round count.
    label:   result key (defaults to the method name, deduplicated).
    """
    method: Union[str, MethodSpec]
    cfg: Any = None
    hparams: Any = None
    iters: Optional[int] = None
    label: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ExperimentPlan:
    """A figure as data: problem + method runs + schedule knobs.

    record:     optional (batched state) -> dict of extra trace entries;
                defaults to ``problem.metrics(state.w)``.
    bit_budget: a per-node uplink bit budget (scalar) or a budget grid
                (sequence), crossed with every run's grid (point ``b·G +
                g``) and enforced by the budget freeze; runs without an
                explicit ``iters`` get an upper-bound round count from
                their wire price (stretched by 1/p_min under sampling).
                The async runs' bound is stretched by (tau + 1) and
                tau more rounds (arrival billing).
    staleness:  a ``StalenessSchedule``: every run takes its method's async
                engine, ``buffer_k`` the FedBuff flush threshold on every
                grid point.
    traffic:    a ``TrafficModel`` on every run's async engine (needs
                ``staleness``): its numbers broadcast over each run's grid
                (unless the run's async hparams carry their own), the
                availability chain seeded in the state.
    """
    problem: Any
    runs: Sequence[MethodRun]
    iters: int = 200
    seed: int = 0
    record_every: int = 1
    trace_dtype: Any = None
    record: Optional[Callable] = None
    staleness: Optional[StalenessSchedule] = None
    buffer_k: float = 1.0
    bit_budget: Any = None
    traffic: Optional[TrafficModel] = None


@dataclasses.dataclass
class PlanResult:
    """run_plan output: per-run final states / traces / hparams, keyed by
    run label (leading [G] grid axis on every tensor)."""
    labels: Tuple[str, ...]
    states: Dict[str, Any]
    traces: Dict[str, Any]
    hparams: Dict[str, Any]
    seconds: float

    def __getitem__(self, label: str):
        return self.states[label], self.traces[label]


def _validate_p(spec: MethodSpec, cfg, hp) -> None:
    p = getattr(getattr(hp, "hp", hp), "p", None)
    if p is None:
        return
    if getattr(cfg, "sampling", "bernoulli") != "bernoulli":
        raise ValueError(
            f"run {spec.name!r}: a traced participation axis requires "
            f"sampling='bernoulli', got {cfg.sampling!r}")
    p_host = np.asarray(p.cpu(), np.float32)
    if np.any(p_host <= 0):
        raise ValueError(
            f"run {spec.name!r}: participation p must be > 0, got {p_host}")


def cross_bit_budget(hp, budgets):
    """Cross a [B] bit-budget axis with an hparam grid's [G] points.

    Returns (hparams', budgets') with [B·G] leaves: point ``b·G + g``
    pairs ``budgets[b]`` with grid point g; the budgets, in
    ``driver.bits_dtype()`` as the ledger they gate, land on the sync
    hparams' ``bit_budget`` slot (an async grid's inner ``hp``)."""
    sync = getattr(hp, "hp", hp)
    if not hasattr(sync, "bit_budget"):
        raise ValueError(
            f"hparams {type(hp).__name__} carry no bit_budget slot")
    budgets = torch.atleast_1d(torch.as_tensor(
        np.asarray(budgets, np.float64), dtype=bits_dtype()))
    G = grid_size(hp)
    tiled = tile_hparams(hp, budgets.shape[0])
    bud = torch.repeat_interleave(budgets, G).to(sync.alpha.device)
    if sync is hp:
        return tiled._replace(bit_budget=bud), bud
    return tiled._replace(hp=tiled.hp._replace(bit_budget=bud)), bud


def _budget_scan_len(spec: MethodSpec, plan: ExperimentPlan, cfg, hp,
                     bud) -> int:
    """Upper bound on the rounds a budget run can charge: the reference's
    ``iters_for_bit_budget`` over the (budget × wire-price) grid, stretched
    by 1/p_min under client sampling and, for an async run, by (tau + 1)
    plus tau rounds (busy exclusion spaces a worker's messages tau + 1
    rounds apart; host values only)."""
    if spec.round_bits is None:
        raise ValueError(
            f"method {spec.name!r} has no round_bits price query; pass "
            "run.iters explicitly to combine it with plan.bit_budget")
    sync = getattr(hp, "hp", hp)
    prices = np.asarray(spec.round_bits(plan.problem, cfg, sync), float)
    iters = iters_for_bit_budget(bud.cpu().numpy(), prices)
    p_axis = getattr(sync, "p", None)
    p_min = (float(np.min(p_axis.cpu().numpy())) if p_axis is not None
             else float(getattr(cfg, "participation", 1.0)))
    if p_min < 1.0:
        iters = int(np.ceil(iters / p_min))
    if hasattr(hp, "tau"):
        tau_max = int(hp.tau.max())
        iters = iters * (tau_max + 1) + tau_max
    return iters


def _resolve(plan: ExperimentPlan, run: MethodRun):
    spec = run.method if isinstance(run.method, MethodSpec) else get_method(
        run.method)
    cfg = run.cfg if run.cfg is not None else spec.default_config()
    if not isinstance(cfg, spec.config_cls):
        raise TypeError(
            f"run {spec.name!r}: cfg must be a {spec.config_cls.__name__}, "
            f"got {type(cfg).__name__}")
    hp = run.hparams
    if hp is None:
        hp = grid1(spec.from_config(cfg))
    _validate_p(spec, cfg, hp)
    bud = None
    if plan.bit_budget is not None:
        if hparams_bit_budget(hp) is not None:
            raise ValueError(
                f"run {spec.name!r}: hparams already carry a bit_budget "
                "axis — drop plan.bit_budget or the hparams axis")
        budgets = np.atleast_1d(np.asarray(plan.bit_budget, np.float64))
        if budgets.ndim != 1 or np.any(budgets <= 0):
            raise ValueError(
                "plan.bit_budget must be a positive scalar or a 1-D grid "
                f"of positive budgets, got {np.asarray(plan.bit_budget)}")
        hp, bud = cross_bit_budget(hp, budgets)
    n = plan.problem.n_workers
    if plan.staleness is not None:
        if spec.async_sweep_step is None:
            raise ValueError(
                f"method {spec.name!r} has no async variant — drop it from "
                "the plan or clear plan.staleness")
        sched = plan.staleness
        step = spec.async_sweep_step(plan.problem, cfg, sched.kind, sched.q,
                                     plan.traffic)
        state = spec.init_async(plan.problem, n, cfg, sched.max_delay)
        if not hasattr(hp, "tau"):
            hp = spec.async_wrap(hp, sched.tau, plan.buffer_k)
        if plan.traffic is not None:
            # seed the availability chain; broadcast the model's numbers
            # over the run's grid unless its hparams carry their own
            state = state._replace(traffic=init_traffic_state(
                n, state.w.device))
            if getattr(hp, "traffic", None) is None:
                G = grid_size(hp)
                hp = hp._replace(traffic=TrafficHParams(*(
                    a.unsqueeze(0).expand((G,) + a.shape).contiguous()
                    for a in traffic_hparams(plan.traffic))))
        # the buffer-shape guard: a tau beyond the slots would wrap modulo
        # them and silently act as a shorter delay
        slots = state.buf.occupied.shape[-2]
        tau_max = int(hp.tau.max())
        if tau_max + 1 > slots:
            raise ValueError(
                f"run {spec.name!r}: shared MessageBuffer has {slots} "
                f"slot(s) but the hparam grid reaches tau={tau_max}; raise "
                f"plan.staleness.tau to >= {tau_max}")
    else:
        if plan.traffic is not None:
            raise ValueError(
                "plan.traffic rides the async engine's buffered path — set "
                "plan.staleness (tau=0 for synchronous-delay traffic) or "
                "drop the traffic model")
        if hasattr(hp, "tau"):
            raise ValueError(
                f"run {spec.name!r}: async hparams (tau/buffer_k axes) "
                "require plan.staleness — set a StalenessSchedule or pass "
                "sync hparams")
        step = spec.sweep_step(plan.problem, cfg)
        state = spec.init(plan.problem, n, cfg)
    if run.iters is not None:
        iters = run.iters
    elif bud is not None:
        iters = _budget_scan_len(spec, plan, cfg, hp, bud)
        if plan.record_every > 1:
            iters = -(-iters // plan.record_every) * plan.record_every
    else:
        iters = plan.iters
    return spec, cfg, hp, step, state, iters


def run_plan(plan: ExperimentPlan) -> PlanResult:
    """Run every run of a plan on the problem's device, each as one batched
    program over its [G] grid.  Run j, grid point g is the standalone
    ``run_experiment`` with key ``split(fold_in(key(plan.seed), j),
    G)[g]``."""
    if not plan.runs:
        raise ValueError("plan has no runs")
    prob = plan.problem
    dev = prob.A.device
    record = plan.record
    if record is None:
        record = lambda st: prob.metrics(st.w)              # noqa: E731

    labels, states, traces, hps = [], {}, {}, {}
    base = random.key(plan.seed, dev)
    t0 = time.perf_counter()
    for j, run in enumerate(plan.runs):
        spec, cfg, hp, step, state, iters = _resolve(plan, run)
        label = run.label or spec.name
        while label in labels:
            label = f"{label}#{j}"
        labels.append(label)
        G = grid_size(hp)
        fn = sweep_program(step, iters, record=record,
                           record_every=plan.record_every,
                           trace_dtype=plan.trace_dtype)
        states[label], traces[label] = fn(
            hparams_to(hp, dev), state,
            sweep_keys(random.fold_in(base, j), G, iters))
        hps[label] = hp
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return PlanResult(labels=tuple(labels), states=states, traces=traces,
                      hparams=hps, seconds=time.perf_counter() - t0)
