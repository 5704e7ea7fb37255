"""The paper's comparison figures as ``ExperimentPlan``s, and the rows their
JSON files hold (the port's own copy of ``benchmarks/paper_experiments.py``'s
plans and row builders).

    fig1_plan            FLECS vs FLECS-CGD (an identity/dither64 family
                         axis) for m in {1, 2, 4, 8}
    baselines_plan       FLECS-CGD, DIANA, FedNL and GD, one point each
    participation_plan   FLECS-CGD over a Bernoulli p axis (1, 0.5, 0.25)
    budget_fair_plan     all five methods to the same bit budgets
    sketch_families_plan FLECS-CGD over a gradient-compressor family axis
                         (dither64, topk0.25, count_sketch64, minmax0.5)

``fig1_rows``, ``participation_rows``, ``budget_fair_rows`` and
``sketch_families_rows`` turn a ``PlanResult`` into the rows of
``fig1_flecs_vs_cgd.json``, ``participation.json``, ``budget_fair.json``
and ``sketch_families.json``; ``budget_fair_rows``
checks, as the reference does, that every (method, budget) point reached
its budget and that its ledger stays bit-stable after it froze.

The async engine's experiments (``benchmarks/paper_experiments.py`` and
``benchmarks/traffic_bench.py``):

    async_grid           FLECS-CGD (m = 2, exact-k p = 0.5) over a (tau ×
                         buffer_k) grid, alpha auto-damped, one batched
                         run (``driver.run_async_sweep``); rows as
                         ``async_grid.json``'s
    staleness_ablation   FLECS-CGD under fixed and geometric delays ×
                         participation, one legacy async run a row
    legacy_steps         each method's legacy async step beside its sync
                         step (exact-k p = 0.5), for the card checks
    traffic_plan         the five methods on the async engine (tau, buffer_k
                         2) under a traffic profile: "fixed" (no model),
                         "poisson" or "diurnal" arrivals with the default
                         availability chain and admission (cutoff 3,
                         6 in flight); ``traffic_rows`` / ``run_profiles``
                         give ``traffic_bench.json``'s rows
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.api import (ExperimentPlan, MethodRun, get_method,
                                  run_plan)
from repro_torch.core.compressors import spec_omega, stack_specs
from repro_torch.core.driver import (StalenessSchedule, run_async_sweep,
                                     run_experiment)
from repro_torch.core.flecs import (FlecsConfig, FlecsHParams,
                                    async_hparam_grid, dither_grid,
                                    hparams_round_bits, init_async_state,
                                    init_state, make_flecs_async_step,
                                    make_flecs_async_sweep_step,
                                    make_flecs_step)
from repro_torch.core.traffic import (AdmissionPolicy, ArrivalSchedule,
                                      AvailabilityModel, TrafficModel)
from repro_torch.optim import baselines as tb
from repro_torch.optim.baselines import DianaConfig, FedNLConfig, GDConfig

FIG1_MS = (1, 2, 4, 8)
FIG1_FAMILIES = ("FLECS", "FLECS-CGD")       # grid order of the family axis
PARTICIPATION_PS = (1.0, 0.5, 0.25)
BUDGET_GRID_MULTS = (2.0, 8.0, 32.0)
SKETCH_FAMILY_NAMES = ("dither64", "topk0.25", "count_sketch64",
                       "minmax0.5")


def fig1_plan(prob, iters=300) -> ExperimentPlan:
    """Fig 1/2: the FLECS-vs-FLECS-CGD comparison as a compressor-family
    grid axis (identity vs dither64) inside each sketch-size segment."""
    fam = stack_specs("identity", "dither64")
    flecs_m = get_method("flecs_cgd")
    return ExperimentPlan(
        problem=prob,
        runs=tuple(
            MethodRun("flecs_cgd",
                      cfg=FlecsConfig(m=m, alpha=1.0, beta=1.0, gamma=1.0,
                                      hess_compressor="dither64"),
                      hparams=flecs_m.grid(grad_specs=fam),
                      label=f"m{m}")
            for m in FIG1_MS),
        iters=iters)


def baselines_plan(prob, iters=200) -> ExperimentPlan:
    """The four-method comparison; FedNL keeps its shorter round budget."""
    return ExperimentPlan(
        problem=prob,
        runs=(
            MethodRun("flecs_cgd",
                      cfg=FlecsConfig(m=2, grad_compressor="dither64",
                                      hess_compressor="dither64"),
                      label="FLECS-CGD"),
            MethodRun("diana", cfg=DianaConfig(alpha=1.0, gamma=0.5,
                                               compressor="dither64"),
                      label="DIANA"),
            MethodRun("fednl", cfg=FedNLConfig(alpha=1.0,
                                               compressor="topk0.25",
                                               mu=prob.mu),
                      iters=min(iters, 80), label="FedNL"),
            MethodRun("gd", cfg=GDConfig(alpha=2.0), label="GD"),
        ),
        iters=iters)


def participation_plan(prob, iters=300) -> ExperimentPlan:
    """The participation ablation as one grid axis: a Bernoulli p per point,
    paired with a damped alpha."""
    G = len(PARTICIPATION_PS)
    full = lambda v: torch.full((G,), v, dtype=torch.float32)  # noqa: E731
    hp = FlecsHParams(
        alpha=torch.tensor([1.0 if p == 1.0 else 0.5
                            for p in PARTICIPATION_PS], dtype=torch.float32),
        gamma=full(1.0), beta=full(1.0),
        grad_spec=dither_grid([64.0] * G),
        hess_spec=dither_grid([64.0] * G),
        p=torch.tensor(PARTICIPATION_PS, dtype=torch.float32))
    return ExperimentPlan(
        problem=prob,
        runs=(MethodRun("flecs_cgd", cfg=FlecsConfig(m=2), hparams=hp,
                        label="participation"),),
        iters=iters)


def sketch_families_plan(prob, iters=200) -> ExperimentPlan:
    """The four non-trivial gradient-compressor families — random
    dithering, top-k, count sketch, min-max sampling — as one grid axis of
    FLECS-CGD m=2 (``stack_specs``)."""
    hp = get_method("flecs_cgd").grid(
        grad_specs=stack_specs(*SKETCH_FAMILY_NAMES))
    return ExperimentPlan(
        problem=prob,
        runs=(MethodRun("flecs_cgd", cfg=FlecsConfig(m=2), hparams=hp,
                        label="families"),),
        iters=iters)


def budget_fair_budgets(prob):
    """The per-node budget grid, in multiples of one uncompressed 32-bit
    d-vector."""
    return tuple(c * 32.0 * prob.d for c in BUDGET_GRID_MULTS)


def budget_fair_plan(prob) -> ExperimentPlan:
    """All five methods to the same bit budgets: five runs × a [3] budget
    axis; each run's round count is an upper bound from its wire price and
    the budget freeze equalizes the bits."""
    return ExperimentPlan(
        problem=prob,
        runs=(
            MethodRun("flecs",
                      cfg=FlecsConfig(m=1, grad_compressor="identity",
                                      hess_compressor="dither64"),
                      label="FLECS"),
            MethodRun("flecs_cgd",
                      cfg=FlecsConfig(m=1, grad_compressor="dither64",
                                      hess_compressor="dither64"),
                      label="FLECS-CGD"),
            MethodRun("diana", cfg=DianaConfig(alpha=1.0, gamma=0.5,
                                               compressor="dither64"),
                      label="DIANA"),
            MethodRun("fednl", cfg=FedNLConfig(alpha=1.0,
                                               compressor="topk0.25",
                                               mu=prob.mu),
                      label="FedNL"),
            MethodRun("gd", cfg=GDConfig(alpha=2.0), label="GD"),
        ),
        bit_budget=budget_fair_budgets(prob))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def trace_rows(tr: dict, g: int, iters: int, every: int = 5) -> list:
    """Grid point g's rows of one run's {F, grad_sq, bits_per_node [n]}
    traces, every ``every``-th round and the last."""
    F = _np(tr["F"][g])
    g2 = _np(tr["grad_sq"][g])
    bits = _np(tr["bits_per_node"][g]).max(axis=1)
    return [{"iter": k, "F": float(F[k]), "grad_sq": float(g2[k]),
             "bits_per_node": float(bits[k])}
            for k in range(iters) if k % every == 0 or k == iters - 1]


def fig1_rows(res, iters: int, every: int = 5) -> dict:
    """``fig1_flecs_vs_cgd.json``: one row list per (family, m)."""
    return {f"{name}-m{m}": trace_rows(res.traces[f"m{m}"], g, iters, every)
            for m in FIG1_MS for g, name in enumerate(FIG1_FAMILIES)}


def participation_rows(res) -> list:
    """``participation.json``: final F and grad_sq, mean Mbit a node and
    mean active workers a round, per p."""
    st = res.states["participation"]
    tr = res.traces["participation"]
    return [{"p": p, "F": float(_np(tr["F"][g, -1])),
             "grad_sq": float(_np(tr["grad_sq"][g, -1])),
             "Mbits_mean": float(_np(torch.mean(st.bits_per_node[g]))) / 1e6,
             "active_mean": float(_np(torch.mean(tr["n_active"][g])))}
            for g, p in enumerate(PARTICIPATION_PS)]


def budget_fair_rows(res, budgets) -> list:
    """``budget_fair.json``: per (method, budget) the final F and grad_sq,
    the final ledger and the live rounds run.  Fails unless every point
    reached its budget and its ledger stayed bit-stable after."""
    rows = []
    for lab in res.labels:
        tr = res.traces[lab]
        bits = _np(tr["bits_per_node"])               # [B, T, n]
        for b, budget in enumerate(budgets):
            ledger = np.max(bits[b], axis=1)           # [T] max-worker bits
            reached = np.flatnonzero(ledger >= budget)
            if not reached.size:
                raise AssertionError(f"{lab} never reached the budget "
                                     f"{budget}: {float(ledger[-1])}")
            rounds = int(reached[0]) + 1               # live rounds run
            if not np.all(ledger[rounds - 1:] == ledger[rounds - 1]):
                raise AssertionError(f"{lab} at budget {budget}: ledger "
                                     "moved after the freeze")
            rows.append({"method": lab, "budget": float(budget),
                         "F": float(_np(tr["F"][b, -1])),
                         "grad_sq": float(_np(tr["grad_sq"][b, -1])),
                         "bits_per_node": float(ledger[-1]),
                         "rounds": rounds})
    return rows


def sketch_families_rows(res, d: int) -> list:
    """``sketch_families.json``: per family the wire price a round and ω
    (exact: host arithmetic), the final F and grad_sq, and the mean Mbit a
    node."""
    hp = res.hparams["families"]
    st, tr = res["families"]
    price = hparams_round_bits(FlecsConfig(m=2), hp, d)
    omega = spec_omega(hp.grad_spec, d).numpy()
    return [{"family": name, "round_bits": float(price[g]),
             "omega": float(omega[g]),
             "F": float(_np(tr["F"][g, -1])),
             "grad_sq": float(_np(tr["grad_sq"][g, -1])),
             "Mbits_mean": float(_np(torch.mean(st.bits_per_node[g]))) / 1e6}
            for g, name in enumerate(SKETCH_FAMILY_NAMES)]



# ---------------------------------------------------------------------------
# The async engine: staleness grids and traffic profiles
# ---------------------------------------------------------------------------

ASYNC_GRID_TAUS = (0, 2, 4)
ASYNC_GRID_P = 0.5
TRAFFIC_METHODS = ("flecs", "flecs_cgd", "diana", "fednl", "gd")
TRAFFIC_PROFILES = ("fixed", "poisson", "diurnal")
DIURNAL_RATES = (0.9, 0.5, 0.2, 0.5)
POISSON_RATE = 0.6


def async_grid_ks(n: int) -> tuple:
    """The flush thresholds of the grid: 1, n/4 and n (distinct, sorted)."""
    return tuple(sorted({1.0, float(max(1, n // 4)), float(n)}))


def async_grid_setup(prob, taus=ASYNC_GRID_TAUS, ks=None):
    """(config, sweep step, hparams grid, initial state) of
    :func:`async_grid`: FLECS-CGD m = 2, dither64 / dither64, exact-k
    p = 0.5, the (tau × buffer_k) grid with alpha auto-damped
    (``flecs.async_hparam_grid(auto_damp=(p, n))``)."""
    n = prob.n_workers
    cfg = FlecsConfig(m=2, grad_compressor="dither64",
                      hess_compressor="dither64",
                      participation=ASYNC_GRID_P, sampling="choice")
    ahp = async_hparam_grid(taus, async_grid_ks(n) if ks is None else ks,
                            alpha=1.0, auto_damp=(ASYNC_GRID_P, n))
    sweep = make_flecs_async_sweep_step(cfg, *prob.make_oracles())
    st0 = init_async_state(torch.zeros(prob.d, device=prob.A.device), n,
                           cfg.m, max(taus))
    return cfg, sweep, ahp, st0


def async_grid(prob, iters=600, taus=ASYNC_GRID_TAUS, ks=None):
    """The (tau × buffer_k) staleness grid as one batched run on the
    problem's device, key ``key(0)``: (rows, seconds)."""
    _, sweep, ahp, st0 = async_grid_setup(prob, taus, ks)
    dev = prob.A.device
    t0 = time.perf_counter()
    sts, tr = run_async_sweep(sweep, ahp, st0, random.key(0, dev), iters,
                              record=lambda st: prob.metrics(st.w))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return async_grid_rows(ahp, sts, tr), seconds


def async_grid_rows(ahp, sts, tr) -> list:
    """``async_grid.json``'s rows: per point tau, K, alpha, the final F
    and grad_sq, the mean Mbit a node and the flushes."""
    return [{"tau": int(ahp.tau[g]), "K": float(ahp.buffer_k[g]),
             "alpha": float(ahp.hp.alpha[g]),
             "F": float(_np(tr["F"][g, -1])),
             "grad_sq": float(_np(tr["grad_sq"][g, -1])),
             "Mbits_mean": float(_np(torch.mean(sts.bits_per_node[g]))) / 1e6,
             "flushes": float(_np(torch.sum(tr["flushed"][g])))}
            for g in range(int(ahp.tau.shape[0]))]


STALENESS_CELLS = (("fixed", 0), ("fixed", 2), ("fixed", 4),
                   ("geometric", 4))


def staleness_ablation(prob, iters=600, cells=STALENESS_CELLS,
                       ps=(1.0, 0.5)) -> list:
    """FedBuff-style FLECS-CGD over (delay kind, tau) × participation, one
    legacy async run a row (``record_every=5``); tau = 0, p = 1 is the
    synchronous engine.  Rows as the reference's ``staleness.json``."""
    lg, lh = prob.make_oracles()
    n = prob.n_workers
    dev = prob.A.device
    rows = []
    for kind, tau in cells:
        for p in ps:
            alpha = 1.0 if (tau == 0 and p == 1.0) else 0.2
            cfg = FlecsConfig(m=2, alpha=alpha, grad_compressor="dither64",
                              hess_compressor="dither64", participation=p,
                              sampling="choice")
            sched = StalenessSchedule(kind, tau=tau, q=0.5)
            K = n if (tau == 0 and p == 1.0) else max(1, n // 4)
            step = make_flecs_async_step(cfg, lg, lh, sched, buffer_k=K)
            st, tr = run_experiment(
                step, init_async_state(torch.zeros(prob.d, device=dev), n,
                                       cfg.m, sched.max_delay),
                random.key(0, dev), iters, record_every=5,
                record=lambda st: prob.metrics(st.w))
            arr = _np(tr["n_arrived"])
            stale = float((_np(tr["staleness_mean"]) * arr).sum()
                          / max(arr.sum(), 1.0))
            rows.append({"kind": kind, "tau": tau, "p": p, "K": K,
                         "alpha": alpha, "F": float(_np(tr["F"][-1])),
                         "grad_sq": float(_np(tr["grad_sq"][-1])),
                         "Mbits_mean": float(_np(torch.mean(
                             st.bits_per_node))) / 1e6,
                         "staleness_mean": stale})
    return rows


LEGACY_METHODS = ("FLECS-CGD", "DIANA", "FedNL", "GD")


def legacy_steps(method: str, prob, kind: str, tau: int, K: float):
    """((async step, state), (sync step, state)) of one of
    ``LEGACY_METHODS`` through its legacy makers, exact-k p = 0.5, under a
    ``StalenessSchedule(kind, tau, q=0.5)`` and buffer_k ``K``, on the
    problem's device: FLECS-CGD m = 2 (alpha 0.5, 0.2 when stale), DIANA
    dither64 (lr 1, alpha 0.5), FedNL topk0.25 (alpha 0.5), GD lr 1."""
    sched = StalenessSchedule(kind, tau=tau, q=0.5)
    samp = dict(participation=0.5, sampling="choice")
    n, w0 = prob.n_workers, torch.zeros(prob.d, device=prob.A.device)
    lg, lh = prob.make_oracles()
    if method == "FLECS-CGD":
        cfg = FlecsConfig(m=2, alpha=0.2 if tau else 0.5, **samp)
        return ((make_flecs_async_step(cfg, lg, lh, sched, K),
                 init_async_state(w0, n, 2, tau)),
                (make_flecs_step(cfg, lg, lh), init_state(w0, n)))
    if method == "DIANA":
        return ((tb.make_diana_async_step(1.0, 0.5, "dither64", lg, sched, K,
                                          **samp),
                 tb.init_diana_async(w0, n, tau)),
                (tb.make_diana_step(1.0, 0.5, "dither64", lg, **samp),
                 tb.init_diana(w0, n)))
    if method == "FedNL":
        return ((tb.make_fednl_async_step(0.5, "topk0.25", lg,
                                          prob.local_hessian, prob.mu, sched,
                                          K, **samp),
                 tb.init_fednl_async(w0, n, tau)),
                (tb.make_fednl_step(0.5, "topk0.25", lg, prob.local_hessian,
                                    prob.mu, **samp),
                 tb.init_fednl(w0, n)))
    return ((tb.make_gd_async_step(1.0, lg, n, sched, K, **samp),
             tb.init_gd_async(w0, n, tau)),
            (tb.make_gd_step(1.0, lg, n, **samp), tb.init_gd(w0, n)))


def traffic_model(profile: str):
    """A profile's TrafficModel (None for "fixed", the plain delays)."""
    if profile == "fixed":
        return None
    arrival = (ArrivalSchedule("poisson", rates=(POISSON_RATE,))
               if profile == "poisson"
               else ArrivalSchedule("diurnal", rates=DIURNAL_RATES))
    return TrafficModel(arrival=arrival, availability=AvailabilityModel(),
                        admission=AdmissionPolicy(staleness_cutoff=3.0,
                                                  max_in_flight=6.0))


def traffic_plan(prob, profile: str, iters: int, tau: int,
                 model=None) -> ExperimentPlan:
    """The five methods on the async engine (fixed delays up to tau,
    buffer_k 2) under a traffic profile (``model`` overrides the
    profile's); FedNL damped to alpha 0.5, as the reference damps it."""
    def run(m):
        if m != "fednl":
            return MethodRun(m)
        return MethodRun(m, cfg=FedNLConfig(alpha=0.5, mu=prob.mu))

    return ExperimentPlan(
        problem=prob, runs=tuple(run(m) for m in TRAFFIC_METHODS),
        iters=iters, seed=0,
        staleness=StalenessSchedule("fixed", tau=tau), buffer_k=2.0,
        traffic=traffic_model(profile) if model is None else model)


def traffic_rows(profile: str, res) -> list:
    """``traffic_bench.json``'s rows of one profile's result: per method
    the final F and the mean Mbit a node."""
    rows = []
    for m in TRAFFIC_METHODS:
        F = float(_np(res.traces[m]["F"][0, -1]))
        if not np.isfinite(F):
            raise AssertionError(f"{profile} {m}: F {F}")
        rows.append({"profile": profile, "method": m, "F": F,
                     "Mbits_mean": float(np.mean(_np(
                         res.states[m].bits_per_node[0]))) / 1e6})
    return rows


def run_profiles(prob, iters: int, tau: int) -> list:
    """Every profile's plan, run in turn: their rows."""
    rows = []
    for profile in TRAFFIC_PROFILES:
        rows += traffic_rows(profile, run_plan(traffic_plan(prob, profile,
                                                            iters, tau)))
    return rows
