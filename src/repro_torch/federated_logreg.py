"""Method comparison on one federated problem: FLECS vs FLECS-CGD vs DIANA
vs FedNL vs GD — objective against communicated bits (counterpart of
``examples/federated_logreg.py``).

    PYTHONPATH=src python -m repro_torch.federated_logreg --device cpu
    PYTHONPATH=src python -m repro_torch.federated_logreg --method fednl
    PYTHONPATH=src python -m repro_torch.federated_logreg \\
        --participation 1.0,0.5,0.25      # a Bernoulli p axis, one grid a run
    PYTHONPATH=src python -m repro_torch.federated_logreg \\
        --bit-budget 200000               # budget-fair: equal bits a node

    PYTHONPATH=src python -m repro_torch.federated_logreg --staleness 2 \\
        --delay-kind geometric --participation 0.5
    PYTHONPATH=src python -m repro_torch.federated_logreg --staleness 4 \\
        --arrival-profile diurnal --participation 0.5

Every method is resolved through the registry (``core.api.get_method``) and
the invocation is one ``ExperimentPlan`` (``core.api.run_plan``), each
method's participation levels one [G] grid.  It runs on the card unless
``--device cpu`` is given.  A comma-list of --participation values is a
Bernoulli p axis; a single value < 1 is the config's static rate, sampled
by --sampling: "choice" (the default, the reference example's) takes
exactly max(1, round(p·n)) workers a round, "bernoulli" each worker with
probability p.

With --staleness TAU > 0 every method runs on its FedBuff-style async
engine: updates arrive late (by --delay-kind, at most TAU rounds), buffer
until --buffer-k have arrived (0: n/4, at least 1) and are billed at the
arrival round; a stale/round column gives the mean age of the applied
updates.  --auto-alpha takes the step size from ``driver.damped_alpha``
(alpha0 · min(1, p·K/n)).  --arrival-profile poisson / diurnal replaces the
delay draw with a ``core.traffic`` arrival process (rate 0.6, or the
4-phase table 0.9, 0.5, 0.2, 0.5), TAU the cap.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.api import ExperimentPlan, MethodRun, run_plan
from repro_torch.core.compressors import as_grid, make_spec
from repro_torch.core.driver import StalenessSchedule, damped_alpha
from repro_torch.core.flecs import FlecsConfig, FlecsHParams
from repro_torch.core.traffic import ArrivalSchedule, TrafficModel
from repro_torch.data.logreg import make_problem
from repro_torch.optim.baselines import (DianaConfig, DianaHParams,
                                         FedNLConfig, FedNLHParams, GDConfig,
                                         GDHParams)

METHOD_ORDER = ("flecs", "flecs_cgd", "diana", "fednl", "gd")


def build_runs(method: str, iters: int, budgeted: bool, prob, ps, alphas,
               sampling: str = "choice", staleness: int = 0):
    """One MethodRun per selected method; a multi-valued p list rides along
    as a Bernoulli p axis of each run's grid, paired with its own alpha per
    point; a single p is the configs' static rate, drawn by ``sampling``."""
    sweeping = len(ps) > 1
    static = dict(participation=ps[0] if not sweeping else 1.0,
                  sampling=sampling if not sweeping else "bernoulli")
    G = len(ps)
    p_axis = torch.tensor(ps, dtype=torch.float32) if sweeping else None
    a_axis = torch.tensor(alphas, dtype=torch.float32)
    full = lambda v: torch.full((G,), v, dtype=torch.float32)  # noqa: E731

    def spec(name):
        return as_grid(make_spec(name), G)

    runs = []
    for name in METHOD_ORDER if method == "all" else (method,):
        if name in ("flecs", "flecs_cgd"):
            gc = "identity" if name == "flecs" else "dither64"
            cfg = FlecsConfig(m=1, alpha=float(alphas[0]),
                              grad_compressor=gc,
                              hess_compressor="dither64", **static)
            hp = FlecsHParams(a_axis, full(1.0), full(1.0), spec(gc),
                              spec("dither64"), p_axis)
        elif name == "diana":
            cfg = DianaConfig(alpha=1.0, gamma=0.5, compressor="dither64",
                              **static)
            hp = DianaHParams(full(1.0), full(0.5), spec("dither64"), p_axis)
        elif name == "fednl":
            cfg = FedNLConfig(alpha=float(alphas[0]), compressor="topk0.25",
                              mu=prob.mu, **static)
            hp = FedNLHParams(a_axis, spec("topk0.25"), p_axis)
        else:
            gd_alpha = 2.0 if staleness == 0 else 1.0
            cfg = GDConfig(alpha=gd_alpha, **static)
            hp = GDHParams(full(gd_alpha), p_axis)
        # budget-fair runs take their length from their wire price
        n_iters = (None if budgeted
                   else min(iters, 80) if name == "fednl" else iters)
        runs.append(MethodRun(name, cfg=cfg, hparams=hp, iters=n_iters))
    return runs


def print_rows(res, ps, budget: float = 0.0) -> None:
    for lab in res.labels:
        st, tr = res[lab]
        for g, p in enumerate(ps):
            F = float(tr["F"][g, -1])
            gn = float(torch.sqrt(tr["grad_sq"][g, -1]))
            mbits = float(torch.max(st.bits_per_node[g])) / 1e6
            # budget mode: average activity over the live rounds only
            ledger = torch.amax(tr["bits_per_node"][g], dim=-1)
            hit = torch.nonzero(ledger >= budget) if budget > 0 else None
            live = (int(hit[0, 0]) + 1 if hit is not None and len(hit)
                    else ledger.shape[0])
            active = float(torch.mean(tr["n_active"][g, :live]))
            name = lab if len(ps) == 1 else f"{lab}@p={p}"
            line = (f"{name:18s} F={F:.6f} ||grad||={gn:.2e} "
                    f"Mbits/node={mbits:7.3f} active/round={active:5.1f}")
            if "staleness_mean" in tr:
                arr = tr["n_arrived"][g]
                stale = float(torch.sum(tr["staleness_mean"][g] * arr)
                              / torch.clamp(torch.sum(arr), min=1.0))
                line += f" stale/round={stale:4.2f}"
            print(line)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.federated_logreg",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--d", type=int, default=123)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--workers", type=int, default=20)
    ap.add_argument("--method", default="all",
                    choices=("all",) + METHOD_ORDER)
    ap.add_argument("--participation", default="1.0",
                    help="Bernoulli client-sampling probability; a comma-"
                         "list (e.g. 1.0,0.5,0.25) is a p axis of each "
                         "method's grid")
    ap.add_argument("--sampling", choices=("bernoulli", "choice"),
                    default="choice",
                    help="single-p sampling kind (comma-lists are always "
                         "bernoulli)")
    ap.add_argument("--bit-budget", type=float, default=0.0, metavar="BITS",
                    help="budget-fair mode: freeze every method once its "
                         "per-node ledger reaches BITS (--iters is ignored)")
    ap.add_argument("--staleness", type=int, default=0, metavar="TAU",
                    help="async mode: updates arrive up to TAU rounds late "
                         "(0 = synchronous)")
    ap.add_argument("--delay-kind", choices=("fixed", "uniform", "geometric"),
                    default="fixed")
    ap.add_argument("--arrival-profile",
                    choices=("fixed", "poisson", "diurnal"), default="fixed",
                    help="the async rounds' arrival process: 'fixed' keeps "
                         "the --delay-kind draw; 'poisson' / 'diurnal' thin "
                         "completions by a flat / 4-phase rate table, "
                         "capped at --staleness")
    ap.add_argument("--buffer-k", type=int, default=0,
                    help="FedBuff aggregation goal (0 = n/4, at least 1)")
    ap.add_argument("--auto-alpha", action="store_true",
                    help="step size alpha0 = 1 damped by p·K/n "
                         "(driver.damped_alpha)")
    args = ap.parse_args(argv)

    ps = tuple(float(p) for p in args.participation.split(","))
    if any(p <= 0 for p in ps):
        raise SystemExit(f"--participation values must be > 0, got {ps}")
    tau = args.staleness
    K = args.buffer_k or max(1, args.workers // 4)
    if args.auto_alpha:
        # a synchronous round flushes the whole sampled cohort at once
        alphas = []
        for p in ps:
            K_eff = K if tau > 0 else max(1, round(p * args.workers))
            alphas.append(float(damped_alpha(1.0, p, K_eff, args.workers)))
            print(f"auto-damped alpha = {alphas[-1]:.3f} "
                  f"(p={p}, K={K_eff}, n={args.workers})")
    else:
        alphas = [1.0 if (p >= 1.0 and tau == 0)
                  else (0.5 if tau == 0 else 0.2) for p in ps]
    traffic = None
    if args.arrival_profile != "fixed":
        if tau <= 0:
            raise SystemExit("--arrival-profile rides the async engine; "
                             "set --staleness TAU > 0 (TAU caps the delays)")
        traffic = TrafficModel(arrival=(
            ArrivalSchedule("poisson", rates=(0.6,))
            if args.arrival_profile == "poisson"
            else ArrivalSchedule("diurnal", rates=(0.9, 0.5, 0.2, 0.5))))
    prob = make_problem(d=args.d, n_workers=args.workers, r=64, mu=1e-3,
                        device=args.device)
    budgeted = args.bit_budget > 0
    plan = ExperimentPlan(
        problem=prob,
        runs=tuple(build_runs(args.method, args.iters, budgeted, prob, ps,
                              alphas, args.sampling, tau)),
        iters=args.iters,
        staleness=(StalenessSchedule(args.delay_kind, tau=tau)
                   if tau > 0 else None),
        buffer_k=K,
        bit_budget=args.bit_budget if budgeted else None,
        traffic=traffic)
    res = run_plan(plan)
    print_rows(res, ps, budget=args.bit_budget)
    print(f"({len(res.labels) * len(ps)} trajectories, {len(res.labels)} "
          f"batched runs, {res.seconds:.2f} s)")


if __name__ == "__main__":
    main()
