"""Method comparison on one federated problem: FLECS vs FLECS-CGD vs DIANA
vs FedNL vs GD — objective against communicated bits (counterpart of
``examples/federated_logreg.py``, its synchronous flags).

    PYTHONPATH=src python -m repro_torch.federated_logreg --device cpu
    PYTHONPATH=src python -m repro_torch.federated_logreg --method fednl
    PYTHONPATH=src python -m repro_torch.federated_logreg \\
        --participation 1.0,0.5,0.25      # a Bernoulli p axis, one grid a run
    PYTHONPATH=src python -m repro_torch.federated_logreg \\
        --bit-budget 200000               # budget-fair: equal bits a node

Every method is resolved through the registry (``core.api.get_method``) and
the invocation is one ``ExperimentPlan`` (``core.api.run_plan``), each
method's participation levels one [G] grid.  It runs on the card unless
``--device cpu`` is given.  A comma-list of --participation values is a
Bernoulli p axis; a single value < 1 is the config's static rate, sampled
by --sampling: "choice" (the default, the reference example's) takes
exactly max(1, round(p·n)) workers a round, "bernoulli" each worker with
probability p.  The async flags (--staleness, --delay-kind,
--arrival-profile, --buffer-k, --auto-alpha) are not ported and raise
(ROADMAP.md, queue 1: 'async engine').
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.api import ExperimentPlan, MethodRun, run_plan
from repro_torch.core.compressors import as_grid, make_spec
from repro_torch.core.flecs import FlecsConfig, FlecsHParams
from repro_torch.data.logreg import make_problem
from repro_torch.optim.baselines import (DianaConfig, DianaHParams,
                                         FedNLConfig, FedNLHParams, GDConfig,
                                         GDHParams)

METHOD_ORDER = ("flecs", "flecs_cgd", "diana", "fednl", "gd")


def build_runs(method: str, iters: int, budgeted: bool, prob, ps, alphas,
               sampling: str = "choice"):
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
            cfg = GDConfig(alpha=2.0, **static)
            hp = GDHParams(full(2.0), p_axis)
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
            print(f"{name:18s} F={F:.6f} ||grad||={gn:.2e} "
                  f"Mbits/node={mbits:7.3f} active/round={active:5.1f}")


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
    ap.add_argument("--staleness", type=int, default=0, metavar="TAU")
    ap.add_argument("--delay-kind", default="fixed")
    ap.add_argument("--arrival-profile", default="fixed")
    ap.add_argument("--buffer-k", type=int, default=0)
    ap.add_argument("--auto-alpha", action="store_true")
    args = ap.parse_args(argv)

    if (args.staleness or args.delay_kind != "fixed"
            or args.arrival_profile != "fixed" or args.buffer_k
            or args.auto_alpha):
        raise NotImplementedError(
            "--staleness, --delay-kind, --arrival-profile, --buffer-k and "
            "--auto-alpha drive the async engine, which is not ported yet "
            "(ROADMAP.md, queue 1: 'async engine')")
    ps = tuple(float(p) for p in args.participation.split(","))
    if any(p <= 0 for p in ps):
        raise SystemExit(f"--participation values must be > 0, got {ps}")
    alphas = [1.0 if p >= 1.0 else 0.5 for p in ps]
    prob = make_problem(d=args.d, n_workers=args.workers, r=64, mu=1e-3,
                        device=args.device)
    budgeted = args.bit_budget > 0
    plan = ExperimentPlan(
        problem=prob,
        runs=tuple(build_runs(args.method, args.iters, budgeted, prob, ps,
                              alphas, args.sampling)),
        iters=args.iters,
        bit_budget=args.bit_budget if budgeted else None)
    res = run_plan(plan)
    print_rows(res, ps, budget=args.bit_budget)
    print(f"({len(res.labels) * len(ps)} trajectories, {len(res.labels)} "
          f"batched runs, {res.seconds:.2f} s)")


if __name__ == "__main__":
    main()
