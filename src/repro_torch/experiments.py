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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import ExperimentPlan, MethodRun, get_method
from repro_torch.core.compressors import spec_omega, stack_specs
from repro_torch.core.flecs import (FlecsConfig, FlecsHParams, dither_grid,
                                    hparams_round_bits)
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
