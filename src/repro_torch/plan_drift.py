"""Where two runs of one plan part: the first compressed value that
differs, and whether a rounding boundary explains it.

Two runs of the same plan with the same keys may still round their float32
arithmetic differently: the card against the CPU, or the CPU against itself
with the features A nudged by one ulp each.  Until a compressor decides
differently, the two trajectories stay within a few ulps of each other.
Random dithering decides by ``u < p`` with p the fractional part of
``|x| / ‖x‖∞ · s`` (``kernels/compressor/ref._dither_rows``): where u falls
between the two runs' p, one rounds up and the other down, and the two
messages differ by a whole level, ‖x‖∞ / s.  Top-k decides by comparing
magnitudes, and a near-tie can keep another index.

This records every ``compress_split`` call of both runs and reports, for
each run of the plan and each grid point:

* the final F of both sides and their relative gap, and the first round
  whose relative gap of F passes 1e-6;
* the first compressed message that differs, among the rounds the point
  lived (a point frozen by its bit budget keeps computing, discarded):
  the round, the message, the row and element; for dither both levels,
  both y and p and the shared u; for top-k the magnitudes and thresholds
  at the swapped index; and whether a rounding decision explains it
  (``explained``: u between the two p, or y across an integer; for top-k
  the element within the row's largest input gap of the threshold), which
  tells a flip by rounding from a fault;
* the largest relative gap of F before that round.

    python -m repro_torch.plan_drift --a cuda --b cpu
    python -m repro_torch.plan_drift --a cpu --b cpu-ulp --ulp-seed 0

(``--d 24 --workers 4 --r 24`` by default, the budget-fair plan; ``--plan``
picks another of ``experiments``.)  The last line printed is one JSON
object with every point's report.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, List

import numpy as np
import torch

from repro_torch import experiments, random
from repro_torch.core import api, compressors, flecs
from repro_torch.core.compressors import FAMILY_DITHER, FAMILY_TOPK
from repro_torch.data.logreg import FederatedLogReg, make_problem
from repro_torch.optim import baselines

PLANS = {"budget_fair": experiments.budget_fair_plan,
         "baselines": experiments.baselines_plan,
         "fig1": experiments.fig1_plan,
         "participation": experiments.participation_plan}
#: The relative gap of F that counts as the two runs having parted.
PARTED = 1e-6


def nudged(prob: FederatedLogReg, seed: int) -> FederatedLogReg:
    """The problem with every feature moved by one ulp, up or down at
    random (from ``seed``)."""
    g = torch.Generator().manual_seed(seed)
    up = torch.randint(0, 2, prob.A.shape, generator=g).to(prob.A.device)
    A = torch.nextafter(prob.A, torch.where(up > 0, torch.inf, -torch.inf))
    return FederatedLogReg(A, prob.b, prob.mu)


@contextlib.contextmanager
def recording(calls: List[dict]):
    """Every ``compress_split`` of FLECS and the baselines appends {label,
    spec, key, x, out} (CPU copies) to ``calls`` while this is open."""
    label = [None]
    resolve, mods = api._resolve, (flecs, baselines)
    originals = [m.compress_split for m in mods]

    def resolve_and_name(plan, run):
        label[0] = run.label or getattr(run.method, "name", run.method)
        return resolve(plan, run)

    def record(spec, key, x):
        out = compressors.compress_split(spec, key, x)
        calls.append(dict(label=label[0], spec=spec, key=key.cpu(),
                          x=x.detach().cpu(), out=out.detach().cpu()))
        return out

    api._resolve = resolve_and_name
    for m in mods:
        m.compress_split = record
    try:
        yield
    finally:
        api._resolve = resolve
        for m, f in zip(mods, originals):
            m.compress_split = f


def run_recorded(plan) -> tuple:
    calls: List[dict] = []
    with recording(calls):
        res = api.run_plan(plan)
    return res, calls


def _dither_parts(x: torch.Tensor, u: torch.Tensor, s: float):
    """(level, y, p) of each element of rows x [n, L] with uniforms u: the
    plain dither's own expressions (``ref._dither_rows``)."""
    ax = x.abs()
    norm = ax.amax(dim=1, keepdim=True)
    norm = torch.where(norm == 0, 1.0, norm)
    y = ax / norm * torch.tensor(s, dtype=torch.float32)
    lo = torch.floor(y)
    p = y - lo
    return lo + (u < p).to(torch.float32), y, p


def first_difference(ca: dict, cb: dict, g: int) -> dict:
    """Grid point g's first differing element between two records of one
    call, or None where the two messages are equal."""
    spec = ca["spec"]
    fam = spec.family[g] if compressors.is_grid(spec) else spec.family
    xa, xb = ca["x"][g], cb["x"][g]
    n = xa.shape[0]
    xa, xb = xa.reshape(n, -1), xb.reshape(n, -1)
    oa, ob = ca["out"][g].reshape(n, -1), cb["out"][g].reshape(n, -1)
    scale = xa.abs().amax(dim=1).clamp_min(1e-30)
    abs_gap = (xa - xb).abs().amax(dim=1)
    rep = dict(family=int(fam),
               input_rel_gap=float((abs_gap / scale).max()))
    if fam == FAMILY_DITHER:
        s = float(spec.s_host[g]) if compressors.is_grid(spec) else spec.s
        keys = ca["key"][g] if ca["key"].dim() == 2 else ca["key"]
        u = random.uniform(random.split(keys, n), (xa.shape[1],))
        la, ya, pa = _dither_parts(xa, u, s)
        lb, yb, pb = _dither_parts(xb, u, s)
        diff = (la != lb).nonzero()
        if not diff.shape[0]:
            return None
        i, j = (int(v) for v in diff[0])
        y_lo, y_hi = sorted((float(ya[i, j]), float(yb[i, j])))
        p_lo, p_hi = sorted((float(pa[i, j]), float(pb[i, j])))
        uij = float(u[i, j])
        same_floor = np.floor(y_lo) == np.floor(y_hi)
        # the level is floor(y) + (u < p): it moves only where u lies
        # between the two p, or where y crosses an integer
        rep.update(row=i, element=j, levels_differing=int(diff.shape[0]),
                   level_a=float(la[i, j]), level_b=float(lb[i, j]),
                   y_a=float(ya[i, j]), y_b=float(yb[i, j]),
                   p_a=float(pa[i, j]), p_b=float(pb[i, j]), u=uij,
                   explained=bool(p_lo <= uij <= p_hi if same_floor
                                  else np.floor(y_hi) > y_lo))
    elif fam == FAMILY_TOPK:
        ka, kb = oa != 0, ob != 0
        diff = (ka != kb).nonzero()
        if not diff.shape[0]:
            return None
        i, j = (int(v) for v in diff[0])
        mag, thr = float(xa[i, j].abs()), float(oa[i][ka[i]].abs().min())
        # kept on one side only: the element and the kept threshold lie
        # within the two sides' largest difference in that row
        rep.update(row=i, element=j, kept_a=bool(ka[i, j]),
                   kept_b=bool(kb[i, j]), magnitude_a=mag,
                   magnitude_b=float(xb[i, j].abs()), threshold_a=thr,
                   threshold_b=float(ob[i][kb[i]].abs().min()),
                   selections_differing=int(diff.shape[0]),
                   explained=bool(abs(mag - thr) <= 2 * float(abs_gap[i])))
    else:                               # identity decides nothing
        return None
    return rep


def compare(plan_a, plan_b) -> Dict[str, list]:
    """Run both plans with every compressor call recorded; one report per
    run label and grid point (see the module's docstring)."""
    res_a, calls_a = run_recorded(plan_a)
    res_b, calls_b = run_recorded(plan_b)
    if len(calls_a) != len(calls_b):
        raise RuntimeError(f"the two runs made {len(calls_a)} and "
                           f"{len(calls_b)} compressor calls")
    out = {}
    for lab in res_a.labels:
        Fa = res_a.traces[lab]["F"].cpu().double()
        Fb = res_b.traces[lab]["F"].cpu().double()
        rel = ((Fa - Fb).abs() / Fa.abs()).numpy()
        mine = [(ca, cb) for ca, cb in zip(calls_a, calls_b)
                if ca["label"] == lab]
        T = Fa.shape[1]
        per_round = len(mine) // T
        lived = res_a.states[lab].k.cpu().reshape(-1).tolist()
        reports = []
        for g in range(Fa.shape[0]):
            parted = np.nonzero(rel[g] > PARTED)[0]
            rep = dict(point=g, rounds_lived=int(lived[g]),
                       F_a=float(Fa[g, -1]), F_b=float(Fb[g, -1]),
                       final_rel_gap=float(rel[g, -1]),
                       first_parted_round=(int(parted[0]) if parted.size
                                           else None))
            for c, (ca, cb) in enumerate(mine):
                t = c // per_round
                if t >= lived[g]:
                    break
                diff = first_difference(ca, cb, g)
                if diff is not None:
                    diff.update(round=t, message=c % per_round,
                                rel_gap_before=float(rel[g, :t].max())
                                if t else 0.0)
                    rep["first_difference"] = diff
                    break
            reports.append(rep)
        out[lab] = reports
    return out


def _side(name: str, args):
    if name == "cpu-ulp":
        prob = make_problem(d=args.d, n_workers=args.workers, r=args.r,
                            mu=1e-3, seed=args.seed, device="cpu")
        return nudged(prob, args.ulp_seed)
    return make_problem(d=args.d, n_workers=args.workers, r=args.r, mu=1e-3,
                        seed=args.seed, device=name)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", default="cuda", help="cuda, cpu or cpu-ulp")
    ap.add_argument("--b", default="cpu", help="cuda, cpu or cpu-ulp")
    ap.add_argument("--plan", default="budget_fair", choices=sorted(PLANS))
    ap.add_argument("--d", type=int, default=24)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--r", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ulp-seed", type=int, default=0)
    args = ap.parse_args(argv)
    make = PLANS[args.plan]
    out = compare(make(_side(args.a, args)), make(_side(args.b, args)))
    for lab, reports in out.items():
        for r in reports:
            print(f"{lab}[{r['point']}]: final F {r['F_a']!r} / "
                  f"{r['F_b']!r}, relative gap {r['final_rel_gap']:.3g}; "
                  f"parted at round {r['first_parted_round']}; first "
                  f"differing message {r.get('first_difference')}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
