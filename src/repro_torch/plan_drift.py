"""Where two runs of one plan part: the first compressed message that
differs, whether a rounding decision explains it, and whether every
message is the plain compressor's own.

Two runs of the same plan with the same keys may still round their float32
arithmetic differently: the card against the CPU, or the CPU against itself
with the features A nudged by one ulp each.  Until a compressor decides
differently, the two trajectories stay within a few ulps of each other.
Random dithering decides by ``u < p`` with p the fractional part of
``|x| / ‖x‖∞ · s`` (``kernels/compressor/ref._dither_rows``), natural by
``u < (|x| - lo) / lo`` with lo the power of two at or below |x|, min-max
by ``u < k|x| / ‖x‖₁``: where u falls between the two runs' p, one rounds
up and the other down.  Top-k (and the count sketch's heavy-hitter step)
decides by comparing magnitudes, and a near-tie can keep another index.

This records every ``compress_split`` call of both runs and replays each
message recorded on the card through the plain compressor on the CPU, from
the recorded key and input (:func:`replay`): a message that is not its
replay is a fault, whatever F does.  For each run of the plan and each grid
point it reports:

* the final F of both sides, their relative gap, the largest relative gap
  over all rounds, and the first round whose gap passes 1e-6;
* each side's messages that differ from their replay (``unfaithful_a``,
  ``unfaithful_b``; the first one's round, element count and largest
  distance in ulps);
* the first compressed message that differs between the two sides, among
  the rounds the point lived (a point frozen by its bit budget keeps
  computing, discarded): the round, the message, the row and element; for
  dither both levels, y and p and the shared u; for natural both powers of
  two, p and u; for min-max both p and u; for top-k the magnitudes and
  thresholds at the swapped index; for the count sketch and identity, which
  decide nothing by a uniform, the first differing element and the input
  and output gaps; and whether that is explained (``explained``: both
  messages are their replays, and for a decision u lies between the two
  p, or y or |x| crosses a level or a power of two, or the swapped element
  lies within the row's input gap of the threshold);
* the largest relative gap of F before that round.

:func:`verdict` holds a pair to its report: no message that is not its
replay, a first difference that is explained and comes after rounds that
agreed within 1e-6, and F within ``STRICT`` of the other side at every
round, or else within ``ENVELOPE_FACTOR`` times the largest gap that one
ulp of noise in A opens between two CPU runs over several ulp and problem
seeds (:func:`envelope`).

    python -m repro_torch.plan_drift --a cuda --b cpu
    python -m repro_torch.plan_drift --a cpu --b cpu-ulp --ulp-seed 0

(``--d 24 --workers 4 --r 24`` by default, the budget-fair plan; ``--plan``
picks another of ``experiments``, ``traffic_<profile>`` (the five methods
on the async engine under a traffic profile, 100 rounds), ``stochastic``:
FLECS-CGD with minibatch oracles and exact-k sampling at quickstart size,
50 rounds, or ``async``: ``experiments.async_grid``'s (tau × buffer_k)
FLECS-CGD grid, ``--iters`` rounds.)  The last line printed is one JSON
object with every point's report.

Async runs also record each round's routing (``traffic.route_round``):
the availability states, the send mask, the senders' delays, the slot
drained and the admitted arrivals.  Their messages are matched by round,
and the first difference of a round's routing is named before its
messages': a routing difference is explained only where it is a geometric
delay whose log(u) / log(q) lies within ``DELAY_ULPS`` ulps of an integer
(every other routing decision compares exact float32 values, the same on
both sides until an earlier difference moves them).
"""
from __future__ import annotations

import argparse
import contextlib
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import experiments, quickstart, random
from repro_torch.core import api, compressors, flecs, traffic
from repro_torch.core.compressors import (FAMILY_DITHER, FAMILY_MINMAX,
                                          FAMILY_NATURAL, FAMILY_TOPK)
from repro_torch.core.driver import ASYNC_SALT, run_experiment
from repro_torch.data.logreg import FederatedLogReg, make_problem
from repro_torch.optim import baselines

PLANS = {"budget_fair": experiments.budget_fair_plan,
         "baselines": experiments.baselines_plan,
         "fig1": experiments.fig1_plan,
         "participation": experiments.participation_plan,
         "sketch_families": experiments.sketch_families_plan,
         **{f"traffic_{profile}": (
             lambda prob, iters=100, profile=profile:
             experiments.traffic_plan(prob, profile, iters, 2))
            for profile in experiments.TRAFFIC_PROFILES}}
#: The relative gap of F that counts as the two runs having parted.
PARTED = 1e-6
#: The relative gap of F that two sides may always show.
STRICT = 1e-4
#: How far past the CPU's own ulp envelope (the largest gap one ulp of
#: noise in A opens between two CPU runs) a pair may part.
ENVELOPE_FACTOR = 3.0
#: (problem seed, ulp seed) of the CPU runs the envelope is taken over.
ENVELOPE_SEEDS = ((0, 0), (0, 1), (0, 2), (1, 0), (2, 0))


def nudged(prob: FederatedLogReg, seed: int) -> FederatedLogReg:
    """The problem with every feature moved by one ulp, up or down at
    random (from ``seed``)."""
    g = torch.Generator().manual_seed(seed)
    up = torch.randint(0, 2, prob.A.shape, generator=g).to(prob.A.device)
    A = torch.nextafter(prob.A, torch.where(up > 0, torch.inf, -torch.inf))
    return FederatedLogReg(A, prob.b, prob.mu)


class Recording(list):
    """The recorded compressor calls of a run, in order; ``routes`` the
    async rounds' routing decisions (empty for a synchronous run)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.routes: List[dict] = []


@contextlib.contextmanager
def recording(calls: List[dict]):
    """Every ``compress_split`` of FLECS and the baselines appends {label,
    spec, key, x, out (CPU copies), device, round} to ``calls`` while this
    is open; every async round's routing (``traffic.route_round``) appends
    {label, round, kind, q, keys, avail, send, delays, drained, arrived,
    device} to ``calls.routes`` (where ``calls`` is a
    :class:`Recording`), and the compressor calls made after it carry its
    round."""
    label, rnd = [None], [None]
    routes = getattr(calls, "routes", [])
    resolve, mods = api._resolve, (flecs, baselines)
    originals = [(m.compress_split, m.route_round) for m in mods]

    def resolve_and_name(plan, run):
        label[0] = run.label or getattr(run.method, "name", run.method)
        return resolve(plan, run)

    def record(spec, key, x):
        out = compressors.compress_split(spec, key, x)
        calls.append(dict(label=label[0], spec=spec, key=key.cpu(),
                          x=x.detach().cpu(), out=out.detach().cpu(),
                          device=x.device.type, round=rnd[0]))
        return out

    def route(delay_kind, q, model, ahp, state, keys, mask):
        r = traffic.route_round(delay_kind, q, model, ahp, state, keys, mask)
        rnd[0] = state.t
        routes.append(dict(
            label=label[0], round=state.t, kind=delay_kind, q=q,
            keys=keys.cpu(), send=r.send.cpu(), delays=r.delays.cpu(),
            avail=None if r.tstate is None else r.tstate.avail.cpu(),
            drained=r.drained.cpu(), arrived=r.arrived.cpu(),
            device=keys.device.type))
        return r

    api._resolve = resolve_and_name
    for m in mods:
        m.compress_split, m.route_round = record, route
    try:
        yield
    finally:
        api._resolve = resolve
        for m, (f, g) in zip(mods, originals):
            m.compress_split, m.route_round = f, g


def run_recorded(plan) -> tuple:
    """(the plan's result, its :class:`Recording`)."""
    calls = Recording()
    with recording(calls):
        res = api.run_plan(plan)
    return res, calls


def record_run(run: Callable) -> tuple:
    """(final state, traces, :class:`Recording`) of ``run()``, a
    zero-argument run of one (unbatched) step -> (final state, traces)."""
    calls = Recording()
    with recording(calls):
        state, tr = run()
    return state, tr, calls


def replay(call: dict) -> torch.Tensor:
    """The plain compressor's message, on the CPU, for a recorded call's
    spec, key and input."""
    return compressors.compress_split(
        compressors.spec_to(call["spec"], "cpu"), call["key"], call["x"])


def _points(call: dict) -> int:
    return call["x"].shape[0] if compressors.is_grid(call["spec"]) else 1


def _replay_gaps(calls: List[dict]) -> List[np.ndarray]:
    """Per recorded call, [G, 2]: the elements of each point's message
    whose bits differ from its replay (NaN matching NaN), and the largest
    distance among them in ulps.  A message recorded on the CPU is the
    plain compressor's by construction and is not replayed."""
    out = []
    for c in calls:
        G = _points(c)
        if c["device"] == "cpu":
            out.append(np.zeros((G, 2), np.int64))
            continue
        got, want = c["out"].reshape(G, -1), replay(c).reshape(G, -1)
        ulps = (got.view(torch.int32).long()
                - want.view(torch.int32).long()).abs()
        ulps = torch.where(torch.isnan(got) & torch.isnan(want), 0, ulps)
        out.append(np.stack([(ulps > 0).sum(dim=1).numpy(),
                             ulps.amax(dim=1).numpy()], axis=1))
    return out


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


def _sent_levels(x: torch.Tensor, out: torch.Tensor, s: float):
    """The dither levels a message out [n, L] of rows x carries:
    |out| / ‖x‖∞ · s, rounded to the nearest level."""
    norm = x.abs().amax(dim=1, keepdim=True)
    norm = torch.where(norm == 0, 1.0, norm)
    return torch.round(out.abs() / norm * s)


def _natural_parts(x: torch.Tensor):
    """(lo, p) of each element of x: the power of two at or below |x| and
    the probability of rounding up to 2·lo (the plain
    ``compressors._natural_rows``'s expressions)."""
    ax = x.abs()
    lo = torch.where(ax > 0, torch.pow(2.0, torch.floor(torch.log2(
        torch.clamp(ax, min=1e-38)))), 0.0)
    return lo, torch.where(lo > 0, (ax - lo) / lo, 0.0)


def _minmax_p(x: torch.Tensor, frac: float) -> torch.Tensor:
    """min-max's keep probabilities of rows x [n, L] (the plain
    ``compressors._minmax_rows``'s p)."""
    L = np.float32(x.shape[1])
    k = float(np.clip(np.ceil(np.float32(frac) * L), 1.0, L))
    ax = x.abs()
    return torch.clamp(k * ax / torch.clamp(compressors._l1(ax), min=1e-30),
                       0.0, 1.0)


def _between(u: float, a: float, b: float) -> bool:
    return min(a, b) <= u <= max(a, b)


def first_difference(ca: dict, cb: dict, g: int,
                     faithful: bool = True) -> dict:
    """Grid point g's first differing element between two records of one
    call, or None where the two messages are equal.  ``faithful``: both
    messages are their replays (an unexplained difference otherwise)."""
    spec = ca["spec"]
    grid = compressors.is_grid(spec)
    fam = int(spec.family[g]) if grid else spec.family
    pick = (lambda t: t[g]) if grid else (lambda t: t)
    xa, xb, oa, ob = (pick(c[k]) for k in ("x", "out") for c in (ca, cb))
    n = xa.shape[0]
    xa, xb, oa, ob = (t.reshape(n, -1) for t in (xa, xb, oa, ob))
    u = random.uniform(random.split(pick(ca["key"]), n), (xa.shape[1],))
    scale = xa.abs().amax(dim=1).clamp_min(1e-30)
    abs_gap = (xa - xb).abs().amax(dim=1)
    rep = dict(family=fam, faithful=bool(faithful), decision=True,
               input_rel_gap=float((abs_gap / scale).max()))

    def first(mask):
        idx = mask.nonzero()
        if not idx.shape[0]:
            return None
        i, j = (int(v) for v in idx[0])
        rep.update(row=i, element=j, elements_differing=int(idx.shape[0]),
                   x_a=float(xa[i, j]), x_b=float(xb[i, j]),
                   out_a=float(oa[i, j]), out_b=float(ob[i, j]))
        return i, j

    if fam == FAMILY_DITHER:
        s = float(spec.s_host[g]) if grid else spec.s
        la, ya, pa = _dither_parts(xa, u, s)
        lb, yb, pb = _dither_parts(xb, u, s)
        # the levels the recorded messages carry (|out| = level·‖x‖∞/s);
        # where a message is its replay they are la, lb
        ra, rb = (_sent_levels(x, o, s) for x, o in ((xa, oa), (xb, ob)))
        hit = first((ra != rb) | (la != lb))
        if hit is None:
            return None
        y = sorted((float(ya[hit]), float(yb[hit])))
        uij = float(u[hit])
        # the level is floor(y) + (u < p): it moves only where u lies
        # between the two p, or where y crosses an integer
        rep.update(levels_differing=rep["elements_differing"],
                   level_a=float(ra[hit]), level_b=float(rb[hit]),
                   y_a=float(ya[hit]), y_b=float(yb[hit]),
                   p_a=float(pa[hit]), p_b=float(pb[hit]), u=uij,
                   explained=faithful and (
                       _between(uij, float(pa[hit]), float(pb[hit]))
                       if np.floor(y[0]) == np.floor(y[1])
                       else np.floor(y[1]) > y[0]))
    elif fam == FAMILY_NATURAL:
        hit = first(oa != ob)
        if hit is None:
            return None
        (lo_a, p_a), (lo_b, p_b) = (
            (float(v[hit]) for v in _natural_parts(x)) for x in (xa, xb))
        uij, mags = float(u[hit]), sorted((abs(rep["x_a"]),
                                           abs(rep["x_b"])))
        # sent as lo or 2·lo: the messages part only where u lies between
        # the two p, or where |x| crosses a power of two
        rep.update(lo_a=lo_a, lo_b=lo_b, p_a=p_a, p_b=p_b, u=uij,
                   explained=faithful and (
                       _between(uij, p_a, p_b) if lo_a == lo_b
                       else mags[0] < max(lo_a, lo_b) <= mags[1]))
    elif fam == FAMILY_MINMAX:
        ka, kb = oa != 0, ob != 0
        hit = first(ka != kb)
        if hit is None:
            return None
        frac = float(spec.frac_host[g]) if grid else spec.frac
        pa, pb = (float(_minmax_p(x, frac)[hit]) for x in (xa, xb))
        uij = float(u[hit])
        # kept where u < p: the decisions part only where u lies between
        # the two sides' p
        rep.update(kept_a=bool(ka[hit]), kept_b=bool(kb[hit]), p_a=pa,
                   p_b=pb, u=uij,
                   selections_differing=rep["elements_differing"],
                   explained=faithful and _between(uij, pa, pb))
    elif fam == FAMILY_TOPK:
        ka, kb = oa != 0, ob != 0
        hit = first(ka != kb)
        if hit is None:
            return None
        i = hit[0]
        mag, thr = float(xa[hit].abs()), float(oa[i][ka[i]].abs().min())
        # kept on one side only: the element and the kept threshold lie
        # within the two sides' largest difference in that row
        rep.update(kept_a=bool(ka[hit]), kept_b=bool(kb[hit]),
                   selections_differing=rep["elements_differing"],
                   magnitude_a=mag, magnitude_b=float(xb[hit].abs()),
                   threshold_a=thr,
                   threshold_b=float(ob[i][kb[i]].abs().min()),
                   explained=faithful and abs(mag - thr)
                   <= 2 * float(abs_gap[i]))
    else:
        # identity and the count sketch (a float64 table, a median and a
        # top-k of the median): no uniform decides; the heavy hitters kept
        # are a decision, the values move with their input, and either is
        # explained where both messages are their replays
        chosen = (oa != 0) != (ob != 0)
        hit = first(chosen if bool(chosen.any())
                    else oa.view(torch.int32) != ob.view(torch.int32))
        if hit is None:
            return None
        out_scale = oa.abs().amax(dim=1).clamp_min(1e-30)
        rep.update(output_rel_gap=float(((oa - ob).abs().amax(dim=1)
                                         / out_scale).max()),
                   selections_differing=int(chosen.sum()),
                   decision=bool(chosen.any()), explained=bool(faithful))
    return rep


#: A route's decisions in the order a round takes them: the availability
#: chain, the send mask (sampling, busy exclusion, the in-flight cap), the
#: senders' delays, the slot drained, the admission.
ROUTE_DECISIONS = (("avail", "availability"), ("send", "send"),
                   ("delays", "delay"), ("drained", "arrival"),
                   ("arrived", "admission"))
#: How near an integer (in ulps of the quotient) a geometric delay's
#: log(u) / log(q) may lie where two devices floor it differently.
DELAY_ULPS = 4


def _delay_quotient(ra: dict, g: int, i: int) -> float:
    """log(u) / log(q) of worker i's geometric delay draw at point g, in
    float64, from the route's recorded key."""
    key = random.fold_in(ra["keys"][g], ASYNC_SALT)
    u = random.uniform(key, (ra["send"].shape[-1],),
                       minval=float(np.finfo(np.float32).tiny))[i]
    return float(np.log(np.float64(u)) / np.log(np.float64(
        np.float32(ra["q"]))))


def route_difference(ra: dict, rb: dict, g: int) -> dict:
    """Point g's first differing routing decision between two records of
    one async round (``ROUTE_DECISIONS``, a sender's delay only), or None.
    Only a geometric delay is explained: where log(u) / log(q) lies within
    ``DELAY_ULPS`` ulps of an integer, two logs an ulp apart can floor
    either side of it."""
    for field, name in ROUTE_DECISIONS:
        if ra[field] is None:
            continue
        a, b = ra[field][g], rb[field][g]
        differ = a != b
        if field == "delays":
            differ &= (ra["send"][g] > 0) | (rb["send"][g] > 0)
        if not bool(differ.any()):
            continue
        i = int(differ.nonzero()[0, 0])
        rep = dict(family=None, decision=True, kind=name, worker=i,
                   value_a=float(a[i]), value_b=float(b[i]),
                   elements_differing=int(differ.sum()), faithful=True,
                   explained=False)
        if field == "delays" and ra["kind"] == "geometric":
            quo = _delay_quotient(ra, g, i)
            j = round(quo)
            ulps = abs(quo - j) / float(np.spacing(np.float32(abs(quo))))
            lo, hi = sorted((rep["value_a"], rep["value_b"]))
            rep.update(quotient=quo, ulps_from_integer=ulps,
                       explained=ulps <= DELAY_ULPS and hi - lo == 1
                       and hi == j)
        return rep
    return None


def _decides(spec, g: int) -> bool:
    """Whether point g's compressor can make a decision that differs: all
    but identity."""
    fam = spec.family[g] if compressors.is_grid(spec) else spec.family
    return int(fam) != compressors.FAMILY_IDENTITY


def _unfaithful(gaps: List[np.ndarray], g: int, calls: list,
                stamps: list) -> tuple:
    """(messages of point g among ``calls`` (indices) that are not their
    replays, the first one's {round, message, elements, max_ulps})."""
    bad = [c for c in calls if gaps[c][g, 0]]
    if not bad:
        return 0, None
    c = bad[0]
    return len(bad), dict(round=stamps[c][0], message=stamps[c][1],
                          elements=int(gaps[c][g, 0]),
                          max_ulps=int(gaps[c][g, 1]))


def _stamps(pairs: list, T: int) -> list:
    """(round, message) of each call pair: the recorded round of an async
    run's call (its messages numbered within the round), else the calls
    split evenly over the T rounds."""
    if pairs and pairs[0][0].get("round") is not None:
        out, seen = [], {}
        for ca, _ in pairs:
            t = ca["round"]
            out.append((t, seen.get(t, 0)))
            seen[t] = seen.get(t, 0) + 1
        return out
    per_round = max(1, len(pairs) // T)
    return [(c // per_round, c % per_round) for c in range(len(pairs))]


def _reports(Fa: torch.Tensor, Fb: torch.Tensor, pairs: list,
             lived: list, routes: list = ()) -> list:
    """One report a grid point: F [G, T] of both sides, their recorded
    call pairs in order, the rounds each point lived, and an async run's
    route pairs (one a round)."""
    rel = ((Fa - Fb).abs() / Fa.abs()).numpy()
    stamps = _stamps(pairs, Fa.shape[1])
    gaps = [_replay_gaps([p[side] for p in pairs]) for side in (0, 1)]
    by_round = {ra["round"]: (ra, rb) for ra, rb in routes}
    reports = []
    for g in range(Fa.shape[0]):
        parted = np.nonzero(rel[g] > PARTED)[0]
        calls = [c for c in range(len(pairs)) if stamps[c][0] < lived[g]]
        rep = dict(point=g, rounds_lived=int(lived[g]),
                   F_a=float(Fa[g, -1]), F_b=float(Fb[g, -1]),
                   final_rel_gap=float(rel[g, -1]),
                   max_rel_gap=float(rel[g].max()),
                   first_parted_round=(int(parted[0]) if parted.size
                                       else None))
        for side, gp in zip("ab", gaps):
            rep[f"unfaithful_{side}"], rep[f"first_unfaithful_{side}"] = \
                _unfaithful(gp, g, calls, stamps)
        # events in round order: a round's routing, then its messages
        events = sorted([(t, 0, None) for t in by_round if t < lived[g]]
                        + [(stamps[c][0], 1, c) for c in calls],
                        key=lambda e: (e[0], e[1]))
        # the first differing decision; failing one, the first message
        # whose values differ (identity, the count sketch)
        first_values = None
        for t, _, c in events:
            if c is None:
                diff = route_difference(*by_round[t], g)
            else:
                ca, cb = pairs[c]
                if first_values is not None and not _decides(ca["spec"], g):
                    continue
                diff = first_difference(ca, cb, g, faithful=not (
                    gaps[0][c][g, 0] or gaps[1][c][g, 0]))
            if diff is None:
                continue
            diff.update(round=t, message=None if c is None else stamps[c][1],
                        rel_gap_before=float(rel[g, :t].max())
                        if t else 0.0)
            if diff["decision"]:
                rep["first_difference"] = diff
                break
            if first_values is None:
                first_values = diff
        if "first_difference" not in rep and first_values is not None:
            rep["first_difference"] = first_values
        reports.append(rep)
    return reports


def _route_pairs(rec_a: list, rec_b: list, label=None) -> list:
    ra = [r for r in getattr(rec_a, "routes", []) if r["label"] == label]
    rb = [r for r in getattr(rec_b, "routes", []) if r["label"] == label]
    if len(ra) != len(rb):
        raise RuntimeError(f"the two runs routed {len(ra)} and {len(rb)} "
                           "async rounds")
    return list(zip(ra, rb))


def _check_calls(calls_a, calls_b) -> list:
    """The call pairs of two runs: in order, or for async runs matched by
    (label, round, message) (a round where one side's grid had no sender
    makes no call there; the routes show why)."""
    if calls_a and calls_a[0].get("round") is not None:
        def keyed(calls):
            out, seen = {}, {}
            for c in calls:
                k = (c["label"], c["round"])
                out[k + (seen.get(k, 0),)] = c
                seen[k] = seen.get(k, 0) + 1
            return out
        ka, kb = keyed(calls_a), keyed(calls_b)
        return [(ka[k], kb[k]) for k in ka if k in kb]
    if len(calls_a) != len(calls_b):
        raise RuntimeError(f"the two runs made {len(calls_a)} and "
                           f"{len(calls_b)} compressor calls")
    return list(zip(calls_a, calls_b))


def compare_recorded(rec_a: tuple, rec_b: tuple) -> Dict[str, list]:
    """Two :func:`run_recorded` results of one plan: one report per run
    label and grid point (see the module's docstring)."""
    (res_a, calls_a), (res_b, calls_b) = rec_a, rec_b
    pairs = _check_calls(calls_a, calls_b)
    out = {}
    for lab in res_a.labels:
        mine = [(ca, cb) for ca, cb in pairs if ca["label"] == lab]
        out[lab] = _reports(res_a.traces[lab]["F"].cpu().double(),
                            res_b.traces[lab]["F"].cpu().double(), mine,
                            res_a.states[lab].k.cpu().reshape(-1).tolist(),
                            _route_pairs(calls_a, calls_b, lab))
    return out


def compare(plan_a, plan_b) -> Dict[str, list]:
    """Run both plans with every compressor call recorded and compare
    them (:func:`compare_recorded`)."""
    return compare_recorded(run_recorded(plan_a), run_recorded(plan_b))


def compare_recorded_runs(rec_a: tuple, rec_b: tuple) -> dict:
    """Two :func:`record_run` results of one (unbatched) step: the report
    of :func:`compare` for their one point."""
    (st_a, tr_a, calls_a), (_, tr_b, calls_b) = rec_a, rec_b
    return _reports(tr_a["F"].cpu().double().reshape(1, -1),
                    tr_b["F"].cpu().double().reshape(1, -1),
                    _check_calls(calls_a, calls_b), [int(st_a.k)],
                    _route_pairs(calls_a, calls_b))[0]


def compare_runs(run_a: Callable, run_b: Callable) -> dict:
    """Two zero-argument runs of one (unbatched) step, ``run()`` ->
    (final state, traces with F [T]), every compressor call recorded."""
    return compare_recorded_runs(record_run(run_a), record_run(run_b))


def verdict(rep: dict, envelope: float = 0.0) -> List[str]:
    """The faults in one point's report (none: an empty list): a message
    of either side that is not its replay; a first difference that is not
    explained, or that comes after F had parted by more than ``PARTED``;
    F beyond max(``STRICT``, ``ENVELOPE_FACTOR`` · envelope) of the other
    side at any round."""
    faults = []
    for side in "ab":
        if rep[f"unfaithful_{side}"]:
            faults.append(f"{rep[f'unfaithful_{side}']} message(s) of side "
                          f"{side} are not the plain compressor's on their "
                          f"inputs, first {rep[f'first_unfaithful_{side}']}")
    diff = rep.get("first_difference")
    if diff is not None and not diff["explained"]:
        faults.append(f"first differing message not explained: {diff}")
    if diff is not None and diff["rel_gap_before"] > PARTED:
        faults.append(f"F had parted by {diff['rel_gap_before']!r} before "
                      "the first differing message")
    limit = max(STRICT, ENVELOPE_FACTOR * envelope)
    if rep["max_rel_gap"] > limit:
        faults.append(f"F parted by {rep['max_rel_gap']!r} (final "
                      f"{rep['final_rel_gap']!r}), beyond {limit!r} "
                      f"(max of {STRICT} and {ENVELOPE_FACTOR} x the CPU's "
                      f"ulp envelope {envelope!r})")
    return faults


def compare_recorded_grid(rec_a: tuple, rec_b: tuple) -> list:
    """Two :func:`record_run` results of one sweep (batched final states,
    traces [G, T]): one report a grid point."""
    (st_a, tr_a, calls_a), (_, tr_b, calls_b) = rec_a, rec_b
    return _reports(tr_a["F"].cpu().double(), tr_b["F"].cpu().double(),
                    _check_calls(calls_a, calls_b),
                    st_a.k.cpu().reshape(-1).tolist(),
                    _route_pairs(calls_a, calls_b))


def async_grid_run(side: str, iters: int = 60, seed: int = 0,
                   ulp_seed: int = 0, **problem) -> Callable:
    """A zero-argument run of ``experiments.async_grid``'s batched (tau ×
    buffer_k) FLECS-CGD grid on ``side`` (cuda, cpu or cpu-ulp), recording
    F each round; ``problem``: ``make_problem``'s sizes (d = 24, n = 4,
    r = 24 by default)."""
    from repro_torch.core.driver import run_async_sweep
    size = dict(dict(d=24, n_workers=4, r=24), **problem)
    dev = "cpu" if side == "cpu-ulp" else side
    prob = make_problem(**size, mu=1e-3, seed=seed, device=dev)
    if side == "cpu-ulp":
        prob = nudged(prob, ulp_seed)
    _, sweep, ahp, st0 = experiments.async_grid_setup(prob)
    return lambda: run_async_sweep(sweep, ahp, st0, random.key(0, dev),
                                   iters, record=lambda st: prob.metrics(st.w))


def max_rel_gaps(F_a: torch.Tensor, F_b: torch.Tensor) -> List[float]:
    """The ``max_rel_gap`` of a report, a float a row of F [G, T] (or of
    one run's F [T]), from the F traces alone: an envelope's runs need no
    recorded calls."""
    F_a, F_b = (F.cpu().double().reshape(-1, F.shape[-1]) for F in (F_a, F_b))
    rel = ((F_a - F_b).abs() / F_a.abs()).numpy()
    return [float(r.max()) for r in rel]


def stochastic_setup(side: str, seed: int = 0, ulp_seed: int = 0):
    """``quickstart.setup(**quickstart.STOCHASTIC)`` (minibatch oracles of
    32 rows, exact-k p = 0.5, alpha 0.2) at quickstart size on ``side``
    (cuda, cpu, or cpu-ulp: the CPU with A nudged by one ulp from
    ``ulp_seed``, in place, so the oracles see it): (problem, step, state,
    key)."""
    dev = "cpu" if side == "cpu-ulp" else side
    prob, step, state, key = quickstart.setup(device=dev, seed=seed,
                                              **quickstart.STOCHASTIC)
    if side == "cpu-ulp":
        prob.A.copy_(nudged(prob, ulp_seed).A)
    return prob, step, state, key


def rounds(pieces: tuple, iters: int) -> Callable:
    """A zero-argument run of ``iters`` rounds of (problem, step, state,
    key), recording F each round."""
    prob, step, state, key = pieces
    return lambda: run_experiment(step, state, key, iters,
                                  record=lambda st: prob.metrics(st.w))


def stochastic_run(side: str, iters: int = 50, seed: int = 0,
                   ulp_seed: int = 0) -> Callable:
    """A zero-argument run of stochastic FLECS-CGD at quickstart size on
    ``side`` (:func:`stochastic_setup`), recording F each round."""
    return rounds(stochastic_setup(side, seed, ulp_seed), iters)


def envelope_F(kind: str, ps: int, us: Optional[int], iters: int,
               problem: Optional[dict] = None) -> torch.Tensor:
    """F of one CPU run of an ulp envelope: problem seed ``ps``, A nudged
    by ulp seed ``us`` (None: as made).  ``kind``: "async" (the async
    grid, F [G, T]; ``problem``: ``make_problem``'s sizes), "stochastic"
    (stochastic FLECS-CGD at quickstart size, F [T]) or the name of a plan
    of one run in ``experiments`` (F [G, T]; ``problem``:
    ``make_problem``'s keywords but the seed and the device).  Plain
    arguments: a worker process's job."""
    side = "cpu" if us is None else "cpu-ulp"
    if kind == "async":
        return async_grid_run(side, iters, ps, us or 0, **(problem or {}))(
        )[1]["F"]
    if kind == "stochastic":
        return stochastic_run(side, iters, ps, us or 0)()[1]["F"]
    prob = make_problem(**problem, seed=ps, device="cpu")
    if us is not None:
        prob = nudged(prob, us)
    res = api.run_plan(getattr(experiments, kind)(prob, iters))
    (label,) = res.labels
    return res.traces[label]["F"]


def envelope(kind: str, iters: int, problem: Optional[dict] = None,
             seeds=ENVELOPE_SEEDS, runs: Optional[dict] = None) -> tuple:
    """The CPU's ulp envelope of ``kind``'s runs (:func:`envelope_F`), a
    float a grid point: the largest ``max_rel_gap`` over (problem seed,
    ulp seed) ``seeds`` between problem seed ps's run and that run with A
    nudged by one ulp; and every gap.  ``runs``: the F traces of runs
    already made, by (ps, us) (us None: the run as made); the others are
    made here, one after another."""
    runs = dict(runs or {})
    gaps = []
    for ps, us in seeds:
        for key in ((ps, None), (ps, us)):
            if key not in runs:
                runs[key] = envelope_F(kind, *key, iters, problem)
        gaps.append(max_rel_gaps(runs[(ps, None)], runs[(ps, us)]))
    return [max(col) for col in zip(*gaps)], gaps


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
    ap.add_argument("--plan", default="budget_fair",
                    choices=sorted(PLANS) + ["stochastic", "async"],
                    help="a plan of experiments (traffic_<profile>: the "
                         "five methods on the async engine under a traffic "
                         "profile), 'stochastic': FLECS-CGD with minibatch "
                         "oracles at quickstart size, or 'async': the "
                         "async_grid's (tau × buffer_k) FLECS-CGD grid")
    ap.add_argument("--iters", type=int, default=60,
                    help="rounds of the 'async' grid")
    ap.add_argument("--d", type=int, default=24)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--r", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ulp-seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.plan == "stochastic":
        out = {"stochastic": [compare_runs(
            stochastic_run(args.a, seed=args.seed, ulp_seed=args.ulp_seed),
            stochastic_run(args.b, seed=args.seed, ulp_seed=args.ulp_seed))]}
    elif args.plan == "async":
        size = dict(d=args.d, n_workers=args.workers, r=args.r)
        out = {"async": compare_recorded_grid(*(record_run(async_grid_run(
            side, args.iters, args.seed, args.ulp_seed, **size))
            for side in (args.a, args.b)))}
    else:
        make = PLANS[args.plan]
        out = compare(make(_side(args.a, args)), make(_side(args.b, args)))
    for lab, reports in out.items():
        for r in reports:
            print(f"{lab}[{r['point']}]: final F {r['F_a']!r} / "
                  f"{r['F_b']!r}, relative gap {r['final_rel_gap']:.3g}; "
                  f"parted at round {r['first_parted_round']}; messages "
                  f"not their replays {r['unfaithful_a']} / "
                  f"{r['unfaithful_b']}; first differing message "
                  f"{r.get('first_difference')}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
