"""``repro_torch.plan_drift``: where two runs of the budget-fair plan part.

At the small size (d = 24, n = 4, r = 24) one ulp of noise in the features
is enough to move a dither level or a top-k selection, and one moved level
can carry a point's final F more than 1e-4 away.  These tests hold that
every such parting starts at a rounding decision (a uniform between the two
runs' fractional parts, or a top-k near-tie) after rounds that agreed, and
that the tool's levels are the compressor's own.  Records made on the card
are replayed through the plain compressor: the tests mark CPU records as
the card's, so a corrupted message must be caught as not its replay, and
``verdict`` must fail it and a run that parts beyond its limit.  Async
runs (the async grid) also record each round's routing: it never differs
under ulp noise, a changed decision is named, and a sub-grid runs its
points on the grid's own key streams.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch import plan_drift, random
from repro_torch.core import compressors
from repro_torch.data.logreg import make_problem
from repro_torch.kernels.compressor import ref

SMALL = dict(d=24, n_workers=4, r=24, mu=1e-3, seed=0)


def _compare(ulp_seed):
    prob = make_problem(**SMALL, device="cpu")
    plan = plan_drift.PLANS["budget_fair"]
    return plan_drift.compare(plan(prob),
                              plan(plan_drift.nudged(prob, ulp_seed)))


@pytest.mark.parametrize("ulp_seed", [0, 1, 2])
def test_ulp_noise_parts_runs_only_at_rounding_decisions(ulp_seed):
    """Every point whose final F moved by more than 1e-6 has a first
    differing message that a rounding decision explains, and F agreed
    within 1e-6 until that round."""
    parted = 0
    for lab, reports in _compare(ulp_seed).items():
        for r in reports:
            if r["final_rel_gap"] <= 1e-6:
                continue
            parted += 1
            diff = r.get("first_difference")
            assert diff is not None, (lab, r)
            assert diff["explained"], (lab, r)
            assert diff["rel_gap_before"] <= 1e-6, (lab, r)
    assert parted >= 1


def test_one_level_moves_flecs_cgd_past_rtol_1e_4():
    """FLECS-CGD at the largest budget: a single dither level, flipped by
    one ulp of noise in the features at round 30, leaves the final F
    1.1e-4 away (beyond the card test's rtol 1e-4) although F agreed
    within 1e-6 until then."""
    r = _compare(0)["FLECS-CGD"][2]
    diff = r["first_difference"]
    assert r["final_rel_gap"] > 1e-4
    assert diff["levels_differing"] == 1 and diff["explained"]
    assert abs(diff["level_a"] - diff["level_b"]) == 1
    assert diff["rel_gap_before"] <= 1e-6
    assert r["first_parted_round"] > diff["round"]


def test_recomputed_levels_are_the_recorded_messages():
    """The tool's u and levels rebuild every recorded dither message bit
    for bit, so the levels it compares are the compressor's."""
    prob = make_problem(**SMALL, device="cpu")
    _, calls = plan_drift.run_recorded(plan_drift.PLANS["budget_fair"](prob))
    checked = 0
    for c in calls:
        spec = c["spec"]
        for g, fam in enumerate(spec.family):
            if fam != 1:
                continue
            x = c["x"][g].reshape(c["x"].shape[1], -1)
            u = random.uniform(random.split(c["key"][g], x.shape[0]),
                               (x.shape[1],))
            level, _, _ = plan_drift._dither_parts(x, u,
                                                   float(spec.s_host[g]))
            norm = x.abs().amax(dim=1, keepdim=True)
            s = torch.tensor(float(spec.s_host[g]))
            want = ref.sign(x) * level * torch.where(norm == 0, 1.0,
                                                     norm) / s
            assert torch.equal(want, c["out"][g].reshape(x.shape))
            checked += 1
    assert checked > 100


def test_stochastic_run_parts_at_a_dither_flip():
    """Stochastic FLECS-CGD at quickstart size (minibatch oracles, exact-k
    sampling, 50 rounds): one ulp of noise in A moves F by ~1e-4 (measured
    1.13e-4), and the runs part at one dither level whose uniform lies
    between the two fractional parts, after rounds that agreed within
    1e-6 — the same mechanism that parts the card from the CPU."""
    rep = plan_drift.compare_runs(plan_drift.stochastic_run("cpu"),
                                  plan_drift.stochastic_run("cpu-ulp"))
    diff = rep["first_difference"]
    assert diff["family"] == 1 and diff["explained"]
    assert diff["rel_gap_before"] <= 1e-6
    assert rep["first_parted_round"] >= diff["round"]
    assert rep["final_rel_gap"] > 1e-5
    assert rep["unfaithful_a"] == rep["unfaithful_b"] == 0


def test_sketch_families_part_at_rounding_decisions():
    """The families plan (dither, top-k, count sketch, min-max gradients)
    under one ulp of noise, d = 24, 60 rounds: every parted point parts at
    an explained decision after rounds that agreed within 1e-6."""
    prob = make_problem(**SMALL, device="cpu")
    plan = plan_drift.PLANS["sketch_families"]
    reports = plan_drift.compare(plan(prob, 60), plan(plan_drift.nudged(
        prob, 0), 60))["families"]
    assert len(reports) == 4
    for r in reports:
        if r["final_rel_gap"] > 1e-6:
            diff = r["first_difference"]
            assert diff["explained"] and diff["rel_gap_before"] <= 1e-6, r


def _as_card(rec):
    """A copy of a record_run result whose calls claim to come from the
    card, so that every message is replayed."""
    state, tr, calls = rec
    calls = [dict(c, device="cuda", out=c["out"].clone()) for c in calls]
    return state, tr, calls


@pytest.fixture(scope="module")
def stochastic_pair():
    """A short stochastic run on the CPU and on the CPU with A nudged."""
    return (plan_drift.record_run(plan_drift.stochastic_run("cpu", 14)),
            plan_drift.record_run(plan_drift.stochastic_run("cpu-ulp", 14)))


def test_replayed_messages_are_their_replays(stochastic_pair):
    """Every message of a run, replayed through the plain compressor from
    its recorded spec, key and input, is the recorded message bit for bit
    (the replay a card run is held to)."""
    a, b = stochastic_pair
    rep = plan_drift.compare_recorded_runs(_as_card(a), _as_card(b))
    assert rep["unfaithful_a"] == rep["unfaithful_b"] == 0
    assert rep["first_difference"]["explained"]
    assert not plan_drift.verdict(rep, 1.0)


@pytest.mark.parametrize("where", ["before", "after"])
def test_a_wrong_card_message_is_caught(stochastic_pair, where):
    """One dither level of one card message moved by one step, before or
    after the first (explained) flip: the report counts that message as
    not its replay, with its round, and ``verdict`` fails the run; moved
    before the flip, the first difference is that message and is not
    explained."""
    a, b = stochastic_pair
    base = plan_drift.compare_recorded_runs(a, b)["first_difference"]
    card = _as_card(a)
    c = 2 * (base["round"] - 3 if where == "before" else base["round"] + 2)
    out = card[2][c]["out"]
    x = card[2][c]["x"]
    out[0, 3, 5] += x[0, 3].abs().amax() / 64
    rep = plan_drift.compare_recorded_runs(card, b)
    assert rep["unfaithful_a"] == 1 and rep["unfaithful_b"] == 0
    assert rep["first_unfaithful_a"]["round"] == c // 2
    assert plan_drift.verdict(rep, 1.0)
    if where == "before":
        assert rep["first_difference"]["round"] == c // 2
        assert not rep["first_difference"]["explained"]


def _call(name, x, seed=3):
    spec = compressors.stack_specs(name)
    key = random.split(random.key(seed, "cpu"), 1)
    return dict(spec=spec, key=key, x=x,
                out=compressors.compress_split(spec, key, x), device="cpu")


@pytest.mark.parametrize("name", ["natural", "count_sketch16"])
def test_natural_and_count_sketch_differences_are_reported(name):
    """natural and the count sketch report their first differing message
    (natural's powers of two, p and u; the count sketch's input and output
    gaps) and call it explained where both sides are their replays."""
    g = np.random.default_rng(0)
    x = torch.as_tensor(g.normal(size=(1, 8, 123)).astype(np.float32))
    diff = plan_drift.first_difference(_call(name, x),
                                       _call(name, x * 1.01), 0)
    assert diff is not None and diff["explained"]
    if name == "natural":
        assert diff["family"] == compressors.FAMILY_NATURAL
        if diff["lo_a"] == diff["lo_b"]:
            assert min(diff["p_a"], diff["p_b"]) <= diff["u"] \
                <= max(diff["p_a"], diff["p_b"])
    else:
        assert diff["family"] == compressors.FAMILY_COUNT_SKETCH
        assert diff["output_rel_gap"] > 0 and diff["input_rel_gap"] > 0
    assert plan_drift.first_difference(_call(name, x), _call(name, x),
                                       0) is None


def test_verdict_holds_F_to_the_strict_limit_or_the_envelope():
    """F within rtol 1e-4 at every round passes; beyond it, only within
    ENVELOPE_FACTOR times the CPU's ulp envelope; a first difference after
    F had parted fails."""
    rep = dict(unfaithful_a=0, unfaithful_b=0, final_rel_gap=5e-5,
               max_rel_gap=9e-5)
    assert not plan_drift.verdict(rep)
    rep.update(max_rel_gap=3e-4)
    assert plan_drift.verdict(rep, 5e-5)
    assert not plan_drift.verdict(rep, 1e-4)
    rep["first_difference"] = dict(explained=True, rel_gap_before=1e-5)
    assert plan_drift.verdict(rep, 1e-4)


def test_stochastic_envelope_is_the_largest_ulp_gap(stochastic_pair):
    """The envelope is the largest gap over its seeds, each a CPU run
    against the same run with A nudged in place (the oracles see it)."""
    a, b = stochastic_pair
    env, gaps = plan_drift.envelope("stochastic", 14, seeds=((0, 0), (1, 0)),
                                    runs={(0, None): a[1]["F"]})
    assert env == [max(g for g, in gaps)] and len(gaps) == 2
    assert min(g for g, in gaps) > 0
    assert gaps[0] == [plan_drift.compare_recorded_runs(a, b)["max_rel_gap"]]


# ---------------------------------------------------------------------------
# Async runs: messages matched by round, routing decisions named
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def async_pair():
    """The async grid (d = 24, n = 4, 40 rounds: taus {0, 2, 4} × buffer_k
    {1, 4}, G = 6) on the CPU and on the CPU
    with A nudged by one ulp, every call and route recorded."""
    return tuple(plan_drift.record_run(plan_drift.async_grid_run(side, 40))
                 for side in ("cpu", "cpu-ulp"))


def test_async_grid_parts_at_rounding_decisions(async_pair):
    """Every point of the async grid that parts under one ulp of noise
    parts at an explained decision, after rounds that agreed within 1e-6;
    the routing (masks, fixed delays, arrivals) never differs; every
    message is its own replay."""
    reports = plan_drift.compare_recorded_grid(*async_pair)
    assert len(reports) == 6
    routes = plan_drift._route_pairs(async_pair[0][2], async_pair[1][2])
    assert len(routes) == 40
    for r in reports:
        assert r["unfaithful_a"] == r["unfaithful_b"] == 0
        diff = r.get("first_difference")
        if diff is not None:
            assert diff.get("kind") is None, diff     # not a routing one
            assert diff["explained"] and diff["rel_gap_before"] <= 1e-6
    for ra, rb in routes:
        for g in range(6):
            assert plan_drift.route_difference(ra, rb, g) is None


def test_route_differences_are_named_and_only_delays_explained(async_pair):
    """A changed availability state, send or admitted arrival is the first
    difference of its round, named and unexplained; a changed delay of a
    worker that sent nothing is no difference."""
    ra = async_pair[0][2].routes[5]
    for field, kind in (("send", "send"), ("arrived", "admission")):
        rb = dict(ra, **{field: ra[field].clone()})
        rb[field][3, 1] = 1.0 - rb[field][3, 1]
        diff = plan_drift.route_difference(ra, rb, 3)
        assert diff["kind"] == kind and diff["worker"] == 1
        assert not diff["explained"]
        assert plan_drift.route_difference(ra, rb, 2) is None
    idle = int(torch.nonzero(ra["send"][0] == 0)[0, 0])
    rb = dict(ra, delays=ra["delays"].clone())
    rb["delays"][0, idle] += 1
    assert plan_drift.route_difference(ra, rb, 0) is None
    avail = dict(ra, avail=torch.zeros_like(ra["send"], dtype=torch.int64))
    changed = dict(avail, avail=avail["avail"].clone())
    changed["avail"][4, 0] = 2
    assert plan_drift.route_difference(avail, changed, 4)["kind"] == \
        "availability"


def test_async_envelope_is_the_grid_reports_gaps(async_pair):
    """The async grid's envelope from its F traces alone (each run made
    by ``envelope_F``, a worker process's job) is each grid point's
    ``max_rel_gap`` of the recorded comparison, the largest over its seed
    pairs."""
    want = [r["max_rel_gap"]
            for r in plan_drift.compare_recorded_grid(*async_pair)]
    base = plan_drift.envelope_F("async", 0, None, 40)
    assert torch.equal(base, async_pair[0][1]["F"])
    env, gaps = plan_drift.envelope("async", 40, seeds=((0, 0),),
                                    runs={(0, None): base})
    assert gaps == [want] and env == want
    env2, gaps2 = plan_drift.envelope("async", 40, seeds=((0, 0), (0, 1)),
                                      runs={(0, None): base, (0, 0): plan_drift
                                            .envelope_F("async", 0, 0, 40)})
    assert gaps2[0] == want and env2 == [max(a, b) for a, b in
                                         zip(*gaps2)]
