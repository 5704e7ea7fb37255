"""``repro_torch.plan_drift``: where two runs of the budget-fair plan part.

At the small size (d = 24, n = 4, r = 24) one ulp of noise in the features
is enough to move a dither level or a top-k selection, and one moved level
can carry a point's final F more than 1e-4 away.  These tests hold that
every such parting starts at a rounding decision (a uniform between the two
runs' fractional parts, or a top-k near-tie) after rounds that agreed, and
that the tool's levels are the compressor's own.
"""
import pytest
import torch

from repro_torch import plan_drift, random
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
