"""The paper's remaining figures in the port (``repro_torch.experiments``:
``fig3_iterate_updates``, ``comm_table``, ``ablation_dither_levels``,
``vmapped_grid``, ``ablation_grid_plan`` / ``ablation_grid``) against the
reference's functions of the same names (``benchmarks/paper_experiments``)
at d = 16, 4 workers, 6 rounds.

Exact: the communication table's bits (measured and formula) and every
ledger column; the rows' keys and order.  F and grad_sq within rtol 1e-4
(the closed-form oracles against autodiff, through dithering: a last-ulp
difference can move a dithered value to the next level), but for the
truncated inverse with L-SR1, which diverges in the reference itself at
this size (F 1.056 at round 0, 2.56 at round 5): there the first row is
held to rtol 1e-4, the ledgers exactly, and both runs must diverge (F past
twice its first value by the last row); the diverging rows part as any two
roundings of an unstable run do.
"""
import functools

import numpy as np
import pytest

from benchmarks import paper_experiments as pe
from repro.data import logreg as jl
from repro_torch import convert
from repro_torch import experiments as ex

ITERS = 6


@functools.lru_cache(maxsize=None)
def _problems():
    j = jl.make_problem(d=16, n_workers=4, r=16, seed=0)
    t = convert.problem_from_reference(np.asarray(j.A), np.asarray(j.b),
                                       j.mu, device="cpu")
    return j, t


def _rows_close(got, want, rtol=1e-4, exact=("bits_per_node", "Mbits",
                                              "iter", "s", "alpha",
                                              "grad_s", "hess_s", "beta")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in exact:
                assert g[k] == w[k], (k, g[k], w[k])
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def test_comm_table_bits_exact():
    jp, tp = _problems()
    got, want = ex.comm_table(tp), pe.comm_table(jp)
    assert got == want
    assert all(r["match"] for r in got)
    for r in got:
        c = 32 if r["method"] == "FLECS" else 8
        assert r["measured_bits"] == 8 * r["m"] * 16 + c * 16 + 32 * r["m"] ** 2


@functools.lru_cache(maxsize=None)
def _fig3():
    jp, tp = _problems()
    return ex.fig3_iterate_updates(tp, ITERS)[0], \
        pe.fig3_iterate_updates(jp, ITERS)[0]


@pytest.mark.parametrize("name", ex.FIG3_RUNS)
def test_fig3_iterate_updates_match_reference(name):
    got, want = _fig3()
    assert list(got) == list(want)
    if name != "TruncInv+LSR1":
        _rows_close(got[name], want[name])
        return
    g, w = got[name], want[name]
    _rows_close(g[:1], w[:1])
    assert [r["bits_per_node"] for r in g] == [r["bits_per_node"] for r in w]
    for rows in (g, w):
        assert rows[-1]["F"] > 2 * rows[0]["F"]


def test_ablation_dither_levels_match_reference():
    jp, tp = _problems()
    _rows_close(ex.ablation_dither_levels(tp, ITERS),
                pe.ablation_dither_levels(jp, ITERS))


def test_vmapped_grid_matches_reference():
    jp, tp = _problems()
    _rows_close(ex.vmapped_grid(tp, ITERS)[0], pe.vmapped_grid(jp, ITERS)[0])


def test_ablation_grid_matches_reference():
    jp, tp = _problems()
    plan = ex.ablation_grid_plan(tp, ITERS)
    assert plan.runs[0].hparams.alpha.shape == (8,)
    rows = ex.ablation_grid(tp, ITERS)[0]
    assert [(r["grad_s"], r["hess_s"], r["beta"]) for r in rows] == [
        (gs, hs, b) for gs in (16.0, 64.0) for b in (0.5, 1.0)
        for hs in (16.0, 64.0)]
    _rows_close(rows, pe.ablation_grid(jp, ITERS)[0])
