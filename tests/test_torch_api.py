"""repro_torch.core.api against repro.core.api: the method registry, the
plan lowering (budgets crossed with grids, budget scan lengths, key
streams), ``run_plan`` on the paper's four comparison plans, the rows of
their JSON files against the committed goldens, and the port's
``federated_logreg`` CLI.

Sizes are the goldens' (``--plans-only --d 16 --workers 4 --r 16 --iters
6``).  Exact: labels, grid sizes, scan lengths, bit ledgers, activity
counts, the budget rounds and frozen counters.  Objectives: rtol 5e-4 on F
(a dithered value may move a level, as in tests/test_torch_flecs.py) and
1e-2 on grad_sq (a small difference of gradients).  FedNL diverges at this
size in the reference itself (F 1.16 → 41.5 over the budget plan's six
rounds: top-k of a d×d difference keeps one of a mirrored pair of ties by
its last ulp, tests/test_torch_baselines.py), and its gap grows with it
(9.1e-4 measured at the last round): its F is held to rtol 5e-3.

Goldens (``benchmarks/out/golden``): exact on bits, rounds and the axes,
rtol 5e-2 on the tolerant keys, their own contract
(``scripts/check_bench_drift.py``).  The JAX reference itself, run here,
drifts from them on some tolerant values (grad_sq, and under sampling
``Mbits_mean``/``active_mean``: the goldens come from another JAX release,
whose key streams differ); the port is held to the golden wherever the
reference is, and to the reference's own value where it is not.
"""
import importlib.util
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import paper_experiments as pe
from repro.core import api as japi
from repro.core import flecs as jf
from repro.data import logreg as jl
from repro_torch import convert
from repro_torch import experiments as ex
from repro_torch import federated_logreg
from repro_torch.core import api as tapi
from repro_torch.core import compressors as tc
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.data import logreg as tl

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    six parallel processes on a few cores, where eight threads a process
    spend their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent
SIZE = dict(d=16, n_workers=4, r=16, mu=1e-3, seed=0)
ITERS = 6


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_bench_drift", ROOT / "scripts" / "check_bench_drift.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probs():
    return (jl.make_problem(**SIZE),
            tl.make_problem(**SIZE, device="cpu"))


PLANS = {
    "fig1": lambda m, p: m.fig1_plan(p, ITERS),
    "baselines": lambda m, p: m.baselines_plan(p, ITERS),
    "participation": lambda m, p: m.participation_plan(p, ITERS),
    "budget_fair": lambda m, p: m.budget_fair_plan(p),
}


@pytest.fixture(scope="module")
def results(probs):
    jp, tp = probs
    return {name: (japi.run_plan(make(pe, jp)), tapi.run_plan(make(ex, tp)))
            for name, make in PLANS.items()}


@pytest.mark.parametrize("name", list(PLANS))
def test_run_plan_matches_reference(results, name):
    want, got = results[name]
    assert got.labels == want.labels
    for lab in want.labels:
        jst, jtr = want[lab]
        tst, ttr = got[lab]
        assert set(ttr) == set(jtr)
        for key in ("bits_per_node", "n_active"):
            np.testing.assert_array_equal(ttr[key].numpy(),
                                          np.asarray(jtr[key]))
        np.testing.assert_allclose(ttr["F"].numpy(), np.asarray(jtr["F"]),
                                   rtol=5e-3 if lab == "FedNL" else 5e-4)
        np.testing.assert_allclose(ttr["grad_sq"].numpy(),
                                   np.asarray(jtr["grad_sq"]), rtol=1e-2)
        np.testing.assert_array_equal(tst.k.numpy(), np.asarray(jst.k))
        np.testing.assert_array_equal(tst.bits_per_node.numpy(),
                                      np.asarray(jst.bits_per_node))


ROWS = {
    "fig1_flecs_vs_cgd.json": (
        lambda r, p: pe.fig1_flecs_vs_cgd(p, iters=ITERS)[0],
        lambda r, p: ex.fig1_rows(r["fig1"][1], ITERS)),
    "participation.json": (
        lambda r, p: pe.participation_ablation(p, iters=ITERS),
        lambda r, p: ex.participation_rows(r["participation"][1])),
    "budget_fair.json": (
        lambda r, p: pe.budget_fair_comparison(p),
        lambda r, p: ex.budget_fair_rows(r["budget_fair"][1],
                                         ex.budget_fair_budgets(p))),
}


@pytest.mark.parametrize("name", list(ROWS))
def test_rows_match_goldens(results, probs, name):
    check = _checker()
    golden = json.loads((ROOT / "benchmarks/out/golden" / name).read_text())
    reference = json.loads(json.dumps(ROWS[name][0](results, probs[0])))
    port = json.loads(json.dumps(ROWS[name][1](results, probs[1])))

    def drift(rows, rtol=5e-2):
        errors = []
        check._compare(name, "", golden, rows, rtol, 1e-8, errors)
        return {e.split(":")[0] for e in errors}

    # exact keys all match; tolerant ones drift only where the reference
    # does, and there the port holds to the reference
    assert drift(port) <= drift(reference)
    errors = []
    check._compare(name, "", reference, port, 1e-2, 1e-8, errors)
    assert not errors, errors


def test_cross_bit_budget_order_matches_reference():
    """Point b·G + g pairs budget b with grid point g, on every leaf."""
    jhp = jf.hparam_grid([0.5, 1.0], [1.0], [16.0, 64.0])
    thp = tf.hparam_grid([0.5, 1.0], [1.0], [16.0, 64.0])
    budgets = (1000.0, 5000.0, 2.0 ** 25 + 1)
    jhp2, jbud = japi.cross_bit_budget(jhp, budgets)
    thp2, tbud = tapi.cross_bit_budget(thp, budgets)
    np.testing.assert_array_equal(tbud.numpy(), np.asarray(jbud))
    assert tbud.dtype == tdr.bits_dtype()
    want = convert.hparams_from_reference(tf.FlecsHParams, jax.tree.map(
        np.asarray, jhp2), "cpu")
    for a, b in zip(thp2, want):
        if isinstance(a, tc.CompressorSpec):
            assert a.family == b.family and torch.equal(a.s, b.s)
        else:
            assert (a is None and b is None) or torch.equal(a, b)
    assert tdr.grid_size(thp2) == 12


def test_budget_scan_lengths_match_reference(results):
    want, got = results["budget_fair"]
    for lab in want.labels:
        assert (got.traces[lab]["F"].shape
                == tuple(np.asarray(want.traces[lab]["F"]).shape))


def test_registry_matches_reference():
    assert tapi.method_names() == japi.method_names()
    with pytest.raises(ValueError, match="unknown method"):
        tapi.get_method("adam")
    with pytest.raises(ValueError, match="already registered"):
        tapi.register_method(tapi.get_method("gd"))
    for name in ("flecs", "flecs_cgd"):
        j = japi.get_method(name).grid(ps=(1.0, 0.5))
        t = tapi.get_method(name).grid(ps=(1.0, 0.5))
        assert t.grad_spec.family == tuple(np.asarray(j.grad_spec.family))
        np.testing.assert_array_equal(t.p.numpy(), np.asarray(j.p))
    j = japi.get_method("flecs_cgd").grid(
        grad_specs=jax_stack("identity", "dither64"))
    t = tapi.get_method("flecs_cgd").grid(
        grad_specs=tc.stack_specs("identity", "dither64"))
    assert t.grad_spec.family == tuple(np.asarray(j.grad_spec.family))
    assert t.hess_spec.family == tuple(np.asarray(j.hess_spec.family))
    np.testing.assert_array_equal(t.alpha.numpy(), np.asarray(j.alpha))


def jax_stack(*names):
    from repro.core.compressors import stack_specs
    return stack_specs(*names)


def test_plan_errors(probs):
    """The reference's plan contracts, the async ones included: traffic
    without staleness, async hparams without staleness, a tau beyond the
    buffer's slots, and a method without an async variant all raise, as
    ``repro.core.api`` raises them."""
    import dataclasses
    from repro_torch.core.driver import StalenessSchedule
    from repro_torch.core.traffic import TrafficModel
    from repro_torch.optim import baselines as tb
    _, tp = probs
    runs = (tapi.MethodRun("gd"),)
    with pytest.raises(ValueError, match="rides the async engine"):
        tapi.run_plan(tapi.ExperimentPlan(tp, runs, traffic=TrafficModel()))
    gd = tapi.get_method("gd")
    ahp = tapi._broadcast(tdr.grid1(gd.from_config(gd.default_config())),
                          3, 2.0, tb.GDAsyncHParams)
    with pytest.raises(ValueError, match="require plan.staleness"):
        tapi.run_plan(tapi.ExperimentPlan(
            tp, (tapi.MethodRun("gd", hparams=ahp),)))
    with pytest.raises(ValueError, match="tau=3"):
        tapi.run_plan(tapi.ExperimentPlan(
            tp, (tapi.MethodRun("gd", hparams=ahp),),
            staleness=StalenessSchedule("fixed", tau=1)))
    sync_only = dataclasses.replace(gd, name="gd_sync", init_async=None,
                                    async_sweep_step=None, async_wrap=None)
    with pytest.raises(ValueError, match="no async variant"):
        tapi.run_plan(tapi.ExperimentPlan(
            tp, (tapi.MethodRun(sync_only),),
            staleness=StalenessSchedule("fixed", tau=1)))
    with pytest.raises(ValueError, match="no runs"):
        tapi.run_plan(tapi.ExperimentPlan(tp, ()))
    with pytest.raises(ValueError, match="positive"):
        tapi.run_plan(tapi.ExperimentPlan(tp, runs, bit_budget=(0.0,)))
    bad_p = tdr.grid1(tapi.get_method("gd").from_config(
        tapi.get_method("gd").default_config()))._replace(
            p=torch.tensor([0.0]))
    with pytest.raises(ValueError, match="must be > 0"):
        tapi.run_plan(tapi.ExperimentPlan(
            tp, (tapi.MethodRun("gd", hparams=bad_p),)))
    with pytest.raises(TypeError, match="GDConfig"):
        tapi.run_plan(tapi.ExperimentPlan(
            tp, (tapi.MethodRun("gd", cfg=tf.FlecsConfig()),)))


def test_federated_logreg_cli(capsys):
    federated_logreg.main(["--device", "cpu", "--d", "16", "--workers", "4",
                           "--iters", "6", "--participation", "1.0,0.5"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 11 and out[-1].startswith("(10 trajectories")
    # exact-k sampling (ported): two of four workers every round
    federated_logreg.main(["--device", "cpu", "--d", "16", "--workers", "4",
                           "--iters", "6", "--participation", "0.5",
                           "--sampling", "choice"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and all("active/round=  2.0" in line
                                 for line in out[:5])
    # traffic rides the async engine, as in the reference example
    with pytest.raises(SystemExit, match="--staleness"):
        federated_logreg.main(["--device", "cpu", "--arrival-profile",
                               "diurnal"])


def _cli_rows(capsys, argv, keep):
    """(the port CLI's rows, the reference example's rows) for ``argv``:
    the lines ``keep`` selects of each."""
    import runpy
    import sys
    federated_logreg.main(["--device", "cpu", *argv])
    got = [line for line in capsys.readouterr().out.splitlines()
           if keep(line)]
    old = sys.argv
    sys.argv = ["federated_logreg.py", *argv]
    japi.reset_plan_stats()          # the example asserts its own compile
    try:
        runpy.run_path(str(ROOT / "examples" / "federated_logreg.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    want = [line for line in capsys.readouterr().out.splitlines()
            if keep(line)]
    return got, want


def _cli_fields(line):
    return line.split()[0], {k: float(v) for k, v in re.findall(
        r"([\w/|-]+)=\s*([-+.\deE]+)", line)}


def test_federated_logreg_budget_rows_match_reference_example(capsys):
    """The CLI's budget-fair rows against the reference example's at the
    same size (the example's Bernoulli flags): the same finals."""
    got, want = _cli_rows(capsys, [
        "--d", "16", "--workers", "4", "--bit-budget", "4000",
        "--participation", "1.0,0.5"], lambda line: "@p=" in line)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        gn, gv = _cli_fields(g)
        wn, wv = _cli_fields(w)
        assert gn == wn
        assert gv["Mbits/node"] == wv["Mbits/node"]
        assert gv["active/round"] == wv["active/round"]
        np.testing.assert_allclose(gv["F"], wv["F"], rtol=5e-4)


ASYNC_CLI = {
    "geometric": ["--staleness", "2", "--delay-kind", "geometric",
                  "--participation", "0.5"],
    "diurnal": ["--staleness", "2", "--arrival-profile", "diurnal",
                "--participation", "0.5"],
    "auto-alpha": ["--staleness", "2", "--auto-alpha",
                   "--participation", "0.5"],
}


@pytest.mark.parametrize("case", list(ASYNC_CLI))
def test_federated_logreg_async_rows_match_reference_example(capsys, case):
    """The CLI's async flags against the reference example's rows at the
    same size: the same methods, ledgers, activity and staleness columns
    exactly (masks, delays, traffic and arrivals are the reference's key
    streams), F within rtol 5e-4; the auto-damped alphas it prints equal."""
    argv = ["--d", "16", "--workers", "4", "--iters", "12",
            *ASYNC_CLI[case]]
    got, want = _cli_rows(capsys, argv, lambda line: "F=" in line
                          or line.startswith("auto-damped"))
    assert len(got) == len(want) == 5 + (case == "auto-alpha")
    for g, w in zip(got, want):
        if g.startswith("auto-damped"):
            assert g == w
            continue
        gn, gv = _cli_fields(g)
        wn, wv = _cli_fields(w)
        assert gn == wn and set(gv) == set(wv) and "stale/round" in gv
        for key in ("Mbits/node", "active/round", "stale/round"):
            assert gv[key] == wv[key], (gn, key)
        np.testing.assert_allclose(gv["F"], wv["F"], rtol=5e-4)
