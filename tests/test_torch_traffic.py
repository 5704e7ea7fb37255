"""repro_torch.core.traffic against repro.core.traffic: arrival draws,
the availability chain, admission, and the traffic plan of
``benchmarks/traffic_bench.py``.

Exact (bit for bit): ``thinned_delays`` and ``replay_delays`` at [G] rate
tables and taus, ``availability_step`` (a row summed left to right in
float32, as XLA sums three entries) over many rounds, ``traffic_send``'s
send masks (availability, busy exclusion, the in-flight cap) and delays,
``admit_arrivals``, ``traffic_hparams``; and the traffic plan's ledgers,
sends and arrivals at every round.  Objectives to rtol 5e-4 (FedNL 5e-3:
its top-k keeps one of a mirrored pair of ties by the last ulp, as in
tests/test_torch_api.py).

The port's own contracts, as the reference pins its own
(tests/test_traffic.py): a staleness cutoff of 0 at tau = 0 is the
synchronous run bit for bit, at tau = 2 it discards every arrival unbilled,
``max_in_flight`` bounds the sends, traffic needs the buffered path, and
the chain's occupancy follows its stationary law.  The rows of the traffic
plan go against ``benchmarks/out/golden/traffic_bench.json`` where the
reference as run here agrees with the golden (another JAX release's key
streams drift the thinned arrivals), and against the reference elsewhere.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import driver as jdr
from repro.core import traffic as jt
from repro.data import logreg as jl
from repro_torch import convert
from repro_torch import experiments as ex
from repro_torch import random as tr
from repro_torch.core import api as tapi
from repro_torch.core import driver as tdr
from repro_torch.core import traffic as tt
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
TRANS = ((0.8, 0.15, 0.05), (0.6, 0.4, 0.0), (0.3, 0.0, 0.7))


def _tkeys(G, seed=0):
    return tr.split(tr.key(seed, "cpu"), G)


def _jkeys(G, seed=0):
    return jax.random.split(jax.random.key(seed), G)


def test_salts_and_states_are_the_reference():
    assert (tt.ARRIVAL_SALT, tt.AVAIL_SALT, tdr.ASYNC_SALT) == (
        jt.ARRIVAL_SALT, jt.AVAIL_SALT, jdr.ASYNC_SALT)
    assert (tt.AVAILABLE, tt.BUSY, tt.DROPPED) == (
        jt.AVAILABLE, jt.BUSY, jt.DROPPED)


@pytest.mark.parametrize("kw", [
    dict(arrival=jt.ArrivalSchedule("poisson", rates=(0.6,))),
    dict(arrival=jt.ArrivalSchedule("diurnal", rates=(0.9, 0.5, 0.2, 0.5)),
         availability=jt.AvailabilityModel(),
         admission=jt.AdmissionPolicy(3.0, 6.0)),
    dict(),
], ids=["poisson", "diurnal", "default"])
def test_traffic_hparams_match_reference(kw):
    jm = jt.TrafficModel(**kw)
    tm = tt.TrafficModel(**{k: getattr(tt, type(v).__name__)(
        **dataclasses.asdict(v)) for k, v in kw.items()})
    got = tt.traffic_hparams(tm)
    want = convert.traffic_hparams_from_reference(
        jax.tree.map(np.asarray, jt.traffic_hparams(jm)), "cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_validation_matches_reference():
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="unknown arrival kind"):
            mod.ArrivalSchedule("bursty")
        with pytest.raises(ValueError, match="single rate"):
            mod.ArrivalSchedule("poisson", rates=(0.5, 0.5))
        with pytest.raises(ValueError, match="in \\(0, 1\\]"):
            mod.ArrivalSchedule("diurnal", rates=(0.5, 0.0))
        with pytest.raises(ValueError, match="requires a \\[T, n\\]"):
            mod.ArrivalSchedule("trace")
        with pytest.raises(ValueError, match=">= 0"):
            mod.ArrivalSchedule("trace", trace=[[1, -1]])
        with pytest.raises(ValueError, match="square"):
            mod.AvailabilityModel(((0.5, 0.5),))
        with pytest.raises(ValueError, match="sum to 1"):
            mod.AvailabilityModel(((0.5, 0.4), (0.5, 0.5)))
        with pytest.raises(ValueError, match="staleness_cutoff"):
            mod.AdmissionPolicy(staleness_cutoff=-1.0)
        with pytest.raises(ValueError, match="max_in_flight"):
            mod.AdmissionPolicy(max_in_flight=-1.0)


def test_thinned_and_replayed_delays_match_reference():
    """Per-point rate tables, taus and phases: the reference's
    ``thinned_delays`` vmapped over the grid, bit for bit."""
    rng = np.random.default_rng(0)
    G, n, slots = 4, 300, 5
    tables = rng.uniform(0.05, 1.0, (G, 3)).astype(np.float32)
    taus = np.array([0, 1, 3, 4], np.int32)
    for k in (0, 1, 7):
        want = jax.vmap(lambda r, key, tau: jt.thinned_delays(
            r, key, n, k, tau, slots))(jnp.asarray(tables), _jkeys(G, k),
                                       jnp.asarray(taus))
        got = tt.thinned_delays(torch.as_tensor(tables), _tkeys(G, k), n, k,
                                torch.as_tensor(taus), slots)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    trace = rng.integers(0, 7, (5, 6))
    for k in (0, 4, 13):
        want = jax.vmap(lambda tau: jt.replay_delays(trace, k, tau))(
            jnp.asarray(taus))
        got = tt.replay_delays(trace, k, torch.as_tensor(taus))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_availability_chain_matches_reference_bitwise():
    """400 rounds of the chain at three transition matrices (a [G] grid),
    every round's states equal."""
    mats = np.array([TRANS, ((0.85, 0.10, 0.05), (0.60, 0.40, 0.00),
                             (0.10, 0.00, 0.90)),
                     ((0.3, 0.3, 0.4), (0.1, 0.1, 0.8), (0.7, 0.2, 0.1))],
                    np.float32)
    G, n = 3, 64
    step = jax.jit(jax.vmap(jt.availability_step))
    ja = jnp.zeros((G, n), jnp.int32)
    ta = torch.zeros((G, n), dtype=torch.int64)
    for r in range(400):
        ja = step(jnp.asarray(mats), ja, _jkeys(G, r))
        ta = tt.availability_step(torch.as_tensor(mats), ta, _tkeys(G, r))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert set(np.unique(ta.numpy())) == {0, 1, 2}


def test_availability_occupancy_matches_stationary_law():
    pi = tt.stationary_distribution(TRANS)
    np.testing.assert_allclose(pi, jt.stationary_distribution(TRANS),
                               rtol=1e-12)
    np.testing.assert_allclose(pi @ np.asarray(TRANS), pi, atol=1e-9)
    trans = torch.tensor(TRANS, dtype=torch.float32)
    keys = tr.split(tr.key(7, "cpu"), 2000)
    avail = torch.zeros(64, dtype=torch.int64)
    counts = np.zeros(3)
    for r in range(2000):
        avail = tt.availability_step(trans, avail, keys[r])
        if r >= 300:
            counts += np.bincount(avail.numpy(), minlength=3)
    np.testing.assert_allclose(counts / counts.sum(), pi, atol=0.02)


def _buffer(occupied):
    occ = np.asarray(occupied, np.float32)
    S, n = occ.shape
    return (jdr.MessageBuffer({"t": jnp.zeros((S, n))}, jnp.asarray(occ)),
            tdr.MessageBuffer({"t": torch.zeros((S, n))},
                              torch.as_tensor(occ)))


@pytest.mark.parametrize("profile", ["schedule", "poisson", "diurnal",
                                     "trace"])
def test_traffic_send_matches_reference(profile):
    """Availability, busy exclusion and the in-flight cap on the send
    mask, and the arrival process's delays, over rounds of random
    occupancy: the reference's masks, delays and chain states."""
    rng = np.random.default_rng(3)
    n = 6
    kind = dict(schedule="schedule", poisson="poisson", diurnal="diurnal",
                trace="trace")[profile]
    arrival = dict(kind=kind)
    if kind == "poisson":
        arrival["rates"] = (0.6,)
    elif kind == "diurnal":
        arrival["rates"] = (0.9, 0.5, 0.2, 0.5)
    elif kind == "trace":
        arrival["trace"] = rng.integers(0, 5, (4, n))
    models = [m.TrafficModel(arrival=m.ArrivalSchedule(**arrival),
                             availability=m.AvailabilityModel(),
                             admission=m.AdmissionPolicy(3.0, 3.0))
              for m in (jt, tt)]
    jthp = jt.traffic_hparams(models[0])
    tthp = tt.traffic_hparams(models[1])
    jst, tst = jt.init_traffic_state(n), tt.init_traffic_state(n)
    for k in range(20):
        jbuf, tbuf = _buffer(rng.random((3, n)) < 0.2)
        mask = (rng.random(n) < 0.8).astype(np.float32)
        base = rng.integers(0, 3, n)
        key_j, key_t = jax.random.key(k), tr.key(k, "cpu")
        js, jd, jst = jt.traffic_send(models[0], jthp, jst, jbuf,
                                      jnp.asarray(mask), key_j, k, 2,
                                      jnp.asarray(base, jnp.int32))
        ts, td, tst = tt.traffic_send(models[1], tthp, tst, tbuf,
                                      torch.as_tensor(mask), key_t, k, 2,
                                      torch.as_tensor(base))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tst.avail.numpy(),
                                      np.asarray(jst.avail))
        busy = tbuf.occupied.amax(dim=0).sum()
        assert float(ts.sum()) <= max(0.0, 3.0 - float(busy))


def test_admit_arrivals_matches_reference():
    rng = np.random.default_rng(4)
    arrived = (rng.random(8) < 0.7).astype(np.float32)
    msg_t = rng.integers(0, 10, 8).astype(np.float32)
    for cutoff in (0.0, 2.0, float("inf")):
        models = [m.TrafficModel(admission=m.AdmissionPolicy(cutoff))
                  for m in (jt, tt)]
        want = jt.admit_arrivals(models[0], jt.traffic_hparams(models[0]),
                                 jnp.asarray(arrived), jnp.asarray(msg_t),
                                 10)
        got = tt.admit_arrivals(models[1], tt.traffic_hparams(models[1]),
                                torch.as_tensor(arrived),
                                torch.as_tensor(msg_t), 10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tt.admit_arrivals(None, None, torch.as_tensor(arrived), None,
                             3) is not None


def test_traffic_send_guards():
    _, tbuf = _buffer(np.zeros((2, 4)))
    with pytest.raises(ValueError, match="traced leaves"):
        tt.traffic_send(tt.TrafficModel(), None, None, tbuf,
                        torch.ones(4), tr.key(0, "cpu"), 0, 1,
                        torch.zeros(4, dtype=torch.int64))
    model = tt.TrafficModel(availability=tt.AvailabilityModel())
    with pytest.raises(ValueError, match="chain state"):
        tt.traffic_send(model, tt.traffic_hparams(model), None, tbuf,
                        torch.ones(4), tr.key(0, "cpu"), 0, 1,
                        torch.zeros(4, dtype=torch.int64))


# ---------------------------------------------------------------------------
# Admission contracts on the plan path
# ---------------------------------------------------------------------------

SMALL = dict(d=12, n_workers=4, r=12, mu=1e-3, seed=9)


@pytest.fixture(scope="module")
def prob():
    return tl.make_problem(**SMALL, device="cpu")


def _async_plan(prob, method, tau, traffic, iters=8):
    return tapi.ExperimentPlan(
        problem=prob, runs=(tapi.MethodRun(method),), iters=iters, seed=3,
        staleness=tdr.StalenessSchedule("fixed", tau=tau),
        buffer_k=float(prob.n_workers), traffic=traffic)


@pytest.mark.parametrize("method", ["flecs_cgd", "fednl"])
def test_cutoff_zero_at_tau_zero_is_the_sync_run(prob, method):
    traffic = tt.TrafficModel(admission=tt.AdmissionPolicy(0.0))
    res_a = tapi.run_plan(_async_plan(prob, method, 0, traffic))
    res_s = tapi.run_plan(tapi.ExperimentPlan(
        problem=prob, runs=(tapi.MethodRun(method),), iters=8, seed=3))
    for key in ("bits_per_node", "F", "n_active"):
        assert torch.equal(res_a.traces[method][key],
                           res_s.traces[method][key])
    assert torch.equal(res_a.states[method].w, res_s.states[method].w)


def test_cutoff_zero_at_tau_two_discards_everything_unbilled(prob):
    traffic = tt.TrafficModel(admission=tt.AdmissionPolicy(0.0))
    res = tapi.run_plan(_async_plan(prob, "flecs_cgd", 2, traffic))
    trc = res.traces["flecs_cgd"]
    assert float(trc["n_active"].sum()) > 0
    assert not trc["bits_per_node"].any() and not trc["n_arrived"].any()
    assert not res.states["flecs_cgd"].w.any()


def test_max_in_flight_bounds_per_round_sends(prob):
    traffic = tt.TrafficModel(
        arrival=tt.ArrivalSchedule("poisson", rates=(0.7,)),
        admission=tt.AdmissionPolicy(max_in_flight=2.0))
    res = tapi.run_plan(_async_plan(prob, "diana", 3, traffic, iters=20))
    n_active = res.traces["diana"]["n_active"]
    assert float(n_active.max()) <= 2.0 and float(n_active.sum()) > 0


def test_traffic_requires_the_buffered_path(prob):
    plan = tapi.ExperimentPlan(problem=prob, runs=(tapi.MethodRun("diana"),),
                               iters=2, traffic=tt.TrafficModel())
    with pytest.raises(ValueError, match="staleness"):
        tapi.run_plan(plan)


# ---------------------------------------------------------------------------
# The traffic plan against the reference and the golden
# ---------------------------------------------------------------------------

GOLDEN = dict(d=12, n_workers=4, r=12, mu=1e-3, seed=0)


def _reference_bench():
    spec = importlib.util.spec_from_file_location(
        "traffic_bench", ROOT / "benchmarks" / "traffic_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def plans():
    """Each profile's plan at the golden's size (8 rounds, tau 2), run by
    the reference and by the port."""
    bench = _reference_bench()
    jp = jl.make_problem(**GOLDEN)
    tp = tl.make_problem(**GOLDEN, device="cpu")
    return {p: (japi.run_plan(bench.traffic_plan(jp, p, 8, 2)),
                tapi.run_plan(ex.traffic_plan(tp, p, 8, 2)))
            for p in ex.TRAFFIC_PROFILES}


@pytest.mark.parametrize("profile", ex.TRAFFIC_PROFILES)
def test_traffic_plan_matches_reference(plans, profile):
    """Every method's ledgers, sends, arrivals, flushes and buffered
    counts at every round exact; F to rtol 5e-4 (FedNL 5e-3); the
    availability chain's final states equal."""
    want, got = plans[profile]
    assert got.labels == want.labels
    for lab in want.labels:
        jst, jtr = want[lab]
        tst, ttr = got[lab]
        for key in ("bits_per_node", "n_active", "n_arrived", "flushed",
                    "buffered", "staleness_mean"):
            np.testing.assert_array_equal(ttr[key].numpy(),
                                          np.asarray(jtr[key]), key)
        np.testing.assert_allclose(ttr["F"].numpy(), np.asarray(jtr["F"]),
                                   rtol=5e-3 if lab == "fednl" else 5e-4)
        if profile != "fixed":
            np.testing.assert_array_equal(tst.traffic.avail.numpy(),
                                          np.asarray(jst.traffic.avail))


def test_traffic_rows_match_golden_where_the_reference_does(plans):
    """``traffic_bench.json``'s rows: exact on the labels and ledgers the
    reference as run here reproduces, the tolerant keys (F, Mbits_mean;
    rtol 5e-2, the golden's own contract) drifting only where the
    reference's do, and there held to the reference's values."""
    spec = importlib.util.spec_from_file_location(
        "check_bench_drift", ROOT / "scripts" / "check_bench_drift.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    golden = json.loads((ROOT / "benchmarks/out/golden/traffic_bench.json")
                        .read_text())["rows"]
    port = [r for p in ex.TRAFFIC_PROFILES
            for r in ex.traffic_rows(p, plans[p][1])]
    ref = []
    for p in ex.TRAFFIC_PROFILES:
        res = plans[p][0]
        ref += [{"profile": p, "method": m,
                 "F": float(np.asarray(res.traces[m]["F"])[0, -1]),
                 "Mbits_mean": float(np.mean(np.asarray(
                     res.states[m].bits_per_node[0]))) / 1e6}
                for m in ex.TRAFFIC_METHODS]

    def drift(rows):
        errors = []
        check._compare("traffic_bench.json", "", golden, rows, 5e-2, 1e-8,
                       errors)
        return {e.split(":")[0] for e in errors}

    assert [(r["profile"], r["method"]) for r in port] == [
        (r["profile"], r["method"]) for r in golden]
    assert drift(port) <= drift(ref)
    for a, b in zip(port, ref):
        assert a["Mbits_mean"] == b["Mbits_mean"]
        np.testing.assert_allclose(a["F"], b["F"], rtol=5e-3)
