"""The async engine (repro_torch.core.driver's staleness primitives, the
async steps of repro_torch.core.flecs and repro_torch.optim.baselines, the
async grid of repro_torch.experiments) against the reference's.

Exact (bit for bit): delays of every kind at [G] taus (geometric at powers
of two included), the message buffer's send / receive / busy (cyclic slot
reuse, and the arithmetic blend on -0 and ±inf), FedBuff counts and
flushes, ``damped_alpha``, ``async_hparam_grid``, the sketch of a tensor
of rounds, and every round's ledgers, activity counts, arrivals, buffered
counts and flushes.  Iterates pass through matrix products, pinv and eigh
that round differently in the two packages: one round from a carried
state is held to TOL (rtol 1e-4, atol 1e-6), as in tests/test_torch_flecs.py,
30-round runs' objectives to rtol 1e-4 (measured: <= 1.1e-6 for DIANA and
GD, <= 9.7e-5 for FedNL, whose top-k keeps one of a mirrored pair of ties
by its last ulp, tests/test_torch_baselines.py).

The port's own contracts, as the reference pins its own
(tests/test_async_aggregation.py): at tau = 0 the async step of each
method is its synchronous step bit for bit, bits are billed only at
arrival rounds, and arrivals conserve sends.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import driver as jdr
from repro.core import flecs as jf
from repro.core.sketch import sketch as jsketch
from repro.data import logreg as jl
from repro.optim import baselines as jb
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import compressors as tc
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.core import sketch as tsk
from repro_torch.optim import baselines as tb

TOL = dict(rtol=1e-4, atol=1e-6)
D, N = 16, 4


def _pair(d=D, n=N, r=64, seed=3):
    j = jl.make_problem(d=d, n_workers=n, r=r, seed=seed)
    t = convert.problem_from_reference(np.asarray(j.A), np.asarray(j.b),
                                       j.mu, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def probs():
    return _pair()


def _jkeys(G, seed=0):
    return jax.random.split(jax.random.key(seed), G)


def _tkeys(G, seed=0):
    return tr.split(tr.key(seed, "cpu"), G)


# ---------------------------------------------------------------------------
# Delays, damping, grids
# ---------------------------------------------------------------------------

def test_uniform_minval_matches_reference():
    """``random.uniform`` scaled to [minval, maxval) as JAX scales it."""
    for lo, hi in ((float(np.finfo(np.float32).tiny), 1.0), (-2.5, 3.0),
                   (0.25, 0.5)):
        want = jax.random.uniform(jax.random.key(5), (4, 300), minval=lo,
                                  maxval=hi)
        got = tr.uniform(tr.key(5, "cpu"), (4, 300), minval=lo, maxval=hi)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,q", [("fixed", 0.5), ("uniform", 0.5),
                                    ("geometric", 0.5), ("geometric", 0.3)])
def test_delays_at_grid_taus_match_reference(kind, q):
    """A [G] tau axis: point g draws the reference's
    ``sample_delays(kind, keys[g], n, taus[g], q)``."""
    taus = np.array([0, 1, 2, 4, 7, 30], np.int32)
    n = 500
    want = jax.vmap(lambda k, t: jdr.sample_delays(kind, k, n, t, q))(
        _jkeys(len(taus)), jnp.asarray(taus))
    got = tdr.sample_delays(kind, _tkeys(len(taus)), n,
                            torch.as_tensor(taus), q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a scalar tau, the schedule's own draw
    sched_j = jdr.StalenessSchedule(kind, tau=3, q=q)
    sched_t = tdr.StalenessSchedule(kind, tau=3, q=q)
    np.testing.assert_array_equal(
        sched_t.sample(tr.key(9, "cpu"), n).numpy(),
        np.asarray(sched_j.sample(jax.random.key(9), n)))


@pytest.mark.parametrize("q", [0.5, 0.25])
def test_geometric_delays_at_powers_of_two(q):
    """u = 2^-j makes log(u) / log(q) an integer for q = 1/2 (and 1/4 at
    even j): the floor there is decided by the last ulp of two logs.  The
    port's expression floors as the reference's does on the CPU."""
    u = np.array([2.0 ** -j for j in range(1, 24)]
                 + [np.nextafter(np.float32(2.0 ** -j), np.float32(0))
                    for j in range(1, 24)]
                 + [np.nextafter(np.float32(2.0 ** -j), np.float32(1))
                    for j in range(1, 24)], np.float32)
    uj = jnp.asarray(u)
    want = jnp.minimum(jnp.floor(jnp.log(uj) / jnp.log(jnp.float32(q)))
                       .astype(jnp.int32), 60)
    got = tdr.geometric_delays(torch.as_tensor(u), q, 60)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_schedule_validation():
    with pytest.raises(ValueError, match="staleness kind"):
        tdr.StalenessSchedule("exponential", tau=1)
    with pytest.raises(ValueError, match="tau"):
        tdr.StalenessSchedule("fixed", tau=-1)
    with pytest.raises(ValueError, match="q must be"):
        tdr.StalenessSchedule("geometric", tau=2, q=1.5)
    with pytest.raises(ValueError, match="q must be"):
        tdr.sample_delays("geometric", tr.key(0, "cpu"), 4, 2, q=1.0)
    assert tdr.StalenessSchedule("uniform", tau=5).max_delay == 5


def test_damped_alpha_and_async_grid_match_reference():
    for args in ((1.0, 0.5, 1.0, 20), (0.7, 0.3, 5.0, 20), (1.0, 1.0, 20.0,
                                                            20)):
        np.testing.assert_array_equal(
            tdr.damped_alpha(*args).numpy(),
            np.asarray(jdr.damped_alpha(*args)))
    for kw in (dict(), dict(auto_damp=(0.5, 20)),
               dict(ps=(1.0, 0.5), auto_damp=(0.5, 20), alpha=0.8),
               dict(ps=(0.25,), grad_s=16.0, hess_s=32.0, gamma=0.5)):
        want = jf.async_hparam_grid([0, 2, 4], [1.0, 5.0, 20.0], **kw)
        got = tf.async_hparam_grid([0, 2, 4], [1.0, 5.0, 20.0], **kw)
        conv = convert.async_hparams_from_reference(
            tf.FlecsAsyncHParams, jax.tree.map(np.asarray, want), "cpu")
        assert got.tau.dtype == torch.int32
        for a, b in ((got.tau, conv.tau), (got.buffer_k, conv.buffer_k),
                     (got.hp.alpha, conv.hp.alpha),
                     (got.hp.gamma, conv.hp.gamma)):
            assert torch.equal(a, b)
        assert (got.hp.p is None) == (conv.hp.p is None)
        if got.hp.p is not None:
            assert torch.equal(got.hp.p, conv.hp.p)
        for sa, sb in ((got.hp.grad_spec, conv.hp.grad_spec),
                       (got.hp.hess_spec, conv.hp.hess_spec)):
            assert sa.family == sb.family and torch.equal(sa.s, sb.s)


def test_sketch_of_a_tensor_of_rounds_matches_reference():
    """One sketch a round of a [G, n] round tensor, drawn at once."""
    rounds = np.array([[0, 3, 7], [12, 12, 99]], np.int64)
    for kind in ("rademacher", "coordinate", "gaussian"):
        got = tsk.sketch(kind, 24, 3, torch.as_tensor(rounds), "cpu")
        assert got.shape == (2, 3, 24, 3)
        for i in range(2):
            for j in range(3):
                want = np.asarray(jsketch(kind, 24, 3, int(rounds[i, j])))
                if kind == "gaussian":
                    np.testing.assert_allclose(got[i, j].numpy(), want,
                                               rtol=1e-6, atol=1e-7)
                else:
                    np.testing.assert_array_equal(got[i, j].numpy(), want)


# ---------------------------------------------------------------------------
# The message buffer and FedBuff
# ---------------------------------------------------------------------------

def _bits(x):
    return x.view(torch.int32) if isinstance(x, torch.Tensor) else \
        np.asarray(x).view(np.int32)


def _same(t, j):
    """Bit for bit, any NaN matching any NaN."""
    a, b = t.numpy(), np.asarray(j)
    nan = np.isnan(a) & np.isnan(b)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(np.where(nan, 0, a.view(np.int32)),
                          np.where(nan, 0, b.view(np.int32)))


def test_buffer_send_receive_cyclic_reuse_matches_reference():
    """Twelve rounds of random sends (masks, delays up to tau = 2) and
    drains through three slots: slots, occupancy, busy and every drained
    message bit for bit the reference's."""
    rng = np.random.default_rng(0)
    n, d = 5, 3
    proto = {"c": np.zeros((n, d), np.float32), "t": np.zeros(n, np.float32)}
    jbuf = jdr.init_buffer({k: jnp.asarray(v) for k, v in proto.items()}, 2)
    tbuf = tdr.init_buffer({k: torch.as_tensor(v) for k, v in proto.items()},
                           2)
    for k in range(12):
        busy_t = tdr.buffer_busy(tbuf)
        np.testing.assert_array_equal(busy_t.numpy(),
                                      np.asarray(jdr.buffer_busy(jbuf)))
        mask = (rng.random(n) < 0.7).astype(np.float32) * (
            1 - busy_t.numpy())
        delays = rng.integers(0, 3, n)
        msgs = {"c": rng.standard_normal((n, d)).astype(np.float32),
                "t": np.full(n, k, np.float32)}
        jbuf = jdr.buffer_send(jbuf, {a: jnp.asarray(v) for a, v in
                                      msgs.items()}, jnp.asarray(mask),
                               jnp.asarray(delays, jnp.int32), k)
        tbuf = tdr.buffer_send(tbuf, {a: torch.as_tensor(v) for a, v in
                                      msgs.items()}, torch.as_tensor(mask),
                               torch.as_tensor(delays), k)
        jbuf, jmsg, jarr = jdr.buffer_receive(jbuf, k)
        tbuf, tmsg, tarr = tdr.buffer_receive(tbuf, k)
        np.testing.assert_array_equal(tarr.numpy(), np.asarray(jarr))
        for name in msgs:
            _same(tmsg[name], jmsg[name])
            _same(tbuf.slots[name], jbuf.slots[name])
        np.testing.assert_array_equal(tbuf.occupied.numpy(),
                                      np.asarray(jbuf.occupied))


def test_buffer_blend_on_negative_zero_and_infinities():
    """The slot write is ``cur * (1 - h) + h * msg``: a stored -0 becomes
    +0 wherever a message passes by, an inf message writes NaN into every
    other slot of its worker, and an inf stored under a new message turns
    it into NaN — as in the reference."""
    n = 4
    slots = np.array([[[-0.0, 1.0], [np.inf, -0.0], [2.0, -np.inf],
                       [-0.0, -0.0]]] * 3, np.float32)        # [S, n, 2]
    occ = np.zeros((3, n), np.float32)
    msg = np.array([[np.inf, -0.0], [5.0, 6.0], [-np.inf, 0.0],
                    [np.nan, -1.0]], np.float32)
    mask = np.array([1, 1, 0, 1], np.float32)
    delays = np.array([0, 1, 2, 0])
    jbuf = jdr.buffer_send(
        jdr.MessageBuffer({"c": jnp.asarray(slots)}, jnp.asarray(occ)),
        {"c": jnp.asarray(msg)}, jnp.asarray(mask),
        jnp.asarray(delays, jnp.int32), 4)
    tbuf = tdr.buffer_send(
        tdr.MessageBuffer({"c": torch.as_tensor(slots)},
                          torch.as_tensor(occ)),
        {"c": torch.as_tensor(msg)}, torch.as_tensor(mask),
        torch.as_tensor(delays), 4)
    _same(tbuf.slots["c"], jbuf.slots["c"])
    got = tbuf.slots["c"].numpy()
    assert np.isnan(got[:, 0, 0]).sum() == 2           # inf beside its slot
    assert not np.signbit(got[:, 3, 0]).any()           # -0 became +0
    np.testing.assert_array_equal(tbuf.occupied.numpy(),
                                  np.asarray(jbuf.occupied))


def test_fedbuff_accumulate_matches_reference():
    """Counts, flushes, resets and (integer-valued, so exact) sums and
    means over a [G] grid of flush thresholds."""
    rng = np.random.default_rng(1)
    G, n, d = 3, 5, 4
    K = np.array([1.0, 3.0, 5.0], np.float32)
    acc = np.zeros((G, d), np.float32)
    acc_n = np.zeros(G, np.float32)
    jacc, jn = jnp.asarray(acc), jnp.asarray(acc_n)
    tacc, tn = torch.as_tensor(acc), torch.as_tensor(acc_n)
    for _ in range(6):
        x = rng.integers(-8, 9, (G, n, d)).astype(np.float32)
        arr = (rng.random((G, n)) < 0.4).astype(np.float32)
        ja, jn2, jm, jf_, jreset = jax.vmap(
            lambda a, c, xx, m, k: jdr.fedbuff_accumulate(a, c, xx, m, k)[
                :4] + (None,), in_axes=(0, 0, 0, 0, 0),
            out_axes=(0, 0, 0, 0, None))(jacc, jn, jnp.asarray(x),
                                         jnp.asarray(arr), jnp.asarray(K))
        ta, tn2, tm, tfl, treset = tdr.fedbuff_accumulate(
            tacc, tn, torch.as_tensor(x), torch.as_tensor(arr),
            torch.as_tensor(K))
        np.testing.assert_array_equal(tn2.numpy(), np.asarray(jn2))
        np.testing.assert_array_equal(tfl.numpy(), np.asarray(jf_))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jf2 = np.asarray(jf_)
        jacc = jnp.where(jf2[:, None], 0.0, ja)
        jn = jnp.where(jf2, 0.0, jn2)
        tacc, tn = treset(ta), treset(tn2)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_run_async_sweep_slot_guard(probs):
    _, tp = probs
    cfg = tf.FlecsConfig(m=1)
    ahp = tf.async_hparam_grid([0, 3], [2.0])
    st = tf.init_async_state(torch.zeros(D), N, 1, 2)
    with pytest.raises(ValueError, match="tau=3"):
        tdr.run_async_sweep(tf.make_flecs_async_sweep_step(
            cfg, *tp.make_oracles()), ahp, st, tr.key(0, "cpu"), 2)


# ---------------------------------------------------------------------------
# One round from a carried state, and whole runs
# ---------------------------------------------------------------------------

def _jhess(jp):
    return lambda w, i: jax.hessian(lambda ww: jp.local_loss(ww, i))(w)


def _makers(method, jp, tp, tau, kind="fixed", **flecs_kw):
    """(reference step, port step, reference initial state, port state
    class) of a legacy async step at exact-k p = 0.5, buffer_k 2."""
    js, ts = (m.StalenessSchedule(kind, tau=tau) for m in (jdr, tdr))
    samp = dict(participation=0.5, sampling="choice")
    jg, tg = jp.make_oracles()[0], tp.make_oracles()[0]
    if method == "flecs":
        cfg = dict(m=2, alpha=0.2, **samp, **flecs_kw)
        return (jf.make_flecs_async_step(jf.FlecsConfig(**cfg),
                                         *jp.make_oracles(), js, 2),
                tf.make_flecs_async_step(tf.FlecsConfig(**cfg),
                                         *tp.make_oracles(), ts, 2),
                jf.init_async_state(jnp.zeros(D), N, 2, tau),
                tf.FlecsAsyncState)
    if method == "diana":
        return (jb.make_diana_async_step(1.0, 0.5, "dither64", jg, js, 2,
                                         **samp),
                tb.make_diana_async_step(1.0, 0.5, "dither64", tg, ts, 2,
                                         **samp),
                jb.init_diana_async(jnp.zeros(D), N, tau),
                tb.DianaAsyncState)
    if method == "fednl":
        return (jb.make_fednl_async_step(0.5, "topk0.25", jg, _jhess(jp),
                                         jp.mu, js, 2, **samp),
                tb.make_fednl_async_step(0.5, "topk0.25", tg,
                                         tp.local_hessian, tp.mu, ts, 2,
                                         **samp),
                jb.init_fednl_async(jnp.zeros(D), N, tau),
                tb.FedNLAsyncState)
    return (jb.make_gd_async_step(1.0, jg, N, js, 2, **samp),
            tb.make_gd_async_step(1.0, tg, N, ts, 2, **samp),
            jb.init_gd_async(jnp.zeros(D), N, tau), tb.GDAsyncState)


EXACT_AUX = ("bits_per_node", "n_active", "n_arrived", "buffered",
             "flushed", "staleness_mean")

ROUND_CASES = {f"{m} tau{tau}": (m, tau, {}) for m in
               ("flecs", "diana", "fednl", "gd") for tau in (0, 2)}
ROUND_CASES["flecs lsr1 tau2"] = ("flecs", 2, dict(hessian_update="lsr1"))
ROUND_CASES["flecs lsr1 tinv tau2"] = ("flecs", 2, dict(
    hessian_update="lsr1", direction="truncated_inverse"))


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_one_round_from_carried_async_state(probs, case):
    """Reference rounds until messages are in flight (tau = 2; seven at
    tau = 0), the state carried into the port, then each package's next
    two rounds from it: the buffer, counts and ledgers exactly, iterates
    and sums under TOL."""
    method, tau, kw = ROUND_CASES[case]
    jp, tp = probs
    jstep, tstep, j0, cls = _makers(method, jp, tp, tau, **kw)
    jstep = jax.jit(jstep)
    key = jax.random.key(11)
    jst = j0
    for k in range(7):          # one compile: the step, not a scan of it
        jst, _ = jstep(jst, jax.random.fold_in(key, 200 + k))
    for k in range(8):
        if not tau or float(np.asarray(jdr.buffer_busy(jst.buf)).sum()):
            break
        jst, _ = jstep(jst, jax.random.fold_in(key, 100 + k))
    assert not tau or float(np.asarray(jdr.buffer_busy(jst.buf)).sum()) > 0
    tst = convert.async_state_from_reference(cls, jax.tree.map(
        np.asarray, jst), "cpu")
    for k in (3, 4):
        kd = jax.random.fold_in(key, k)
        jst, jaux = jstep(jst, kd)
        tst, taux = tstep(tst, convert.key_from_reference(
            jax.random.key_data(kd), "cpu"))
        for name in EXACT_AUX:
            np.testing.assert_array_equal(taux[name].numpy(),
                                          np.asarray(jaux[name]), name)
    np.testing.assert_array_equal(tst.buf.occupied.numpy(),
                                  np.asarray(jst.buf.occupied))
    np.testing.assert_array_equal(tst.buf.slots["t"].numpy(),
                                  np.asarray(jst.buf.slots["t"]))
    assert tst.k == int(jst.k) == tst.t
    for name in cls._fields:
        if name in ("k", "t", "buf", "traffic", "bits_per_node"):
            continue
        a, b = getattr(tst, name).numpy(), np.asarray(getattr(jst, name))
        if name == "H":        # top-k's mirrored ties: the symmetric part
            a, b = a + a.swapaxes(-1, -2), b + b.swapaxes(-1, -2)
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)
    np.testing.assert_array_equal(tst.bits_per_node.numpy(),
                                  np.asarray(jst.bits_per_node))


@pytest.mark.parametrize("method,kind", [("flecs", "fixed"),
                                         ("flecs", "geometric"),
                                         ("diana", "uniform"),
                                         ("fednl", "fixed"),
                                         ("gd", "geometric")])
def test_thirty_rounds_match_reference(probs, method, kind):
    """30 rounds from scratch at tau = 2: every round's ledgers, sends,
    arrivals, buffered counts and flushes exact, F within rtol 1e-4."""
    jp, tp = probs
    jstep, tstep, j0, cls = _makers(method, jp, tp, 2, kind)
    jst, jtr = jdr.run_experiment(jax.jit(jstep), j0, jax.random.key(0), 30,
                                  record=lambda st: jp.metrics(st.w))
    t0 = convert.async_state_from_reference(cls, jax.tree.map(
        np.asarray, j0), "cpu")
    tst, ttr = tdr.run_experiment(tstep, t0, tr.key(0, "cpu"), 30,
                                  record=lambda st: tp.metrics(st.w))
    for name in EXACT_AUX:
        np.testing.assert_array_equal(ttr[name].numpy(),
                                      np.asarray(jtr[name]), name)
    assert float(ttr["n_arrived"].sum()) > 0
    np.testing.assert_allclose(ttr["F"].numpy(), np.asarray(jtr["F"]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# The port's own contracts (the reference's, tests/test_async_aggregation.py)
# ---------------------------------------------------------------------------

def _tau0_pairs(tp, samp):
    tg = tp.make_oracles()[0]
    sched = tdr.StalenessSchedule("fixed", tau=0)
    K = N if not samp else 1
    cfg = tf.FlecsConfig(m=2, **samp)
    lsr1 = tf.FlecsConfig(m=2, hessian_update="lsr1",
                          direction="truncated_inverse", tinv_floor=1e-3,
                          **samp)
    return {
        "flecs": (tf.make_flecs_step(cfg, *tp.make_oracles()),
                  tf.init_state(torch.zeros(D), N),
                  tf.make_flecs_async_step(cfg, *tp.make_oracles(), sched,
                                           K),
                  tf.init_async_state(torch.zeros(D), N, 2, 0)),
        "flecs lsr1 tinv": (
            tf.make_flecs_step(lsr1, *tp.make_oracles()),
            tf.init_state(torch.zeros(D), N),
            tf.make_flecs_async_step(lsr1, *tp.make_oracles(), sched, K),
            tf.init_async_state(torch.zeros(D), N, 2, 0)),
        "diana": (tb.make_diana_step(1.0, 0.5, "dither64", tg, **samp),
                  tb.init_diana(torch.zeros(D), N),
                  tb.make_diana_async_step(1.0, 0.5, "dither64", tg, sched,
                                           K, **samp),
                  tb.init_diana_async(torch.zeros(D), N, 0)),
        "fednl": (tb.make_fednl_step(1.0, "topk0.25", tg, tp.local_hessian,
                                     tp.mu, **samp),
                  tb.init_fednl(torch.zeros(D), N),
                  tb.make_fednl_async_step(1.0, "topk0.25", tg,
                                           tp.local_hessian, tp.mu, sched,
                                           K, **samp),
                  tb.init_fednl_async(torch.zeros(D), N, 0)),
        "gd": (tb.make_gd_step(1.0, tg, N, **samp),
               tb.init_gd(torch.zeros(D), N),
               tb.make_gd_async_step(1.0, tg, N, sched, K, **samp),
               tb.init_gd_async(torch.zeros(D), N, 0)),
    }


@pytest.mark.parametrize("samp", [{}, dict(participation=0.5,
                                           sampling="choice"),
                                  dict(participation=0.3)],
                         ids=["full", "choice", "bernoulli"])
def test_tau0_async_is_the_sync_step_bitwise(probs, samp):
    """tau = 0 with buffer_k = n (full participation) or 1 (sampling):
    every method's async run is its synchronous run bit for bit — the
    state, the ledgers and every aux entry the two share."""
    _, tp = probs
    for name, (sync, s0, asy, a0) in _tau0_pairs(tp, samp).items():
        rec = lambda st: tp.metrics(st.w)                  # noqa: E731
        ss, st_ = tdr.run_experiment(sync, s0, tr.key(2, "cpu"), 12,
                                     record=rec)
        sa, ta = tdr.run_experiment(asy, a0, tr.key(2, "cpu"), 12,
                                    record=rec)
        for field in type(ss)._fields:
            a = getattr(ss, field)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, getattr(sa, field)), (name, field)
        for key in st_:
            assert torch.equal(st_[key], ta[key]), (name, key)


@pytest.mark.parametrize("method", ["FLECS-CGD", "DIANA", "FedNL", "GD"])
def test_legacy_steps_at_tau0_are_their_sync_steps(probs, method):
    """``experiments.legacy_steps`` (the pairs the card checks run): at
    tau = 0 and buffer_k the cohort, each method's async step is its sync
    step bit for bit on the CPU — state, ledgers, every shared aux."""
    from repro_torch import experiments
    _, tp = probs
    (asy, a0), (sync, s0) = experiments.legacy_steps(method, tp, "fixed",
                                                     0, N // 2)
    rec = lambda st: tp.metrics(st.w)                      # noqa: E731
    ss, st_ = tdr.run_experiment(sync, s0, tr.key(1, "cpu"), 12, record=rec)
    sa, ta = tdr.run_experiment(asy, a0, tr.key(1, "cpu"), 12, record=rec)
    for field in type(ss)._fields:
        if isinstance(getattr(ss, field), torch.Tensor):
            assert torch.equal(getattr(ss, field), getattr(sa, field)), field
    for key in st_:
        assert torch.equal(st_[key], ta[key]), key


def test_bits_charged_only_at_arrival_rounds(probs):
    """Fixed tau = 2 at full participation: sends at rounds 0, 3, 6, ...,
    bits billed and a full flush at rounds 2, 5, 8, ...; staleness 2."""
    _, tp = probs
    cfg = tf.FlecsConfig(m=1)
    step = tf.make_flecs_async_step(cfg, *tp.make_oracles(),
                                    tdr.StalenessSchedule("fixed", tau=2), N)
    _, trc = tdr.run_experiment(step, tf.init_async_state(
        torch.zeros(D), N, 1, 2), tr.key(0, "cpu"), 12)
    price = tf.bits_per_round(cfg, D, "cpu")
    inc = np.diff(np.concatenate([np.zeros((1, N)),
                                  trc["bits_per_node"].numpy()]), axis=0)
    for k in range(12):
        np.testing.assert_array_equal(inc[k], price if k % 3 == 2 else 0.0)
        assert trc["n_active"][k] == (N if k % 3 == 0 else 0)
        assert trc["flushed"][k] == (1.0 if k % 3 == 2 else 0.0)
    np.testing.assert_array_equal(trc["staleness_mean"][2::3].numpy(), 2.0)
    assert (trc["buffered"][2::3] == 0).all()


def test_arrivals_conserve_sends(probs):
    """Every message sent arrives exactly once; the ledger is arrivals
    times the round's price."""
    _, tp = probs
    cfg = tf.FlecsConfig(m=1, participation=0.5, sampling="choice")
    step = tf.make_flecs_async_step(cfg, *tp.make_oracles(),
                                    tdr.StalenessSchedule("uniform", tau=3),
                                    2)
    st, trc = tdr.run_experiment(step, tf.init_async_state(
        torch.zeros(D), N, 1, 3), tr.key(4, "cpu"), 40)
    sent = float(trc["n_active"].sum())
    arrived = float(trc["n_arrived"].sum())
    in_flight = float(tdr.buffer_busy(st.buf).sum())
    assert arrived == sent - in_flight and 0 <= in_flight <= N
    assert float(st.bits_per_node.sum()) == arrived * tf.bits_per_round(
        cfg, D, "cpu")


def test_async_sweep_rows_are_standalone_runs(probs):
    """Row g of a batched async grid is the legacy run at point g on
    ``split(key, G)[g]``: ledgers, sends and arrivals exact, F to 1e-6."""
    _, tp = probs
    cfg = tf.FlecsConfig(m=2, participation=0.5, sampling="choice")
    ahp = tf.async_hparam_grid([0, 2], [1.0, 2.0], auto_damp=(0.5, N))
    sweep = tf.make_flecs_async_sweep_step(cfg, *tp.make_oracles())
    st0 = tf.init_async_state(torch.zeros(D), N, 2, 2)
    rec = lambda st: tp.metrics(st.w)                      # noqa: E731
    sts, trs = tdr.run_async_sweep(sweep, ahp, st0, tr.key(0, "cpu"), 15,
                                   record=rec)
    keys = tr.split(tr.key(0, "cpu"), 4)
    for g in range(4):
        step = tdr.specialize(sweep, tf.FlecsAsyncHParams(
            ahp.hp._replace(alpha=float(ahp.hp.alpha[g]), gamma=1.0,
                            beta=1.0,
                            grad_spec=tc.make_spec("dither64"),
                            hess_spec=tc.make_spec("dither64")),
            ahp.tau[g], ahp.buffer_k[g]))
        _, t1 = tdr.run_experiment(step, st0, keys[g], 15, record=rec)
        for name in EXACT_AUX:
            assert torch.equal(trs[name][g], t1[name]), (g, name)
        np.testing.assert_allclose(trs["F"][g].numpy(), t1["F"].numpy(),
                                   rtol=1e-6)


def test_async_grid_rows_match_reference_and_golden():
    """``async_grid`` at the golden's size (``--grids-only --d 16
    --workers 4 --r 16 --iters 6``: 18 async rounds): tau, K, the damped
    alpha, the ledgers and the flushes exact against the reference, F and
    grad_sq to rtol 1e-4; against ``benchmarks/out/golden/async_grid.json``
    the port drifts (rtol 5e-2, its own contract) only where the
    reference as run here does."""
    import importlib.util
    import json
    from pathlib import Path

    from benchmarks import paper_experiments as pe
    from repro_torch import experiments as ex
    from repro_torch.data import logreg as tl
    root = Path(__file__).resolve().parent.parent
    size = dict(d=16, n_workers=4, r=16, mu=1e-3, seed=0)
    want, _ = pe.async_grid(jl.make_problem(**size), iters=18)
    got = ex.async_grid(tl.make_problem(**size, device="cpu"), iters=18)[0]
    want = json.loads(json.dumps(want))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        for key in ("tau", "K", "alpha", "Mbits_mean", "flushes"):
            assert a[key] == b[key], key
        np.testing.assert_allclose([a["F"], a["grad_sq"]],
                                   [b["F"], b["grad_sq"]], rtol=1e-4)
    spec = importlib.util.spec_from_file_location(
        "check_bench_drift", root / "scripts" / "check_bench_drift.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    golden = json.loads((root / "benchmarks/out/golden/async_grid.json")
                        .read_text())

    def drift(rows):
        errors = []
        check._compare("async_grid.json", "", golden, rows, 5e-2, 1e-8,
                       errors)
        return {e.split(":")[0] for e in errors}

    assert drift(got) <= drift(want)


def test_staleness_ablation_row_matches_reference(probs):
    """A cell of ``staleness_ablation`` (geometric delays up to 4, exact-k
    p = 0.5, 20 rounds recorded every 5): the reference's row, computed as
    ``benchmarks/paper_experiments.py`` computes it — ledgers and the
    arrival-weighted staleness exact, F and grad_sq to rtol 1e-4."""
    from repro_torch import experiments as ex
    jp, tp = probs
    got = ex.staleness_ablation(tp, iters=20, cells=(("geometric", 4),),
                                ps=(0.5,))[0]
    cfg = jf.FlecsConfig(m=2, alpha=0.2, grad_compressor="dither64",
                         hess_compressor="dither64", participation=0.5,
                         sampling="choice")
    sched = jdr.StalenessSchedule("geometric", tau=4, q=0.5)
    step = jf.make_flecs_async_step(cfg, *jp.make_oracles(), sched,
                                    buffer_k=1)
    st, trc = jdr.run_experiment(
        step, jf.init_async_state(jnp.zeros(D), N, 2, 4), jax.random.key(0),
        20, record_every=5, record=lambda s: jp.metrics(s.w))
    arr = np.asarray(trc["n_arrived"])
    want = {"kind": "geometric", "tau": 4, "p": 0.5, "K": 1, "alpha": 0.2,
            "Mbits_mean": float(jnp.mean(st.bits_per_node)) / 1e6,
            "staleness_mean": float((np.asarray(trc["staleness_mean"])
                                     * arr).sum() / max(arr.sum(), 1.0))}
    for key, v in want.items():
        assert got[key] == v, key
    np.testing.assert_allclose([got["F"], got["grad_sq"]],
                               [float(trc["F"][-1]),
                                float(trc["grad_sq"][-1])], rtol=1e-4)


def test_async_budget_plan_matches_reference(probs):
    """``plan.bit_budget`` on the async engine: the budgets crossed with
    the async grid (on its inner hparams), the scan length stretched by
    (tau + 1) and tau rounds, the freeze holding the buffers: scan
    lengths, ledgers, arrivals and buffered counts equal to the
    reference's, F to rtol 1e-4."""
    from repro.core import api as japi
    from repro_torch.core import api as tapi
    jp, tp = probs
    kw = dict(iters=10, seed=1, buffer_k=2.0, bit_budget=(4000.0, 9000.0))
    want = japi.run_plan(japi.ExperimentPlan(
        jp, tuple(japi.MethodRun(m) for m in ("diana", "gd")),
        staleness=jdr.StalenessSchedule("fixed", tau=2), **kw))
    got = tapi.run_plan(tapi.ExperimentPlan(
        tp, tuple(tapi.MethodRun(m) for m in ("diana", "gd")),
        staleness=tdr.StalenessSchedule("fixed", tau=2), **kw))
    for lab in want.labels:
        jtr, ttr = want.traces[lab], got.traces[lab]
        assert tuple(ttr["F"].shape) == np.asarray(jtr["F"]).shape
        for key in ("bits_per_node", "n_arrived", "buffered", "flushed"):
            np.testing.assert_array_equal(ttr[key].numpy(),
                                          np.asarray(jtr[key]), key)
        np.testing.assert_allclose(ttr["F"].numpy(), np.asarray(jtr["F"]),
                                   rtol=1e-4)
