"""Cohort-subsampled population engines in the port (FLECS, DIANA, GD over
``VirtualLogReg``) against the reference's, and the port's own equalities.

Exact against the reference: ``cohort_indices``, the cohort-axis masks,
the virtual shards' labels (at these seeds no label sits within an ulp of
its flip), every ``bits_per_node``, ``cohort_bits`` and ``edge_bits``
ledger and the activity counts.  To a stated tolerance: the virtual
features (``random.normal`` is within a few ulps of JAX's; 2e-7 absolute
on values of order 1), the oracles (closed forms against autodiff: 1e-6)
and the runs' w, h and F (1e-4 relative on F).  The reference's K = 64 of
N = 1,024 FLECS-CGD run goes from F = 0.6936 up to 0.7154 in 8 rounds
(its own test of convergence fails); the port reproduces that rise.

The port's own equalities: ``cohort == n_total`` is the dense engine bit
for bit (DIANA and GD: every state leaf and trace, at one grid point and
on a grid, dithered included: ``fold_in(k, id)`` is ``split(k, N)[id]``),
the caller's initial state is never written, and a round's ops are the
same at N = 1,024 and 10,240 but for the N-sized views of the persistent
tables they update in place (analysis rule R7).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import driver as jdr
from repro.core import flecs as jf
from repro.core import hierarchy as jh
from repro.data import logreg as jl
from repro.optim import baselines as jb
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.core import hierarchy as th
from repro_torch.data import logreg as tl
from repro_torch.optim import baselines as tb

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    six parallel processes on a few cores, where eight threads a process
    spend their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_TOTAL, COHORT, D = 1024, 64, 12


def _tkey(jkey):
    return convert.key_from_reference(jax.random.key_data(jkey), "cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _virtual():
    kw = dict(d=D, n_total=N_TOTAL, r=8, probe_clients=8, seed=1)
    return jl.make_virtual_problem(**kw), tl.make_virtual_problem(
        **kw, device="cpu")


# ---------------------------------------------------------------------------
# selection and participation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_total,cohort", [(1024, 64), (100_000, 100),
                                            (8, 8), (102_400, 20)])
def test_cohort_indices_match_reference(n_total, cohort):
    for seed in (0, 7):
        key = jax.random.key(seed)
        want = np.asarray(jdr.cohort_indices(key, n_total, cohort))
        got = _np(tdr.cohort_indices(_tkey(key), n_total, cohort))
        np.testing.assert_array_equal(got, want)
        stride = n_total // cohort
        assert np.all(got // stride == np.arange(cohort))     # one a stratum
    keys = jax.random.split(jax.random.key(3), 3)
    batched = _np(tdr.cohort_indices(_tkey(keys), n_total, cohort))
    for g in range(3):
        np.testing.assert_array_equal(
            batched[g], np.asarray(jdr.cohort_indices(keys[g], n_total,
                                                      cohort)))


def test_cohort_indices_guards():
    key = tr.key(0, "cpu")
    np.testing.assert_array_equal(_np(tdr.cohort_indices(key, 8, 8)),
                                  np.arange(8))
    with pytest.raises(ValueError, match="cohort"):
        tdr.cohort_indices(key, 8, 0)
    with pytest.raises(ValueError, match="cohort"):
        tdr.cohort_indices(key, 8, 16)
    with pytest.raises(ValueError, match="divide"):
        tdr.cohort_indices(key, 10, 4)


@pytest.mark.parametrize("kind,p", [("bernoulli", 0.5), ("choice", 0.25),
                                    ("bernoulli", 1.0)])
def test_cohort_axis_mask_matches_reference(kind, p):
    key = jax.random.key(5)
    for n, cohort in ((100_000, 64), (64, 64), (1024, 16)):
        want = np.asarray(jdr.participation_mask(key, n, p, kind,
                                                 cohort=cohort))
        got = _np(tdr.participation_mask(_tkey(key), n, p, kind,
                                         cohort=cohort))
        assert got.shape == (cohort,)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(tdr.participation_mask(_tkey(key), 64, p, kind, cohort=64)),
        _np(tdr.participation_mask(_tkey(key), 64, p, kind)))
    if kind == "bernoulli" and p < 1:
        hp_p = torch.tensor([0.5, 0.25])
        keys = jax.random.split(key, 2)
        got = _np(tdr.resolve_participation(_tkey(keys), 100_000, 1.0, kind,
                                            hp_p, cohort=32))
        for g in range(2):
            np.testing.assert_array_equal(
                got[g], np.asarray(jdr.resolve_participation(
                    keys[g], 100_000, 1.0, kind, jnp.float32(hp_p[g]),
                    cohort=32)))


def test_degenerate_cohort_rates_rejected():
    key = tr.key(5, "cpu")
    with pytest.raises(ValueError, match="p\\*n"):
        tdr.participation_mask(key, 100_000, 1e-6)
    with pytest.raises(ValueError, match="p\\*n"):
        tdr.participation_mask(key, 100_000, 1e-6, cohort=64)


# ---------------------------------------------------------------------------
# the virtual population problem
# ---------------------------------------------------------------------------

def test_virtual_shards_match_reference():
    jp, tp = _virtual()
    np.testing.assert_array_equal(_np(tp.w_true), np.asarray(jp.w_true))
    ids = [0, 5, 17, 511, 1023]
    shard = jax.jit(jax.vmap(jp._shard))
    jA, jb_ = shard(jnp.asarray(ids, jnp.int32))
    tA, tb_ = tp.shards(torch.as_tensor(ids))
    np.testing.assert_allclose(_np(tA), np.asarray(jA), rtol=0, atol=2e-7)
    np.testing.assert_array_equal(_np(tb_), np.asarray(jb_))
    np.testing.assert_array_equal(_np(tp.probe_ids), np.asarray(jp.probe_ids))


def test_virtual_oracles_and_probe_match_reference():
    jp, tp = _virtual()
    jlg, jlh = jp.make_oracles()
    tlg, tlh = tp.make_oracles()
    w = np.random.default_rng(0).normal(size=(2, D)).astype(np.float32)
    S = np.random.default_rng(1).normal(size=(D, 2)).astype(np.float32)
    ids = np.asarray([[3, 900, 17], [4, 5, 1000]])
    key = jax.random.key(0)
    @jax.jit
    def reference(w, S, ids):
        g = jax.vmap(jax.vmap(jlg, (None, 0, None)), (0, 0, None))(w, ids,
                                                                   key)
        y = jax.vmap(jax.vmap(jlh, (None, None, 0, None)),
                     (0, None, 0, None))(w, S, ids, key)
        return g, y, jax.vmap(jp.metrics)(w)

    jg, jy, jm = reference(jnp.asarray(w), jnp.asarray(S),
                           jnp.asarray(ids, jnp.int32))
    tg = tlg(torch.as_tensor(w), ids=torch.as_tensor(ids))
    ty = tlh(torch.as_tensor(w), torch.as_tensor(S),
             ids=torch.as_tensor(ids))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    tm = tp.metrics(torch.as_tensor(w))
    for k in ("F", "grad_sq"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5)


def test_virtual_problem_contract():
    _, tp = _virtual()
    lg, _ = tp.make_oracles()
    w = torch.zeros(1, D)
    g1 = lg(w, ids=torch.tensor([17]))
    assert torch.equal(g1, lg(w, ids=torch.tensor([17])))
    assert not torch.equal(g1, lg(w, ids=torch.tensor([18])))
    assert set(tp.metrics(torch.zeros(D))) == {"F", "grad_sq"}
    ids = _np(tp.probe_ids)
    assert ids.shape == (8,) and len(set(ids.tolist())) == 8
    assert ids.max() < tp.n_workers
    with pytest.raises(ValueError, match="batch"):
        tp.make_oracles(batch=4)
    with pytest.raises(ValueError, match="probe_clients"):
        tl.make_virtual_problem(d=4, n_total=8, probe_clients=9,
                                device="cpu")


# ---------------------------------------------------------------------------
# the cohort engines against the reference's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cohort_runs(method: str):
    """The reference's and the port's cohort run of ``method`` at K = 64
    of N = 1,024 on the virtual problem, one grid point, one key."""
    jp, tp = _virtual()
    jlg, jlh = jp.make_oracles()
    tlg, tlh = tp.make_oracles()
    key = jax.random.key(3)
    iters = 8
    if method.startswith("flecs"):
        hier = method == "flecs_hier"
        jcfg = jf.FlecsConfig(m=2, participation=0.5, hierarchy=(
            jh.HierarchyConfig(8, "dither64") if hier else None))
        tcfg = tf.FlecsConfig(m=2, participation=0.5, hierarchy=(
            th.HierarchyConfig(8, "dither64") if hier else None))
        E = 8 if hier else None
        jstep = jf.make_flecs_cohort_sweep_step(jcfg, jlg, jlh, N_TOTAL,
                                                COHORT)
        tstep = tf.make_flecs_cohort_sweep_step(tcfg, tlg, tlh, N_TOTAL,
                                                COHORT)
        jst = jf.init_cohort_state(jnp.zeros(D), N_TOTAL, n_edges=E)
        tst = tf.init_cohort_state(torch.zeros(D), N_TOTAL, n_edges=E)
        jhp, thp = jf.hparams_from_config(jcfg), tf.hparams_from_config(tcfg)
        if hier:
            iters = 4
    elif method == "diana":
        jcfg = jb.DianaConfig(participation=0.5)
        tcfg = tb.DianaConfig(participation=0.5)
        jstep = jb.make_diana_cohort_sweep_step(jcfg, jlg, N_TOTAL, COHORT)
        tstep = tb.make_diana_cohort_sweep_step(tcfg, tlg, N_TOTAL, COHORT)
        jst, tst = (jb.init_diana(jnp.zeros(D), N_TOTAL),
                    tb.init_diana(torch.zeros(D), N_TOTAL))
        jhp = jb.diana_hparams_from_config(jcfg)
        thp = tb.diana_hparams_from_config(tcfg)
    else:
        jcfg, tcfg = jb.GDConfig(participation=0.5), tb.GDConfig(
            participation=0.5)
        jstep = jb.make_gd_cohort_sweep_step(jcfg, jlg, N_TOTAL, COHORT)
        tstep = tb.make_gd_cohort_sweep_step(tcfg, tlg, N_TOTAL, COHORT)
        jst, tst = (jb.init_gd(jnp.zeros(D), N_TOTAL),
                    tb.init_gd(torch.zeros(D), N_TOTAL))
        jhp = jb.gd_hparams_from_config(jcfg)
        thp = tb.gd_hparams_from_config(tcfg)
    if method == "flecs":
        # the reference's own test's run: its sweep engine, a [1] grid
        jhp = jax.tree.map(lambda a: jnp.asarray(a)[None], jhp)
        js, jt = jdr.run_sweep(jstep, jhp, jst, key, iters,
                               record=lambda s: jp.metrics(s.w))
        ts, tt = tdr.run_sweep(tstep, tdr.grid1(thp), tst, _tkey(key),
                               iters, record=lambda s: tp.metrics(s.w))
        return (js, jt), (ts, tt), tst
    # the legacy steps (the point's specs static: a smaller program)
    js, jt = jdr.run_experiment(lambda s, k: jstep(jhp, s, k), jst, key,
                                iters, record=lambda s: jp.metrics(s.w))
    ts, tt = tdr.run_experiment(tdr.specialize(tstep, thp), tst, _tkey(key),
                                iters, record=lambda s: tp.metrics(s.w))
    return ((js, jt), (ts, tt), tst)


COHORT_METHODS = ("flecs", "flecs_hier", "diana", "gd")


@pytest.mark.parametrize("method", COHORT_METHODS)
def test_cohort_engine_matches_reference(method):
    (js, jt), (ts, tt), tst = _cohort_runs(method)
    np.testing.assert_array_equal(_np(ts.bits_per_node),
                                  np.asarray(js.bits_per_node))
    for name in ("cohort_bits", "n_active"):
        np.testing.assert_array_equal(_np(tt[name]), np.asarray(jt[name]))
    if method == "flecs_hier":
        np.testing.assert_array_equal(_np(ts.edge_bits),
                                      np.asarray(js.edge_bits))
        np.testing.assert_array_equal(_np(tt["edge_bits"]),
                                      np.asarray(jt["edge_bits"]))
    np.testing.assert_allclose(_np(tt["F"]), np.asarray(jt["F"]), rtol=1e-4)
    np.testing.assert_allclose(_np(ts.w), np.asarray(js.w), rtol=1e-3,
                               atol=1e-5)
    if hasattr(ts, "h"):
        np.testing.assert_allclose(_np(ts.h), np.asarray(js.h), rtol=1e-3,
                                   atol=1e-5)
    # the caller's initial state is never written
    assert not torch.any(tst.bits_per_node) and not torch.any(tst.w)
    if hasattr(tst, "h"):
        assert not torch.any(tst.h)


def test_flecs_cohort_reproduces_the_reference_rise():
    """The reference's own K = 64 of N = 1,024 run does not converge in 8
    rounds (F 0.6936 -> 0.7154): the port shows the same rise, and bills
    exactly what the aux stream says, to at most cohort x iters clients."""
    (js, jt), (ts, tt), _ = _cohort_runs("flecs")
    F, Fj = _np(tt["F"][0]), np.asarray(jt["F"][0])
    assert F[-1] > F[0] and Fj[-1] > Fj[0]
    np.testing.assert_allclose(F[[0, -1]], [0.6936487, 0.715427], rtol=1e-5)
    assert tuple(ts.B.shape) == (1, D, D)                  # SHARED curvature
    bits = _np(ts.bits_per_node[0])
    assert bits.shape == (N_TOTAL,)
    assert bits.sum() == _np(tt["cohort_bits"][0]).sum()
    assert 0 < (bits > 0).sum() <= COHORT * 8
    assert ts.edge_bits is None


def test_cohort_state_carries_over_from_reference():
    """The reference's carried cohort state in the port
    (``convert.cohort_state_from_reference``): every leaf; one more round
    from it bills the cohort's clients their price on top of it and
    leaves the caller's state as it was."""
    (js, _), _, _ = _cohort_runs("flecs_hier")
    _, tp = _virtual()
    st = convert.cohort_state_from_reference(
        *(np.asarray(getattr(js, f)) for f in ("w", "h", "B", "k",
                                                "bits_per_node")),
        edge_bits=np.asarray(js.edge_bits), device="cpu")
    assert st.k == 4 and tuple(st.B.shape) == (D, D)
    for name in ("w", "h", "B", "bits_per_node", "edge_bits"):
        np.testing.assert_array_equal(_np(getattr(st, name)),
                                      np.asarray(getattr(js, name)))
    cfg = tf.FlecsConfig(m=2, participation=0.5,
                         hierarchy=th.HierarchyConfig(8, "dither64"))
    step = tdr.specialize(tf.make_flecs_cohort_sweep_step(
        cfg, *tp.make_oracles(), N_TOTAL, COHORT),
        tf.hparams_from_config(cfg))
    new, tr_ = tdr.run_experiment(step, st, tr.key(21, "cpu"), 1)
    added = _np(new.bits_per_node) - np.asarray(js.bits_per_node)
    assert added.sum() == float(tr_["cohort_bits"][0])
    np.testing.assert_array_equal(_np(st.bits_per_node),
                                  np.asarray(js.bits_per_node))


# ---------------------------------------------------------------------------
# the port's own equalities
# ---------------------------------------------------------------------------

def _dense_problem():
    return tl.make_problem(d=D, n_workers=8, r=8, mu=1e-3, seed=0,
                           device="cpu")


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)
               if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("compressor,alphas", [
    ("identity", (1.0,)), ("dither64", (1.0,)), ("dither64", (1.0, 0.5))])
def test_diana_full_cohort_is_the_dense_engine(compressor, alphas):
    tp = _dense_problem()
    lg = tp.make_oracles()[0]
    cfg = tb.DianaConfig(participation=0.6, compressor=compressor)
    hp = (tdr.grid1(tb.diana_hparams_from_config(cfg)) if len(alphas) == 1
          else tb.diana_hparam_grid(alphas))
    st0 = tb.init_diana(torch.zeros(D), 8)
    key = tr.key(0, "cpu")
    rec = lambda s: tp.metrics(s.w)                           # noqa: E731
    ds, dtr = tdr.run_sweep(tb.make_diana_sweep_step(cfg, lg), hp, st0, key,
                            6, record=rec)
    cs, ctr = tdr.run_sweep(tb.make_diana_cohort_sweep_step(cfg, lg, 8, 8),
                            hp, st0, key, 6, record=rec)
    assert _leaves_equal(ds, cs)
    for name in ("F", "grad_sq", "g_tilde_norm", "n_active"):
        assert torch.equal(dtr[name], ctr[name]), name


@pytest.mark.parametrize("alphas", [(1.0,), (1.0, 2.0)])
def test_gd_full_cohort_is_the_dense_engine(alphas):
    tp = _dense_problem()
    lg = tp.make_oracles()[0]
    cfg = tb.GDConfig(participation=0.75)
    hp = tb.gd_hparam_grid(alphas)
    st0 = tb.init_gd(torch.zeros(D), 8)
    key = tr.key(2, "cpu")
    ds, dtr = tdr.run_sweep(tb.make_gd_sweep_step(cfg, lg, 8), hp, st0, key,
                            5)
    cs, ctr = tdr.run_sweep(tb.make_gd_cohort_sweep_step(cfg, lg, 8, 8), hp,
                            st0, key, 5)
    assert _leaves_equal(ds, cs)
    assert torch.equal(dtr["n_active"], ctr["n_active"])


def test_flecs_full_cohort_draws_the_dense_masks_and_bills_alike():
    """FLECS's cohort engine keeps one shared curvature (the population
    variant), so its iterates are not the dense engine's; at cohort ==
    n_total its masks and ledgers are."""
    tp = _dense_problem()
    lg, lh = tp.make_oracles()
    cfg = tf.FlecsConfig(m=2, participation=0.6)
    hp = tf.hparam_grid((1.0, 0.5), (1.0,), (64.0,))
    key = tr.key(1, "cpu")
    ds, dtr = tdr.run_sweep(tf.make_flecs_sweep_step(cfg, lg, lh), hp,
                            tf.init_state(torch.zeros(D), 8), key, 4)
    cs, ctr = tdr.run_sweep(tf.make_flecs_cohort_sweep_step(cfg, lg, lh, 8,
                                                            8), hp,
                            tf.init_cohort_state(torch.zeros(D), 8), key, 4)
    assert torch.equal(ds.bits_per_node, cs.bits_per_node)
    assert torch.equal(dtr["n_active"], ctr["n_active"])
    assert torch.equal(dtr["bits_per_node"][:, -1].sum(-1),
                       ctr["cohort_bits"].sum(-1))


def test_cohort_engine_guards():
    _, tp = _virtual()
    lg, lh = tp.make_oracles()
    with pytest.raises(ValueError, match="direct"):
        tf.make_flecs_cohort_sweep_step(
            tf.FlecsConfig(m=2, hessian_update="lsr1"), lg, lh, 1024, 64)
    cfg = tf.FlecsConfig(m=2)
    with pytest.raises(ValueError, match="divide"):
        tf.make_flecs_cohort_sweep_step(cfg, lg, lh, 1000, 64)
    with pytest.raises(ValueError, match="cohort"):
        tf.make_flecs_cohort_sweep_step(cfg, lg, lh, 64, 128)
    with pytest.raises(ValueError, match="divide"):
        tb.make_diana_cohort_sweep_step(tb.DianaConfig(), lg, 1000, 64)
    with pytest.raises(ValueError, match="divide"):
        tb.make_gd_cohort_sweep_step(tb.GDConfig(), lg, 1000, 64)
    step = tb.make_gd_cohort_sweep_step(tb.GDConfig(), lg, 1024, 64)
    hp = tb.gd_hparam_grid((1.0,))._replace(bit_budget=torch.tensor([1e4]))
    with pytest.raises(ValueError, match="bit budget"):
        tdr.run_sweep(step, hp, tb.init_gd(torch.zeros(D), 1024),
                      tr.key(0, "cpu"), 2)


# ---------------------------------------------------------------------------
# analysis rule R7: a round's memory does not depend on N
# ---------------------------------------------------------------------------

class _Shapes(TorchDispatchMode):
    """Every op's output shapes and bytes, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor):
                self.ops.append((str(func), tuple(o.shape),
                                 o.numel() * o.element_size()))
        return out


def _round_ops(n_total: int):
    tp = tl.make_virtual_problem(d=D, n_total=n_total, r=8, probe_clients=8,
                                 seed=1, device="cpu")
    cfg = tf.FlecsConfig(m=2, participation=0.5,
                         hierarchy=th.HierarchyConfig(8, "dither64"))
    step = tf.make_flecs_cohort_sweep_step(cfg, *tp.make_oracles(),
                                           n_total, COHORT)
    hp = tdr.hparams_to(tdr.grid1(tf.hparams_from_config(cfg)), "cpu")
    st = tdr.batch_state(tf.init_cohort_state(torch.zeros(D), n_total,
                                              n_edges=8), 1, copy=True)
    keys = tr.split(tr.key(3, "cpu"), 1)
    with _Shapes() as rec:
        step(hp, st, keys)
    return rec.ops


def test_cohort_round_is_n_independent():
    """The port's counterpart of the reference's jaxpr walk
    (``benchmarks/scaling_bench.py``): one hierarchical cohort round at
    N = 1,024 and 10,240 runs the same ops; those with an N-sized
    dimension (views of the persistent tables and their in-place adds) are
    as many at both N, and every other output has the same bytes."""
    small, large = _round_ops(1024), _round_ops(10_240)
    assert len(small) == len(large)

    def split(ops, n):
        big = [n in shape or n * D in shape for _, shape, _ in ops]
        return ([op for op, b in zip(ops, big) if b],
                [(f, nbytes) for (f, _, nbytes), b in zip(ops, big) if not b])

    big_s, rest_s = split(small, 1024)
    big_l, rest_l = split(large, 10_240)
    assert len(big_s) == len(big_l) > 0
    assert rest_s == rest_l
    # the N-sized outputs are the in-place adds and views of the tables
    kinds = {f for f, _, _ in big_l}
    assert all("index_add" in f or "view" in f for f in kinds), kinds
