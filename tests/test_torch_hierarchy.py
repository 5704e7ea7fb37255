"""Two-tier hierarchical aggregation in the port
(``repro_torch.core.hierarchy``, the hierarchical FLECS round) against the
reference's (``repro.core.hierarchy``), and the reference's own contracts
(tests/test_hierarchy.py) held on the port.

Exact: ``edge_of``, the ledgers (``edge_round_bits``, ``charge_edges``,
every ``edge_bits`` and ``bits_per_node``) and the activity counts.  The
sums: within 1e-6 (the port sums in float64 and rounds once, XLA in
float32), exact on integer-valued payloads, where every order gives the
same sum and so the same dithered values.  Runs: F within rtol 1e-5 (the
identity edge against the flat server, the reference's own contract) and
within 1e-4 of the reference (its float32 sums, and the closed-form
oracles against autodiff).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jc
from repro.core import driver as jdr
from repro.core import flecs as jf
from repro.core import hierarchy as jh
from repro.data import logreg as jl
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import api as tapi
from repro_torch.core import compressors as tc
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.core import hierarchy as th

D, N, E = 12, 8, 4


@functools.lru_cache(maxsize=None)
def _problems():
    j = jl.make_problem(d=D, n_workers=N, r=8, mu=1e-3, seed=0)
    t = convert.problem_from_reference(np.asarray(j.A), np.asarray(j.b),
                                       j.mu, device="cpu")
    return j, t


def _tkey(jkey):
    return convert.key_from_reference(jax.random.key_data(jkey), "cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _identity_edge_hp(hp):
    G = hp.alpha.shape[0]
    return hp._replace(edge_spec=tc.as_grid(tc.make_spec("identity"), G))


def _run(cfg, hp, iters, seed, record=True, n_edges=E):
    _, tp = _problems()
    lg, lh = tp.make_oracles()
    return tdr.run_sweep(
        tf.make_flecs_sweep_step(cfg, lg, lh), hp,
        tf.init_state(torch.zeros(D), N, n_edges=n_edges),
        tr.key(seed, "cpu"), iters,
        record=(lambda s: tp.metrics(s.w)) if record else None)


# ---------------------------------------------------------------------------
# module functions against the reference's
# ---------------------------------------------------------------------------

def test_edge_of_and_ledgers_match_reference():
    ids = np.arange(64)
    np.testing.assert_array_equal(
        _np(th.edge_of(torch.as_tensor(ids), 64, 8)),
        np.asarray(jh.edge_of(jnp.asarray(ids), 64, 8)))
    np.testing.assert_array_equal(_np(th.edge_of(torch.arange(8), 8, 4)),
                                  [0, 0, 1, 1, 2, 2, 3, 3])
    assert th.init_edge_bits(3).dtype == tdr.bits_dtype()
    active = np.asarray([0.0, 2.0, 1.0], np.float32)
    led = th.charge_edges(th.init_edge_bits(3), torch.as_tensor(active),
                          10.0)
    np.testing.assert_array_equal(
        _np(led), np.asarray(jh.charge_edges(jh.init_edge_bits(3),
                                             jnp.asarray(active), 10.0)))


@pytest.mark.parametrize("name", ["identity", "dither8", "dither64",
                                  "natural", "topk0.25", "count_sketch16",
                                  "minmax0.5"])
def test_edge_round_bits_exact(name):
    for d, m in ((D, 2), (123, 4), (5000, 4)):
        want = float(jax.jit(jh.edge_round_bits, static_argnums=(1, 2))(
            jc.make_spec(name), d, m))
        got = th.edge_round_bits(tc.make_spec(name), d, m, "cpu")
        assert float(got) == want, (name, d, m)
    grid = tc.stack_specs(name, "dither64")
    np.testing.assert_array_equal(
        _np(th.edge_round_bits(grid, D, 2)),
        [float(jh.edge_round_bits(jc.make_spec(n), D, 2))
         for n in (name, "dither64")])


_MASK = np.asarray([1, 1, 0, 0, 1, 0, 1, 1], np.float32)
_SUB = np.asarray([0, 1, 6, 7])
COMBINE_NAMES = ("identity", "dither64", "topk0.5", "count_sketch16",
                 "natural")


@functools.lru_cache(maxsize=None)
def _reference_combines():
    """The reference's ``edge_combine`` and ``edge_combine_cohort`` of one
    integer-valued payload under each of COMBINE_NAMES (one jitted vmap
    over the stacked specs: its ``lax.cond`` takes each point's family)."""
    x = np.random.default_rng(1).integers(-8, 8, (N, 5, 2)).astype(
        np.float32)
    key = jax.random.key(3)

    def both(spec):
        full = jh.edge_combine(spec, key, jnp.asarray(x), jnp.asarray(_MASK),
                               E)
        coh = jh.edge_combine_cohort(spec, key, jnp.asarray(x[_SUB]),
                                     jnp.asarray(_MASK[_SUB]),
                                     jnp.asarray(_SUB), N, E)
        return full, coh

    out = jax.jit(jax.vmap(both))(jc.stack_specs(*COMBINE_NAMES))
    return x, key, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("g", range(len(COMBINE_NAMES)),
                         ids=list(COMBINE_NAMES))
def test_edge_combine_matches_reference(g):
    """Integer-valued payloads: every order of the sums gives the same
    value, so the edge messages are the reference's (the dither's and the
    natural family's draws are its own): 1e-6."""
    name = COMBINE_NAMES[g]
    x, key, ((want, want_act), (want_c, want_ca)) = _reference_combines()
    want, want_act, want_c, want_ca = (a[g] for a in (want, want_act,
                                                      want_c, want_ca))
    got, got_act = th.edge_combine(tc.make_spec(name), _tkey(key),
                                   torch.as_tensor(x), torch.as_tensor(_MASK),
                                   E)
    np.testing.assert_array_equal(_np(got_act), np.asarray(want_act))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    got_c, got_ca = th.edge_combine_cohort(
        tc.make_spec(name), _tkey(key), torch.as_tensor(x[_SUB]),
        torch.as_tensor(_MASK[_SUB]), torch.as_tensor(_SUB), N, E)
    np.testing.assert_array_equal(_np(got_ca), np.asarray(want_ca))
    np.testing.assert_allclose(_np(got_c), np.asarray(want_c), rtol=1e-6,
                               atol=1e-6)


def test_edge_combine_grid_mixes_families():
    """A [3] grid (identity, dither64, count_sketch16) combines each point
    as its scalar spec does."""
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(3, N, 6))
                        .astype(np.float32))
    mask = torch.as_tensor(np.tile(_MASK, (3, 1)))
    keys = tr.split(tr.key(5, "cpu"), 3)
    names = ("identity", "dither64", "count_sketch16")
    total, act = th.edge_combine(tc.stack_specs(*names), keys, x, mask, E)
    for g, name in enumerate(names):
        t1, a1 = th.edge_combine(tc.make_spec(name), keys[g], x[g], mask[g],
                                 E)
        assert torch.equal(total[g], t1), name
        assert torch.equal(act[g], a1)


# ---------------------------------------------------------------------------
# the reference's contracts, on the port
# ---------------------------------------------------------------------------

def test_identity_edge_collapses_to_flat_server():
    hp = tf.hparam_grid((1.0, 0.5), (1.0,), (64.0,))
    fs_f, tr_f = _run(tf.FlecsConfig(m=2, participation=0.6), hp, 6, 0,
                      n_edges=None)
    cfg_h = tf.FlecsConfig(m=2, participation=0.6,
                           hierarchy=th.HierarchyConfig(n_edges=E))
    fs_h, tr_h = _run(cfg_h, _identity_edge_hp(hp), 6, 0)
    np.testing.assert_allclose(_np(tr_h["F"]), _np(tr_f["F"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(fs_h.w), _np(fs_f.w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(fs_h.bits_per_node),
                                  _np(fs_f.bits_per_node))
    assert fs_f.edge_bits is None and fs_h.edge_bits is not None


def test_edge_ledger_arithmetic_exact_full_participation():
    m, iters = 2, 5
    cfg = tf.FlecsConfig(m=m, hierarchy=th.HierarchyConfig(n_edges=E))
    hp = _identity_edge_hp(tf.hparam_grid((1.0,), (1.0,), (64.0,)))
    fs, trc = _run(cfg, hp, iters, 1, record=False)
    price = float(th.edge_round_bits(tc.make_spec("identity"), D, m, "cpu"))
    assert price == 32.0 * (D + D * m + m * m)
    np.testing.assert_array_equal(_np(fs.edge_bits),
                                  np.full((1, E), iters * price))
    assert tuple(trc["edge_bits"].shape) == (1, iters, E)
    assert trc["edge_bits"].dtype == tdr.bits_dtype()


def test_idle_edges_ship_nothing_and_pay_nothing():
    x = torch.arange(8.0).reshape(8, 1) + 1.0
    mask = torch.as_tensor([1.0, 1.0, 0.0, 0.0, 1.0, 0.0, 1.0, 1.0])
    spec = tc.make_spec("dither64")
    total, active = th.edge_combine(spec, tr.key(2, "cpu"), x, mask, 4)
    np.testing.assert_array_equal(_np(active), [2.0, 0.0, 1.0, 2.0])
    x2 = x.clone()
    x2[2:4] = 1e6
    total2, _ = th.edge_combine(spec, tr.key(2, "cpu"), x2, mask, 4)
    assert torch.equal(total, total2)


def test_identity_edge_combine_matches_masked_mean():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 5))
                        .astype(np.float32))
    mask = torch.as_tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0])
    total, _ = th.edge_combine(tc.make_spec("identity"), tr.key(0, "cpu"),
                               x, mask, 4)
    want = tdr.masked_mean(x, mask) * torch.clamp(mask.sum(), min=1.0)
    np.testing.assert_allclose(_np(total), _np(want), rtol=1e-6, atol=1e-6)


def test_cohort_combine_matches_full_axis():
    x = torch.as_tensor(np.random.default_rng(1).integers(-8, 8, (8, 3))
                        .astype(np.float32))
    mask = torch.as_tensor([1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    spec = tc.make_spec("identity")
    key = tr.key(3, "cpu")
    full, act_full = th.edge_combine(spec, key, x, mask, 4)
    coh, act_coh = th.edge_combine_cohort(spec, key, x, mask,
                                          torch.arange(8), 8, 4)
    assert torch.equal(full, coh) and torch.equal(act_full, act_coh)
    sub = torch.as_tensor([0, 1, 6, 7])
    _, act_sub = th.edge_combine_cohort(spec, key, x[sub], mask[sub], sub,
                                        8, 4)
    np.testing.assert_array_equal(_np(act_sub), [2.0, 0.0, 0.0, 2.0])


def test_edge_levels_traced_axis_prices_per_point():
    m, iters = 2, 4
    cfg = tf.FlecsConfig(m=m, hierarchy=th.HierarchyConfig(n_edges=E))
    hp = tf.hparam_grid((1.0,), (1.0,), (64.0,), edge_levels=(8.0, 64.0))
    jhp = jf.hparam_grid((1.0,), (1.0,), (64.0,), edge_levels=(8.0, 64.0))
    assert tuple(hp.alpha.shape) == (2,)
    np.testing.assert_array_equal(_np(hp.edge_spec.s),
                                  np.asarray(jhp.edge_spec.s))
    fs, _ = _run(cfg, hp, iters, 4, record=False)
    bits = _np(fs.edge_bits)
    for g, level in enumerate((8.0, 64.0)):
        price = float(jh.edge_round_bits(
            jc.make_spec(f"dither{int(level)}"), D, m))
        np.testing.assert_array_equal(bits[g], np.full(E, iters * price))
    assert bits[0, 0] < bits[1, 0]


def test_hparam_grid_edge_axis_is_base_major():
    hp = tf.hparam_grid((1.0, 0.5), (1.0,), (16.0, 64.0),
                        edge_levels=(8.0, 32.0, 64.0))
    jhp = jf.hparam_grid((1.0, 0.5), (1.0,), (16.0, 64.0),
                         edge_levels=(8.0, 32.0, 64.0))
    for name in ("alpha", "gamma", "beta"):
        np.testing.assert_array_equal(_np(getattr(hp, name)),
                                      np.asarray(getattr(jhp, name)))
    for name in ("grad_spec", "hess_spec", "edge_spec"):
        np.testing.assert_array_equal(_np(getattr(hp, name).s),
                                      np.asarray(getattr(jhp, name).s))
    api_hp = tapi.get_method("flecs_cgd").grid(
        grad_specs=tc.stack_specs("identity", "dither64"),
        edge_levels=(8.0, 64.0))
    assert api_hp.grad_spec.family == (0, 0, 1, 1)
    np.testing.assert_array_equal(_np(api_hp.edge_spec.s),
                                  [8.0, 64.0, 8.0, 64.0])


def test_plan_runs_hierarchy():
    _, tp = _problems()
    cfg = tf.FlecsConfig(m=2, hierarchy=th.HierarchyConfig(
        n_edges=4, edge_compressor="dither64"))
    res = tapi.run_plan(tapi.ExperimentPlan(
        problem=tp, runs=(tapi.MethodRun("flecs_cgd", cfg=cfg),), iters=4))
    price = float(jh.edge_round_bits(jc.make_spec("dither64"), D, cfg.m))
    np.testing.assert_array_equal(_np(res.states["flecs_cgd"].edge_bits),
                                  np.full((1, 4), 4 * price))


def test_spec_commutes_with_sum_by_family():
    assert bool(tc.spec_commutes_with_sum(tc.make_spec("identity")))
    assert bool(tc.spec_commutes_with_sum(tc.make_spec("count_sketch64")))
    for name in ("dither64", "natural", "topk0.25", "minmax0.25"):
        assert not bool(tc.spec_commutes_with_sum(tc.make_spec(name))), name


def test_count_sketch_edge_combine_equals_flat_compress():
    spec = tc.make_spec("count_sketch", width=16, depth=3)
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(8, 10))
                        .astype(np.float32))
    mask = torch.as_tensor([1.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    key = tr.key(9, "cpu")
    total, _ = th.edge_combine(spec, key, x, mask, 4)
    flat = tc.compress(spec, key[None], (mask[:, None] * x).sum(0)[None])[0]
    np.testing.assert_allclose(_np(total), _np(flat), rtol=1e-5, atol=1e-6)
    mask_idle = mask.clone()
    mask_idle[4] = 0.0
    x2 = x.clone()
    x2[4:6] = 1e6
    x2[4] = -3.0
    t1, act = th.edge_combine(spec, key, x, mask_idle, 4)
    t2, _ = th.edge_combine(spec, key, x2, mask_idle, 4)
    assert float(act[2]) == 0.0 and torch.equal(t1, t2)


def test_count_sketch_edge_plan_bit_ledger_exact():
    _, tp = _problems()
    cfg = tf.FlecsConfig(m=2, hierarchy=th.HierarchyConfig(
        n_edges=4, edge_compressor="count_sketch16"))
    res = tapi.run_plan(tapi.ExperimentPlan(
        problem=tp, runs=(tapi.MethodRun("flecs_cgd", cfg=cfg),), iters=4))
    price = float(jh.edge_round_bits(jc.make_spec("count_sketch16"), D,
                                     cfg.m))
    assert price == 32.0 * 3 * (min(16, D) + min(16, D * 2) + min(16, 4))
    np.testing.assert_array_equal(_np(res.states["flecs_cgd"].edge_bits),
                                  np.full((1, 4), 4 * price))


def test_hierarchy_guards():
    cfg = tf.FlecsConfig(m=2, hierarchy=th.HierarchyConfig(n_edges=4))
    hp = tf.hparam_grid((1.0,), (1.0,), (64.0,))
    with pytest.raises(ValueError, match="edge_spec"):
        _run(cfg, hp, 2, 0, record=False)
    with pytest.raises(ValueError, match="backhaul"):
        _run(cfg, _identity_edge_hp(hp), 2, 0, record=False, n_edges=None)
    with pytest.raises(ValueError, match="divide"):
        th.validate_hierarchy(th.HierarchyConfig(n_edges=3), N)
    with pytest.raises(ValueError, match="n_edges"):
        th.HierarchyConfig(n_edges=0)


# ---------------------------------------------------------------------------
# hierarchical FLECS-CGD runs against the reference's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hier_runs():
    """The reference's and the port's hierarchical FLECS-CGD run (dither64
    edges, E = 4, p = 0.6, 6 rounds) from one key: the legacy steps, the
    sweep step at the config's point."""
    jp, tp = _problems()
    jcfg = jf.FlecsConfig(m=2, participation=0.6, hierarchy=jh.HierarchyConfig(
        n_edges=E, edge_compressor="dither64"))
    tcfg = tf.FlecsConfig(m=2, participation=0.6, hierarchy=th.HierarchyConfig(
        n_edges=E, edge_compressor="dither64"))
    key = jax.random.key(7)
    js, jt = jdr.run_experiment(
        jf.make_flecs_step(jcfg, *jp.make_oracles()),
        jf.init_state(jnp.zeros(D), N, n_edges=E), key, 6,
        record=lambda s: jp.metrics(s.w))
    ts, tt = tdr.run_experiment(
        tf.make_flecs_step(tcfg, *tp.make_oracles()),
        tf.init_state(torch.zeros(D), N, n_edges=E), _tkey(key), 6,
        record=lambda s: tp.metrics(s.w))
    return (js, jt), (ts, tt)


def test_hierarchical_run_matches_reference():
    (js, jt), (ts, tt) = _hier_runs()
    for name in ("edge_bits", "bits_per_node"):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)))
    for name in ("edge_bits", "n_active", "bits_per_node"):
        np.testing.assert_array_equal(_np(tt[name]), np.asarray(jt[name]))
    np.testing.assert_allclose(_np(tt["F"]), np.asarray(jt["F"]), rtol=1e-4)
    np.testing.assert_allclose(_np(ts.w), np.asarray(js.w), rtol=1e-3,
                               atol=1e-5)


def test_hierarchical_state_carries_over_from_reference():
    """The reference's carried hierarchical state in the port: every leaf,
    the backhaul ledger included; one more round bills each active edge
    its price on top of it."""
    (js, _), (ts, _) = _hier_runs()
    st = convert.state_from_reference(
        *(np.asarray(getattr(js, f)) for f in ("w", "h", "B", "k",
                                                "bits_per_node")),
        edge_bits=np.asarray(js.edge_bits), device="cpu")
    assert st.k == 6 and tuple(st.edge_bits.shape) == (E,)
    for name in ("w", "h", "B", "bits_per_node", "edge_bits"):
        np.testing.assert_array_equal(_np(getattr(st, name)),
                                      np.asarray(getattr(js, name)))
    _, tp = _problems()
    cfg = tf.FlecsConfig(m=2, participation=0.6, hierarchy=th.HierarchyConfig(
        n_edges=E, edge_compressor="dither64"))
    new, aux = tf.make_flecs_step(cfg, *tp.make_oracles())(st, tr.key(1,
                                                                      "cpu"))
    price = float(jh.edge_round_bits(jc.make_spec("dither64"), D, 2))
    paid = _np(new.edge_bits) - np.asarray(js.edge_bits)
    assert set(paid.tolist()) <= {0.0, price} and paid.max() == price


def test_async_step_ignores_hierarchy_like_reference():
    """The reference's async step never reads ``cfg.hierarchy``: the flat
    server, no backhaul ledger.  The port's does the same: bit for bit its
    own flat async run, and the reference's ledgers exactly."""
    jp, tp = _problems()
    hier = dict(hierarchy=th.HierarchyConfig(n_edges=E))
    tcfgs = [tf.FlecsConfig(m=2, participation=0.5, sampling="choice",
                            **kw) for kw in ({}, hier)]
    jcfg = jf.FlecsConfig(m=2, participation=0.5, sampling="choice",
                          hierarchy=jh.HierarchyConfig(n_edges=E))
    ahp = tf.async_hparam_grid((2,), (2.0,))
    jahp = jf.async_hparam_grid((2,), (2.0,))
    key = jax.random.key(11)
    runs = []
    for cfg in tcfgs:
        tlg, tlh = tp.make_oracles()
        runs.append(tdr.run_async_sweep(
            tf.make_flecs_async_sweep_step(cfg, tlg, tlh), ahp,
            tf.init_async_state(torch.zeros(D), N, 2, 2), _tkey(key), 8,
            record=lambda s: tp.metrics(s.w)))
    (fs, ft), (hs, ht) = runs
    for a, b in zip(fs, hs):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert all(torch.equal(ft[k], ht[k]) for k in ft)
    jlg, jlh = jp.make_oracles()
    js, jt = jdr.run_async_sweep(
        jf.make_flecs_async_sweep_step(jcfg, jlg, jlh), jahp,
        jf.init_async_state(jnp.zeros(D), N, 2, 2), key, 8,
        record=lambda s: jp.metrics(s.w))
    np.testing.assert_array_equal(_np(hs.bits_per_node),
                                  np.asarray(js.bits_per_node))
    assert "edge_bits" not in ht and "edge_bits" not in jt
    np.testing.assert_allclose(_np(ht["F"]), np.asarray(jt["F"]), rtol=1e-4)
