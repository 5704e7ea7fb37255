"""The port's sweep engine (``repro_torch.core.driver``: a grid as a leading
[G] axis) against the reference's vmapped one (``repro.core.driver``), and
the pieces a grid is made of: grid specs, grouped compressor entries, grid
constructors, traced-p masks, the budget freeze.

Exact: key streams, masks, grouped compressor outputs (the plain versions,
which the card's kernels equal bit for bit), prices and bit ledgers, the
frozen rounds' counters.  Objectives pass through matrix products, QR,
eigh and pinv: rtol 1e-5 where nothing is dithered and 5e-4 where a value
is (a last-ulp difference can move a dithered value to the next level; the
same tolerances as tests/test_torch_flecs.py).  A sweep's row g against the
port's own standalone run on ``split(key, G)[g]`` runs the same ops on a
[G] batch instead of a [1] one: ledgers exact, objectives rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jc
from repro.core import driver as jdr
from repro.core import flecs as jf
from repro.data import logreg as jl
from repro.optim import baselines as jb
from repro_torch import convert
from repro_torch import random as tr
from repro_torch.core import compressors as tc
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.kernels.compressor import ops, ref
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


D, N, R, SEED = 16, 4, 16, 5
ITERS = 8


def _pair():
    j = jl.make_problem(d=D, n_workers=N, r=R, seed=SEED)
    t = convert.problem_from_reference(np.asarray(j.A), np.asarray(j.b),
                                       j.mu, device="cpu")
    return j, t


def _jhess(jp):
    return lambda w, i: jax.hessian(lambda ww: jp.local_loss(ww, i))(w)


def _tkey(seed):
    return tr.key(seed, "cpu")


#: name -> (reference (sweep step, hparams, state), port (the same),
#: objective rtol); the grids cover level and step-size axes, a family
#: axis mixing identity, dither and top-k, and a Bernoulli p axis.
def _sweep_case(name, jp, tp):
    jg, jh = jp.make_oracles()
    tg, th = tp.make_oracles()
    if name.startswith("flecs"):
        cfg = dict(m=2, hess_compressor="dither64")
        if name == "flecs levels":
            jhp = jf.hparam_grid([0.5, 1.0], [1.0], [16.0, 64.0])
            thp = tf.hparam_grid([0.5, 1.0], [1.0], [16.0, 64.0])
            rtol = 5e-4
        elif name == "flecs families":
            fam = ("identity", "dither64", "topk0.5")
            jhp = jf.FlecsHParams(
                jnp.ones(3), jnp.ones(3), jnp.ones(3), jc.stack_specs(*fam),
                jc.stack_specs("dither64", "topk0.5", "identity"))
            thp = tf.FlecsHParams(
                torch.ones(3), torch.ones(3), torch.ones(3),
                tc.stack_specs(*fam),
                tc.stack_specs("dither64", "topk0.5", "identity"))
            rtol = 5e-4
        else:                                           # "flecs p"
            jhp = jf.hparam_grid([1.0], [1.0], [64.0], ps=(1.0, 0.5, 0.25))
            thp = tf.hparam_grid([1.0], [1.0], [64.0], ps=(1.0, 0.5, 0.25))
            rtol = 5e-4
        return ((jf.make_flecs_sweep_step(jf.FlecsConfig(**cfg), jg, jh),
                 jhp, jf.init_state(jnp.zeros(D), N)),
                (tf.make_flecs_sweep_step(tf.FlecsConfig(**cfg), tg, th),
                 thp, tf.init_state(torch.zeros(D), N)), rtol)
    if name == "diana":
        kw = dict(alphas=(0.5, 1.0), levels=(16.0, 64.0), ps=(1.0, 0.5))
        return ((jb.make_diana_sweep_step(jb.DianaConfig(), jg),
                 jb.diana_hparam_grid(**kw), jb.init_diana(jnp.zeros(D), N)),
                (tb.make_diana_sweep_step(tb.DianaConfig(), tg),
                 tb.diana_hparam_grid(**kw), tb.init_diana(torch.zeros(D), N)),
                5e-4)
    if name == "fednl":
        kw = dict(alphas=(1.0, 0.5), fracs=(0.5, 1.0))
        cfg_j, cfg_t = jb.FedNLConfig(mu=jp.mu), tb.FedNLConfig(mu=tp.mu)
        return ((jb.make_fednl_sweep_step(cfg_j, jg, _jhess(jp)),
                 jb.fednl_hparam_grid(**kw), jb.init_fednl(jnp.zeros(D), N)),
                (tb.make_fednl_sweep_step(cfg_t, tg, tp.local_hessian),
                 tb.fednl_hparam_grid(**kw), tb.init_fednl(torch.zeros(D), N)),
                1e-5)
    kw = dict(alphas=(1.0, 2.0), ps=(1.0, 0.5))         # "gd"
    return ((jb.make_gd_sweep_step(jb.GDConfig(), jg, N),
             jb.gd_hparam_grid(**kw), jb.init_gd(jnp.zeros(D), N)),
            (tb.make_gd_sweep_step(tb.GDConfig(), tg, N),
             tb.gd_hparam_grid(**kw), tb.init_gd(torch.zeros(D), N)), 1e-5)


SWEEPS = ["flecs levels", "flecs families", "flecs p", "diana", "fednl",
          "gd"]


def _run_both(name, **kw):
    jp, tp = _pair()
    (js, jhp, jst), (ts, thp, tst), rtol = _sweep_case(name, jp, tp)
    jfin, want = jdr.run_sweep(js, jhp, jst, jax.random.key(2), ITERS,
                               record=lambda st: jp.metrics(st.w), **kw)
    kw = {k: (torch.bfloat16 if v is jnp.bfloat16 else v)
          for k, v in kw.items()}
    tfin, got = tdr.run_sweep(ts, thp, tst, _tkey(2), ITERS,
                              record=lambda st: tp.metrics(st.w), **kw)
    return (jfin, want), (tfin, got), rtol, (ts, thp, tst, tp)


def test_sweep_keys_match_reference():
    want = jax.random.key_data(jdr.sweep_keys(jax.random.key(11), 5, 7))
    got = tdr.sweep_keys(_tkey(11), 5, 7)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("name", SWEEPS)
def test_run_sweep_matches_reference(name):
    (jfin, want), (tfin, got), rtol, _ = _run_both(name)
    np.testing.assert_array_equal(got["bits_per_node"].numpy(),
                                  np.asarray(want["bits_per_node"]))
    np.testing.assert_array_equal(got["n_active"].numpy(),
                                  np.asarray(want["n_active"]))
    np.testing.assert_allclose(got["F"].numpy(), np.asarray(want["F"]),
                               rtol=rtol)
    np.testing.assert_array_equal(tfin.k.numpy(), np.asarray(jfin.k))
    assert got["F"].shape == (tdr.grid_size(_sweep_case(
        name, *_pair())[1][1]), ITERS)


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_row_equals_standalone_run(name):
    """Row g of a sweep is the run of the sweep step's [1] grid at point g
    (``driver.specialize``) on the key ``split(key, G)[g]``."""
    _, (tfin, got), _, (ts, thp, tst, tp) = _run_both(name)
    G = tdr.grid_size(thp)
    keys = tr.split(_tkey(2), G)
    for g in range(G):
        point = type(thp)(*(tc.spec_point(v, g) if isinstance(
            v, tc.CompressorSpec) else None if v is None else float(v[g])
            for v in thp))
        fin, row = tdr.run_experiment(tdr.specialize(ts, point), tst,
                                      keys[g], ITERS,
                                      record=lambda st: tp.metrics(st.w))
        np.testing.assert_array_equal(row["bits_per_node"].numpy(),
                                      got["bits_per_node"][g].numpy())
        np.testing.assert_allclose(row["F"].numpy(), got["F"][g].numpy(),
                                   rtol=1e-5)
        assert fin.k == ITERS == int(tfin.k[g])


def test_record_every_and_trace_dtype_match_reference():
    (_, want), (_, got), _, _ = _run_both(
        "flecs levels", record_every=2, trace_dtype=jnp.bfloat16)
    assert got["F"].shape == (4, ITERS // 2)
    assert got["F"].dtype == torch.bfloat16
    assert got["bits_per_node"].dtype == tdr.bits_dtype()
    np.testing.assert_array_equal(got["bits_per_node"].numpy(),
                                  np.asarray(want["bits_per_node"]))
    np.testing.assert_allclose(got["F"].float().numpy(),
                               np.asarray(want["F"], np.float32), rtol=1e-2)


@pytest.mark.parametrize("name", ["flecs levels", "diana", "fednl", "gd"])
def test_budget_freeze_pads_the_truncated_run(name):
    """A budget of T rounds' price: T live rounds, then frozen rows — the
    ledger, w and k stay where the T-round run left them, the activity
    counters read zero — and the frozen counters equal the reference's."""
    jp, tp = _pair()
    (js, jhp, jst), (ts, thp, tst), rtol = _sweep_case(name, jp, tp)
    G = tdr.grid_size(thp)
    full = tdr.run_sweep(ts, thp, tst, _tkey(4), ITERS,
                         record=lambda st: tp.metrics(st.w))[1]
    ledger = full["bits_per_node"].amax(dim=-1)          # [G, ITERS]
    # point g's budget: its ledger after 2, 3 or 4 rounds; it stays live
    # until its ledger reaches it (later under sampling, where a round may
    # charge nothing)
    budgets = ledger[np.arange(G), np.arange(G) % 3 + 1].numpy()
    T = [int(np.flatnonzero(ledger[g].numpy() >= budgets[g])[0]) + 1
         for g in range(G)]
    fin, got = tdr.run_sweep(ts, thp._replace(bit_budget=torch.as_tensor(
        budgets, dtype=torch.float32)), tst, _tkey(4), ITERS,
        record=lambda st: tp.metrics(st.w))
    jfin, want = jdr.run_sweep(js, jhp._replace(bit_budget=jnp.asarray(
        budgets, jnp.float32)), jst, jax.random.key(4), ITERS,
        record=lambda st: jp.metrics(st.w))
    np.testing.assert_array_equal(got["bits_per_node"].numpy(),
                                  np.asarray(want["bits_per_node"]))
    np.testing.assert_array_equal(fin.k.numpy(), np.asarray(jfin.k))
    for g in range(G):
        t = T[g]
        assert int(fin.k[g]) == t
        for key in ("bits_per_node", "F", "grad_sq"):
            live, tail = got[key][g, :t], got[key][g, t:]
            assert torch.equal(live, full[key][g, :t])
            assert torch.equal(tail, live[-1:].expand_as(tail))
        assert not got["n_active"][g, t:].any()
        assert not got["g_tilde_norm"][g, t:].any()


@pytest.mark.parametrize("budget,price,want", [
    (100.0, 30.0, 4), (90.0, 30.0, 3), (0.0, 30.0, 1), (10.0, 30.0, 1),
    ([100.0, 400.0], [30.0, 50.0], 8),
    ([[100.0], [200.0]], [30.0, 60.0], 7)])
def test_iters_for_bit_budget(budget, price, want):
    assert tdr.iters_for_bit_budget(budget, price) == want
    assert jdr.iters_for_bit_budget(budget, price) == want


@pytest.mark.parametrize("budget,price,match", [
    (np.inf, 30.0, "finite"), (100.0, 0.0, "> 0"), (100.0, np.nan, "> 0"),
    ([], 30.0, "empty")])
def test_iters_for_bit_budget_rejects(budget, price, match):
    for mod in (tdr, jdr):
        with pytest.raises(ValueError, match=match):
            mod.iters_for_bit_budget(budget, price)


def test_traced_p_masks_draw_for_draw():
    """resolve_participation over a [G] p axis is, point for point, the
    reference's traced draw ``uniform(key, (n,)) < p`` under vmap."""
    ps = np.asarray([1.0, 0.75, 0.5, 0.25, 0.05], np.float32)
    jkeys = jax.random.split(jax.random.key(8), 5)
    want = jax.vmap(lambda k, p: jdr.participation_mask(k, 20, p))(
        jkeys, jnp.asarray(ps))
    got = tdr.resolve_participation(
        convert.key_from_reference(jax.random.key_data(jkeys), "cpu"), 20,
        1.0, "bernoulli", torch.as_tensor(ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="bernoulli"):
        tdr.resolve_participation(_tkey(0), 20, 1.0, "choice",
                                  torch.as_tensor(ps))
    with pytest.raises(ValueError, match="> 0"):
        tf.hparam_grid([1.0], [1.0], [64.0], ps=(1.0, 0.0))


def test_grid_compress_split_matches_reference():
    """compress_split of a grid spec (one grouped entry per family; the
    plain versions on the CPU) against the reference's vmapped compress of
    each point's rows with ``split(key_g, n)``."""
    names = ("dither16", "identity", "topk0.25", "dither64", "topk0.1")
    x = np.random.default_rng(3).normal(size=(5, 6, 40)).astype(np.float32)
    jkeys = jax.random.split(jax.random.key(5), 5)
    want = jax.vmap(lambda sp, k, xx: jax.vmap(
        lambda kk, r: jc.compress(sp, kk, r))(jax.random.split(k, 6), xx))(
            jc.stack_specs(*names), jkeys, jnp.asarray(x))
    got = tc.compress_split(
        tc.stack_specs(*names),
        convert.key_from_reference(jax.random.key_data(jkeys), "cpu"),
        torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [16, 123, 5000, 25_000_000])
def test_spec_bits_many_matches_reference(d):
    names = ("identity", "dither64", "topk0.25", "dither16", "topk0.1")
    want = np.asarray(jc.spec_bits_many(jc.stack_specs(*names), d))
    spec = tc.stack_specs(*names)
    np.testing.assert_array_equal(tc.spec_bits_many(spec, d).numpy(), want)
    np.testing.assert_array_equal(tc.spec_bits_host(spec, d), want)
    for g in range(len(names)):
        assert (tc.spec_bits_many(tc.as_grid(tc.spec_point(spec, g), 1),
                                  d).item() == want[g])


@pytest.mark.parametrize("G,n,L", [(1, 4, 33), (3, 4, 33), (8, 2, 300)])
def test_grouped_plain_versions_equal_the_scalar_ones(G, n, L):
    """Each grouped entry's plain version, point by point, against the
    scalar entry's at that point's parameters: bit for bit."""
    rng = np.random.default_rng(G)
    x = torch.as_tensor(rng.normal(size=(G * n, L)).astype(np.float32))
    keys = tr.split(_tkey(G), G)
    s = torch.as_tensor(rng.choice([1.0, 16.0, 64.0], G).astype(np.float32))
    frac = torch.as_tensor(rng.choice([0.05, 0.25, 1.0], G)
                           .astype(np.float32))
    out, bits = ops.fused_dither_keyed_grouped(x, keys, s)
    tout, tbits = ops.fused_topk_grouped(x, frac)
    for g in range(G):
        rows = slice(g * n, (g + 1) * n)
        want, want_bits = ref.fused_dither_keyed_ref(x[rows], keys[g],
                                                     s[g].item())
        assert torch.equal(out[rows], want)
        assert torch.equal(bits[rows], want_bits)
        want, want_bits = ref.fused_topk_ref(x[rows], frac[g].item())
        assert torch.equal(tout[rows], want)
        assert torch.equal(tbits[rows], want_bits)
    np.testing.assert_array_equal(
        ops.dither_bits_grouped(s, L).numpy(),
        [ref.dither_bits_ref(v, L, "cpu").item() for v in s.tolist()])
    np.testing.assert_array_equal(
        ops.topk_bits_grouped(frac, L).numpy(),
        [ref.topk_bits_ref(v, L, "cpu").item() for v in frac.tolist()])


def test_grouped_entries_check_their_operands():
    x = torch.zeros(6, 8)
    with pytest.raises(ValueError, match="grid points"):
        ops.fused_topk_grouped(x, torch.ones(4))
    with pytest.raises(ValueError, match="float32"):
        ops.fused_dither_keyed_grouped(x, tr.split(_tkey(0), 3),
                                       torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="int64"):
        ops.fused_dither_keyed_grouped(x, torch.zeros(3, 2), torch.ones(3))


@pytest.mark.parametrize("kw", [
    dict(alphas=[0.5, 1.0], gammas=[1.0], grad_levels=[16.0, 64.0]),
    dict(alphas=[1.0], gammas=[0.5, 1.0], grad_levels=[64.0],
         betas=[0.5, 1.0], hess_levels=[16.0, 64.0], ps=(1.0, 0.5))])
def test_flecs_hparam_grid_and_price_match_reference(kw):
    jhp = jf.hparam_grid(**kw)
    thp = tf.hparam_grid(**kw)
    want = convert.hparams_from_reference(tf.FlecsHParams, jax.tree.map(
        np.asarray, jhp), "cpu")
    for a, b in zip(thp, want):
        if isinstance(a, tc.CompressorSpec):
            assert a.family == b.family
            assert torch.equal(a.s, b.s) and torch.equal(a.frac, b.frac)
        else:
            assert (a is None and b is None) or torch.equal(a, b)
    for m, d in ((1, 123), (4, 5000)):
        cfg = tf.FlecsConfig(m=m)
        np.testing.assert_array_equal(
            tf.hparams_round_bits(cfg, thp, d),
            np.asarray(jf.hparams_round_bits(jf.FlecsConfig(m=m), jhp, d)))


def test_edge_levels_raise_naming_their_queue_item():
    """``edge_levels`` builds the edge-tier axis (ported with the cohort,
    hierarchy and sharding slice); a hierarchical config run on a grid
    without it raises naming ``edge_levels``."""
    from repro_torch.core.hierarchy import HierarchyConfig
    hp = tf.hparam_grid([1.0], [1.0], [64.0], edge_levels=(16.0,))
    np.testing.assert_array_equal(hp.edge_spec.s.numpy(), [16.0])
    _, tp = _pair()
    cfg = tf.FlecsConfig(m=2, hierarchy=HierarchyConfig(n_edges=2))
    step = tf.make_flecs_sweep_step(cfg, *tp.make_oracles())
    with pytest.raises(ValueError, match="edge_levels"):
        tdr.run_sweep(step, tf.hparam_grid([1.0], [1.0], [64.0]),
                      tf.init_state(torch.zeros(D), N, n_edges=2),
                      _tkey(0), 1)
