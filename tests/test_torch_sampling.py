"""The stochastic setting of the port against the JAX reference: the key
streams ``randint``, ``permutation`` and ``choice``, exact-k client
sampling, the Gaussian and coordinate sketches, the minibatch oracles, and
stochastic rounds of FLECS-CGD, DIANA and GD.

Exact: every key stream (``jax.random`` 0.9.0 bit for bit, the two-round
permutation from n = 1,626 and ``randint`` at maxval = 2**31 - 1
included), the choice masks, the coordinate sketch, the minibatch rows and
the bit ledgers.  The Gaussian sketch is held to ``random.normal``'s few
ulps.  Minibatch gradients and HVPs to the full-batch oracles' tolerance
(tests/test_torch_logreg.py: the closed forms against ``jax.grad`` and
``jax.jvp``), a round's w, h and B to tests/test_torch_flecs.py's ``TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import driver as jdr
from repro.core import flecs as jf
from repro.core.sketch import sketch as jax_sketch
from repro.data import logreg as jl
from repro.optim import baselines as jb
from repro_torch import random as tr
from repro_torch.convert import (diana_state_from_reference,
                                 gd_state_from_reference, key_from_reference,
                                 problem_from_reference, state_from_reference)
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.core import sketch as ts
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


TOL = dict(rtol=1e-4, atol=1e-6)


def _tkey(key):
    return key_from_reference(jax.random.key_data(key), device="cpu")


@pytest.mark.parametrize("maxval", [64, 300, 2**31 - 1])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_randint_bit_for_bit(seed, maxval):
    key = jax.random.key(seed)
    for shape in ((32,), (7, 40)):
        want = np.asarray(jax.random.randint(key, shape, 0, maxval))
        got = tr.randint(_tkey(key), shape, 0, maxval)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_batched_keys_and_offsets():
    keys = jax.random.split(jax.random.key(3), 5)
    want = jax.vmap(lambda k: jax.random.randint(k, (20, 32), 0, 300))(keys)
    np.testing.assert_array_equal(
        tr.randint(_tkey(keys), (20, 32), 0, 300).numpy(), np.asarray(want))
    key = jax.random.key(5)
    for lo, hi in ((-5, 7), (10, 10), (3, 2), (-2**31, 2**31 - 1)):
        np.testing.assert_array_equal(
            tr.randint(_tkey(key), (50,), lo, hi).numpy(),
            np.asarray(jax.random.randint(key, (50,), lo, hi)))


@pytest.mark.parametrize("n", [1, 20, 1625, 1626, 5000])
def test_permutation_bit_for_bit(n):
    """n = 1,625 sorts once, n = 1,626 and 5000 twice (JAX's round count
    ceil(3 ln n / ln(2**32 - 1)))."""
    for seed in (0, 11):
        key = jax.random.key(seed)
        np.testing.assert_array_equal(
            tr.permutation(_tkey(key), n).numpy(),
            np.asarray(jax.random.permutation(key, n)))
    keys = jax.random.split(jax.random.key(2), 3)
    np.testing.assert_array_equal(
        tr.permutation(_tkey(keys), n).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys)))


def test_choice_bit_for_bit():
    key = jax.random.key(9)
    for n, shape, replace in ((5000, (4,), False), (20, (2, 5), False),
                              (50, (4, 3), True), (7, (), True)):
        want = np.asarray(jax.random.choice(key, n, shape, replace=replace))
        got = tr.choice(_tkey(key), n, shape, replace=replace).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="larger sample"):
        tr.choice(_tkey(key), 3, (4,), replace=False)
    with pytest.raises(NotImplementedError, match="never draws"):
        tr.choice(_tkey(key), 3, (2,), p=torch.ones(3) / 3)


@pytest.mark.parametrize("n,p", [(20, 0.5), (20, 0.25), (7, 0.3), (4, 0.1),
                                 (1626, 0.5)])
def test_choice_masks_match_reference(n, p):
    for seed in (0, 4):
        key = jax.random.key(seed)
        want = jdr.participation_mask(key, n, p, "choice")
        got = tdr.participation_mask(_tkey(key), n, p, "choice")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.sum().item() == max(1, round(p * n))
    keys = jax.random.split(jax.random.key(1), 4)
    want = jax.vmap(lambda k: jdr.participation_mask(k, n, p, "choice"))(
        keys)
    np.testing.assert_array_equal(
        tdr.resolve_participation(_tkey(keys), n, p, "choice").numpy(),
        np.asarray(want))


def test_choice_rejects_a_p_axis_as_the_reference_does():
    key = jax.random.key(0)
    with pytest.raises(ValueError) as want:
        jdr.resolve_participation(key, 4, 1.0, "choice", jnp.float32(0.5))
    with pytest.raises(ValueError) as got:
        tdr.resolve_participation(_tkey(key), 4, 1.0, "choice",
                                  torch.tensor([0.5]))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("d,m,k", [(24, 2, 0), (123, 4, 7), (1626, 3, 1),
                                   (5000, 4, 30)])
def test_coordinate_sketch_exact(d, m, k):
    want = np.asarray(jax_sketch("coordinate", d, m, jnp.int32(k)))
    got = ts.sketch("coordinate", d, m, k, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == m


@pytest.mark.parametrize("d,m,k", [(24, 2, 0), (123, 4, 7), (500, 3, 30)])
def test_gaussian_sketch_within_normal_ulps(d, m, k):
    want = np.asarray(jax_sketch("gaussian", d, m, jnp.int32(k)))
    got = ts.sketch("gaussian", d, m, k, torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 4


def _pair(d=24, n=4, r=24, seed=5):
    j = jl.make_problem(d=d, n_workers=n, r=r, seed=seed)
    t = problem_from_reference(np.asarray(j.A), np.asarray(j.b), j.mu,
                               device="cpu")
    return j, t


def _carry(jstep, state, rounds=3):
    """``rounds`` reference rounds on ``split(key(1), rounds)``, as
    ``run_experiment`` steps them (the jitted step, compiled once)."""
    for k in jax.random.split(jax.random.key(1), rounds):
        state, _ = jstep(state, k)
    return state


def test_minibatch_rows_and_oracles_match_reference():
    """Worker i draws rows ``randint(fold_in(k, i), (B,), 0, r)``: the rows
    are the reference's exactly; the gradient and HVP over them within the
    full-batch oracles' tolerance, for one iterate and a [G] grid."""
    jp, tp = _pair()
    B, n = 8, 4
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 24)).astype(np.float32)
    S = rng.normal(size=(24, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.key(6), 3)
    wk = jax.vmap(lambda k: jax.vmap(lambda i: jax.random.fold_in(k, i))(
        jnp.arange(n)))(keys)
    idx = jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (B,), 0, 24)))(
        wk)
    tkeys = tdr.worker_keys(_tkey(keys), n)
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.asarray(jax.random.key_data(wk)))
    A, b = tp.minibatch(tkeys, B)
    want_A = np.asarray(jp.A)[np.arange(n)[None, :, None], np.asarray(idx)]
    np.testing.assert_array_equal(A.numpy(), want_A)
    jg, jh = jp.make_oracles(batch=B)
    tg, th = tp.make_oracles(batch=B)
    assert tg.keyed and th.keyed
    ids = jnp.arange(n)
    g_ref = jax.jit(jax.vmap(lambda wg, kg: jax.vmap(
        lambda i, k: jg(wg, i, k))(ids, kg)))(jnp.asarray(w), wk)
    Y_ref = jax.jit(jax.vmap(lambda wg, kg: jax.vmap(
        lambda i, k: jh(wg, jnp.asarray(S), i, k))(ids, kg)))(
            jnp.asarray(w), wk)
    g = tg(torch.as_tensor(w), tkeys)
    Y = th(torch.as_tensor(w), torch.as_tensor(S), tkeys)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Y_ref), rtol=1e-4,
                               atol=1e-6)
    g1 = tg(torch.as_tensor(w[0]), tkeys[0])        # one iterate, w [d]
    np.testing.assert_allclose(g1.numpy(), np.asarray(g_ref[0]), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("sketch_kind", ["rademacher", "coordinate",
                                         "gaussian"])
def test_stochastic_flecs_round_from_carried_state(sketch_kind):
    """One FLECS-CGD round with minibatch oracles (B = 8) and exact-k
    sampling (p = 0.5) from a carried reference state: ledgers and the
    active count exact, w, h and B within TOL."""
    kw = dict(m=2, participation=0.5, sampling="choice", alpha=0.5,
              sketch_kind=sketch_kind)
    jp, tp = _pair()
    jstep = jax.jit(jf.make_flecs_step(jf.FlecsConfig(**kw),
                                       *jp.make_oracles(batch=8)))
    tstep = tf.make_flecs_step(tf.FlecsConfig(**kw),
                               *tp.make_oracles(batch=8))
    state = _carry(jstep, jf.init_state(jnp.zeros(24), 4))
    key = jax.random.key(9)
    want, want_aux = jstep(state, key)
    got, got_aux = tstep(state_from_reference(
        *[np.asarray(x) for x in state[:5]], device="cpu"), _tkey(key))
    np.testing.assert_array_equal(got.bits_per_node.numpy(),
                                  np.asarray(want.bits_per_node))
    assert got_aux["n_active"].item() == float(want_aux["n_active"]) == 2
    for name in ("w", "h", "B"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)


def test_stochastic_diana_and_gd_rounds_match_reference():
    """DIANA and GD rounds with a minibatch gradient oracle (rows from
    ``fold_in(k_g, i)``) and exact-k sampling, from carried states."""
    jp, tp = _pair()
    jg, tg = jp.make_oracles(batch=8)[0], tp.make_oracles(batch=8)[0]
    key = jax.random.key(9)
    jstep = jax.jit(jb.make_diana_step(0.5, 0.5, "dither64", jg, 0.5,
                                       "choice"))
    tstep = tb.make_diana_step(0.5, 0.5, "dither64", tg, 0.5, "choice")
    state = _carry(jstep, jb.init_diana(jnp.zeros(24), 4))
    want, _ = jstep(state, key)
    got, aux = tstep(diana_state_from_reference(
        *[np.asarray(x) for x in state], device="cpu"), _tkey(key))
    np.testing.assert_array_equal(got.bits_per_node.numpy(),
                                  np.asarray(want.bits_per_node))
    assert aux["n_active"].item() == 2
    for name in ("w", "h"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)
    jstep = jax.jit(jb.make_gd_step(1.0, jg, 4, 0.5, "choice"))
    tstep = tb.make_gd_step(1.0, tg, 4, 0.5, "choice")
    state = _carry(jstep, jb.init_gd(jnp.zeros(24), 4))
    want, _ = jstep(state, key)
    got, _ = tstep(gd_state_from_reference(
        *[np.asarray(x) for x in state], device="cpu"), _tkey(key))
    np.testing.assert_array_equal(got.bits_per_node.numpy(),
                                  np.asarray(want.bits_per_node))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), **TOL)


def test_full_batch_rounds_derive_no_oracle_keys(monkeypatch):
    """The full-batch path derives no per-worker key: ``worker_keys`` runs
    only for minibatch oracles."""
    calls = []
    orig = tdr.worker_keys
    monkeypatch.setattr(tdr, "worker_keys",
                        lambda *a: calls.append(1) or orig(*a))
    _, tp = _pair()
    state = tf.init_state(torch.zeros(24), 4)
    key = tr.key(0, "cpu")
    tf.make_flecs_step(tf.FlecsConfig(m=2), *tp.make_oracles())(state, key)
    assert not calls
    tf.make_flecs_step(tf.FlecsConfig(m=2),
                       *tp.make_oracles(batch=4))(state, key)
    assert len(calls) == 2          # k_g and k_h


def test_federated_logreg_choice_rows_match_reference_example(capsys):
    """``--sampling choice`` at a single p: the CLI's rows against the
    reference example's, the same flags: activity and Mbit a node exact,
    F within the plans' rtol 5e-4 (tests/test_torch_api.py)."""
    import re
    import runpy
    import sys
    from pathlib import Path
    from repro.core import api as japi
    from repro_torch import federated_logreg
    argv = ["--d", "16", "--workers", "4", "--iters", "6",
            "--participation", "0.5", "--sampling", "choice", "--method",
            "flecs_cgd"]
    federated_logreg.main(["--device", "cpu", *argv])
    got = capsys.readouterr().out.splitlines()[:-1]
    old = sys.argv
    sys.argv = ["federated_logreg.py", *argv]
    japi.reset_plan_stats()          # the example asserts its own compile
    try:
        runpy.run_path(str(Path(__file__).resolve().parent.parent
                           / "examples" / "federated_logreg.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    want = capsys.readouterr().out.splitlines()[:-1]
    assert len(got) == len(want) == 1

    def fields(line):
        return line.split()[0], {k: float(v) for k, v in re.findall(
            r"([\w/|]+)=\s*([-+.\deE]+)", line)}

    for g, w in zip(got, want):
        (gn, gv), (wn, wv) = fields(g), fields(w)
        assert gn == wn
        assert gv["Mbits/node"] == wv["Mbits/node"]
        assert gv["active/round"] == wv["active/round"] == 2.0
        np.testing.assert_allclose(gv["F"], wv["F"], rtol=5e-4)
