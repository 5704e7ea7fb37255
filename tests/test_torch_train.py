"""repro_torch's training path (models/loss, optim/optimizers, train/step,
core/dl_flecs, launch/train) against the JAX package, on the CPU.

Model: tinyllama-1.1b at smoke size with 2 layers, float32 weights from the
reference's key 0, carried leaf for leaf (``convert.params_from_reference``);
batches from numpy seeds.

Tolerances, each with its reason:
* ``lm_loss``: rtol 1e-6 (float32 logsumexp over 512 logits, summed in
  chunks in the same order);
* gradients of ``_loss_fn``: max |Δ| <= 1e-5 · max |g| per leaf (float32
  matmuls and their transposes summed in another order);
* optimizers, on the same gradients: rtol 1e-5, atol 1e-7 on the updates
  and states over 3 steps (the same float32 operations; ``pow``, ``sqrt``
  and ``rsqrt`` may differ in the last ulp between XLA and torch);
* ``make_train_step``: loss and grad norm rtol 1e-5 each step; params after
  2 steps within 1e-6 under sgd (linear in the gradients).  Under adam a
  step moves a weight by about lr · g / (|g| + eps), so where |g| is as
  small as the gradients' float32 noise (~1e-5 · max |g|) the reference's
  and the port's steps differ by up to ~lr: there at most 1e-3 of the
  elements may differ by more than 1e-6, and none by more than 2 · lr a
  step;
* one-worker FLECS-CGD, m = 0, against the reference trainer built on a 1x1
  debug mesh: ``uplink_mbits`` exactly; loss rtol 1e-5.  A level differs
  where a gradient that differs in its last bits moves y - floor(y) across
  its uniform, and a shift differs by one bf16 ulp where the reference's
  jitted ``norm / s`` (a reciprocal multiply) is one ulp from the port's
  division; a difference then changes the next step's gradients.  So the
  shifts may differ at no more than 1e-3 of the elements after one step
  and 2e-2 after three (measured: 1.2e-5 and 6.2e-3), each by at most a
  level step a step (γ · scale, scale <= max |h̄| / 127 · 2), and the
  params by at most α · 2 · max |h̄| / 127 + 1e-6 a step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import uniform_plan as ref_uniform_plan
from repro.core.dl_flecs import FlecsDLConfig as RefFlecsDLConfig
from repro.core.dl_flecs import make_flecs_train_step as ref_flecs_step
from repro.launch.mesh import make_debug_mesh
from repro.launch.sharding import batch_specs, named_shardings
from repro.models import CPU_CTX
from repro.models import init_params as ref_init_params
from repro.models.context import ModelContext
from repro.models.loss import lm_loss as ref_lm_loss
from repro.optim import optimizers as ref_optimizers
from repro.train.step import _loss_fn as ref_loss_fn
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import uniform_plan
from repro_torch.core.dl_flecs import (FlecsDLConfig, init_shifts,
                                       make_flecs_train_step)
from repro_torch.launch import train as train_launch
from repro_torch.models.loss import lm_loss
from repro_torch.optim import optimizers
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.tree import tree_leaves, tree_map

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    six parallel processes on a few cores, where eight threads a process
    spend their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 3e-3
ALPHA = LR * 30


def _configs(n_layers=2):
    ref = ref_get_config("tinyllama-1.1b", smoke=True)
    ref = dataclasses.replace(ref, n_layers=n_layers, layer_plan=ref_uniform_plan(
        n_layers, *ref.layer_plan[0]))
    port = get_config("tinyllama-1.1b", smoke=True)
    port = dataclasses.replace(port, n_layers=n_layers, layer_plan=uniform_plan(
        n_layers, *port.layer_plan[0]))
    return ref, port


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference_params():
    cfg, _ = _configs()
    return _np(ref_init_params(cfg, jax.random.key(0), jnp.float32))


def _params():
    return convert.params_from_reference(_reference_params(), "cpu")


def _batch(B=4, S=16, seed=0, vocab=512):
    t = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    ref = {"tokens": jnp.asarray(t[:, :-1], jnp.int32),
           "labels": jnp.asarray(t[:, 1:], jnp.int32)}
    port = {"tokens": torch.as_tensor(t[:, :-1]),
            "labels": torch.as_tensor(t[:, 1:])}
    return ref, port


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close_leaves(got, want, rel):
    got, want = tree_leaves(got), _ref_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        b = b.astype(np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1024, 16, 24])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(chunk, masked):
    """T = 80 tokens: one chunk (1024 > T), five chunks of 16, and 24,
    which does not divide T and so falls back to one chunk."""
    ref_cfg, cfg = _configs()
    g = np.random.default_rng(1)
    hidden = g.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    labels = g.integers(0, cfg.vocab, (2, 40))
    mask = (g.random((2, 40)) < 0.7).astype(np.float32) if masked else None
    want = ref_lm_loss(_reference_params(), jnp.asarray(hidden),
                       jnp.asarray(labels, jnp.int32), ref_cfg,
                       mask=None if mask is None else jnp.asarray(mask),
                       chunk=chunk)
    got = lm_loss(_params(), torch.as_tensor(hidden),
                  torch.as_tensor(labels), cfg,
                  mask=None if mask is None else torch.as_tensor(mask),
                  chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_gradients_match_jax_grad(remat):
    ref_cfg, cfg = _configs()
    ref_batch, batch = _batch()
    ctx = ModelContext(remat=remat)
    want_loss, want = jax.value_and_grad(ref_loss_fn)(
        jax.tree.map(jnp.asarray, _reference_params()), ref_batch, ref_cfg,
        ctx)
    loss, grads = value_and_grad(_params(), batch, cfg, remat=remat)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    _close_leaves(grads, want, 1e-5)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _toy_tree(seed):
    g = np.random.default_rng(seed)
    return {"a": g.normal(size=(8, 6)).astype(np.float32),
            "b": [g.normal(size=(2, 4, 5)).astype(np.float32),
                  g.normal(size=(7,)).astype(np.float32)]}


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adafactor"])
def test_optimizer_matches_reference_over_three_steps(name):
    ref_opt = ref_optimizers.get_optimizer(name, LR)
    opt = optimizers.get_optimizer(name, LR)
    ref_params = jax.tree.map(jnp.asarray, _toy_tree(0))
    params = convert.params_from_reference(_toy_tree(0), "cpu")
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for step in range(3):
        grads_np = _toy_tree(10 + step)
        ref_upd, ref_state = ref_opt.update(
            jax.tree.map(jnp.asarray, grads_np), ref_state, ref_params)
        upd, state = opt.update(convert.params_from_reference(grads_np, "cpu"),
                                state, params)
        for a, b in zip(tree_leaves(upd), _ref_leaves(ref_upd)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)
        for a, b in zip(tree_leaves(state), _ref_leaves(ref_state)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7)
        ref_params = jax.tree.map(lambda p, u: p + u, ref_params, ref_upd)
        params = tree_map(lambda p, u: p + u, params, upd)


def test_opt_state_carries_from_reference():
    ref_opt = ref_optimizers.get_optimizer("adam", LR)
    ref_state = _np(ref_opt.init(jax.tree.map(jnp.asarray, _toy_tree(0))))
    state = convert.opt_state_from_reference(ref_state, "cpu")
    assert state["t"].dtype == torch.int32 and int(state["t"]) == 0
    assert [t.shape for t in tree_leaves(state["m"])] == [
        a.shape for a in jax.tree.leaves(ref_state["m"])]


# ---------------------------------------------------------------------------
# standard train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_train_step_matches_reference(microbatches, name):
    ref_cfg, cfg = _configs()
    ref_opt = ref_optimizers.get_optimizer(name, LR)
    opt = optimizers.get_optimizer(name, LR)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, CPU_CTX, ref_opt,
                                           microbatches=microbatches))
    step = make_train_step(cfg, opt, microbatches=microbatches)
    ref_params = jax.tree.map(jnp.asarray, _reference_params())
    params = _params()
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for i in range(2):
        ref_batch, batch = _batch(seed=i)
        ref_params, ref_state, ref_m = ref_step(ref_params, ref_state,
                                                ref_batch)
        params, state, m = step(params, state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5)
    diff = np.concatenate([np.abs(a.numpy() - b).reshape(-1) for a, b in
                           zip(tree_leaves(params), _ref_leaves(ref_params))])
    if name == "sgd":
        assert diff.max() <= 1e-6
    else:
        assert (diff > 1e-6).mean() <= 1e-3, (diff > 1e-6).mean()
        assert diff.max() <= 2 * LR * 2


# ---------------------------------------------------------------------------
# one-worker FLECS-CGD
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_flecs_run(steps=3):
    """The reference trainer on a 1x1 mesh: (params, shifts, metrics) after
    each step, as numpy."""
    ref_cfg, _ = _configs()
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    ctx = ModelContext(mesh=mesh, data_axes=("data",), remat=True)
    params = jax.tree.map(jnp.asarray, _reference_params())
    batches = [_batch(seed=i)[0] for i in range(steps)]
    pa = jax.eval_shape(lambda: params)
    ba = jax.eval_shape(lambda: batches[0])
    pshard = named_shardings(pa, mesh)
    bshard = named_shardings(ba, mesh, batch_specs(ba, mesh, ("data",)))
    lower = ref_flecs_step(ref_cfg, ctx, RefFlecsDLConfig(alpha=ALPHA, m=0))
    jitted, shifts_abs = lower.build(pa, ba, pshard, bshard)
    shifts = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shifts_abs)
    out = []
    for i in range(steps):
        params, shifts, m = jitted(params, shifts, batches[i], jnp.int32(i))
        out.append((_np(params), _np(shifts), {k: float(v)
                                               for k, v in m.items()}))
    return out


def _shift_levels(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree.leaves(tree)])


@pytest.mark.parametrize("steps", [1, 3])
def test_flecs_steps_match_reference(steps):
    _, cfg = _configs()
    ref = _reference_flecs_run()
    step = make_flecs_train_step(cfg, FlecsDLConfig(alpha=ALPHA), remat=True)
    params, shifts = _params(), init_shifts(_params())
    scales = []
    for i in range(steps):
        params, shifts, m = step(params, shifts, _batch(seed=i)[1], i)
        ref_params, ref_shifts, ref_m = ref[i]
        assert m["uplink_mbits"].item() == np.float32(ref_m["uplink_mbits"])
        np.testing.assert_allclose(float(m["loss"]), ref_m["loss"],
                                   rtol=1e-5)
        scales.append(np.abs(_shift_levels(ref_shifts["mean"])).max())
    own = np.concatenate([t.float().numpy().reshape(-1)
                          for t in tree_leaves(shifts["own"])])
    want_own = _shift_levels(ref_shifts["own"])
    differ = own != want_own
    assert differ.mean() <= (1e-3 if steps == 1 else 2e-2), differ.mean()
    step_bound = 0.5 * 2 * max(scales) / 127 + 1e-6
    assert np.abs(own - want_own).max() <= step_bound * steps
    got_p = np.concatenate([t.numpy().reshape(-1)
                            for t in tree_leaves(params)])
    want_p = np.concatenate([np.asarray(x).reshape(-1)
                             for x in jax.tree.leaves(ref_params)])
    assert np.abs(got_p - want_p).max() <= steps * (
        ALPHA * 2 * max(scales) / 127 + 1e-6)


@functools.lru_cache(maxsize=None)
def _reference_flecs_m2_run(compress, steps=2):
    """The reference trainer with m = 2 sketch columns on a 1x1 mesh:
    (params, shifts, metrics) after each step, as numpy."""
    ref_cfg, _ = _configs()
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    ctx = ModelContext(mesh=mesh, data_axes=("data",), remat=True)
    params = jax.tree.map(jnp.asarray, _reference_params())
    batches = [_batch(seed=i)[0] for i in range(steps)]
    pa = jax.eval_shape(lambda: params)
    ba = jax.eval_shape(lambda: batches[0])
    pshard = named_shardings(pa, mesh)
    bshard = named_shardings(ba, mesh, batch_specs(ba, mesh, ("data",)))
    lower = ref_flecs_step(ref_cfg, ctx, RefFlecsDLConfig(
        alpha=ALPHA, m=2, compress=compress))
    jitted, shifts_abs = lower.build(pa, ba, pshard, bshard)
    shifts = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shifts_abs)
    out = []
    for i in range(steps):
        params, shifts, m = jitted(params, shifts, batches[i], jnp.int32(i))
        out.append((_np(params), _np(shifts), {k: float(v)
                                               for k, v in m.items()}))
    return out


@pytest.mark.parametrize("steps", [1, 2])
def test_flecs_m2_steps_match_reference(steps):
    """m = 2, compressed: ``uplink_mbits`` exactly (the gradient leaves'
    bits, then each column's leaves', in the reference's float32 order),
    loss rtol 1e-5; the shifts bounded as ``test_flecs_steps_match_
    reference`` bounds them (they see only the gradient messages); the
    params within that test's bound a step, α · 2 · max |h̄| / 127 + 1e-6
    (a flipped level moves g̃ by one level step and, with ρ = 1, the
    complement's step by as much; the sketched subspace's part moves less
    at this size: measured 5.5e-5 after one step and 1.4e-4 after two,
    against 1.4e-4 a step)."""
    _, cfg = _configs()
    ref = _reference_flecs_m2_run(True)
    step = make_flecs_train_step(cfg, FlecsDLConfig(alpha=ALPHA, m=2),
                                 remat=True)
    params, shifts = _params(), init_shifts(_params())
    scales = []
    for i in range(steps):
        params, shifts, m = step(params, shifts, _batch(seed=i)[1], i)
        ref_params, ref_shifts, ref_m = ref[i]
        assert m["uplink_mbits"].item() == np.float32(ref_m["uplink_mbits"])
        np.testing.assert_allclose(float(m["loss"]), ref_m["loss"],
                                   rtol=1e-5)
        scales.append(np.abs(_shift_levels(ref_shifts["mean"])).max())
    own = np.concatenate([t.float().numpy().reshape(-1)
                          for t in tree_leaves(shifts["own"])])
    want_own = _shift_levels(ref_shifts["own"])
    differ = own != want_own
    assert differ.mean() <= (1e-3 if steps == 1 else 2e-2), differ.mean()
    step_bound = 0.5 * 2 * max(scales) / 127 + 1e-6
    assert np.abs(own - want_own).max() <= step_bound * steps
    got_p = np.concatenate([t.numpy().reshape(-1)
                            for t in tree_leaves(params)])
    want_p = np.concatenate([np.asarray(x).reshape(-1)
                             for x in jax.tree.leaves(ref_params)])
    assert np.abs(got_p - want_p).max() <= steps * (
        ALPHA * 2 * max(scales) / 127 + 1e-6)


@pytest.mark.parametrize("steps", [1, 2])
def test_flecs_m2_uncompressed_matches_reference(steps):
    """m = 2 without compression (the mean path: 32 bits an element, Y
    used as computed): the params within 1e-6 a step of the reference's
    (float32 HVPs, QR, SVD and eigh, as the gradients' and FedSONIA's
    tolerances allow; measured 3e-8), loss rtol 1e-5."""
    _, cfg = _configs()
    ref = _reference_flecs_m2_run(False)
    step = make_flecs_train_step(cfg, FlecsDLConfig(alpha=ALPHA, m=2,
                                                    compress=False),
                                 remat=True)
    params, shifts = _params(), init_shifts(_params())
    for i in range(steps):
        params, shifts, m = step(params, shifts, _batch(seed=i)[1], i)
        assert m["uplink_mbits"].item() == np.float32(ref[i][2][
            "uplink_mbits"])
        np.testing.assert_allclose(float(m["loss"]), ref[i][2]["loss"],
                                   rtol=1e-5)
    got_p = np.concatenate([t.numpy().reshape(-1)
                            for t in tree_leaves(params)])
    want_p = np.concatenate([np.asarray(x).reshape(-1)
                             for x in jax.tree.leaves(ref[steps - 1][0])])
    assert np.abs(got_p - want_p).max() <= 1e-6 * steps


def test_shifts_carry_from_reference():
    ref = _reference_flecs_run()
    shifts = convert.shifts_from_reference(ref[0][1], "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(shifts))
    np.testing.assert_array_equal(
        np.concatenate([t.float().numpy().reshape(-1)
                        for t in tree_leaves(shifts)]),
        np.concatenate([_shift_levels(ref[0][1]["own"]),
                        _shift_levels(ref[0][1]["mean"])]))


def test_flecs_uncompressed_and_sketched():
    _, cfg = _configs()
    params, batch = _params(), _batch()[1]
    step = make_flecs_train_step(cfg, FlecsDLConfig(compress=False))
    new, shifts, m = step(params, init_shifts(params), batch, 0)
    n = sum(p.numel() for p in tree_leaves(params))
    assert m["uplink_mbits"].item() == np.float32(np.float32(32.0 * n) / 1e6)
    _, grads = value_and_grad(params, batch, cfg)
    for p, q, g in zip(tree_leaves(params), tree_leaves(new),
                       tree_leaves(grads)):
        torch.testing.assert_close(q, p - 1e-2 * g, rtol=0, atol=1e-7)
    # with m = 2 sketch columns the step now runs (it raised before the
    # sketched-Hessian slice): each column's leaves add 32 bits an element
    sketched = make_flecs_train_step(cfg, FlecsDLConfig(m=2, compress=False))
    new2, _, m2 = sketched(params, init_shifts(params), batch, 0)
    assert m2["uplink_mbits"].item() == np.float32(
        np.float32(np.float32(32.0 * n) * 3) / 1e6)
    assert float(m2["loss"]) == float(m["loss"])
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new2))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new2),
                                                     tree_leaves(new)))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_both_modes(capsys, tmp_path):
    adam = train_launch.main(["--device", "cpu", "--steps", "6",
                              "--seq", "16", "--batch", "4"])
    flecs = train_launch.main(["--device", "cpu", "--steps", "3", "--flecs",
                               "--seq", "16", "--batch", "4"])
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "step    5 loss" in out
    assert "uplink" in out
    for run in (adam, flecs):
        assert all(np.isfinite(m["loss"]) for m in run["metrics"])
    # --checkpoint now saves the last params (it raised before the
    # checkpoint store was ported); they restore bit for bit
    ckpt = tmp_path / "ckpt"
    run = train_launch.main(["--device", "cpu", "--steps", "2", "--seq",
                             "16", "--batch", "4", "--checkpoint",
                             str(ckpt)])
    assert "saved" in capsys.readouterr().out
    back, step = store.restore(ckpt, run["params"])
    assert step == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(run["params"])))
