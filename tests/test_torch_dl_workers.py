"""repro_torch's multi-worker FLECS-CGD trainer (core/dl_flecs with n
workers, compressors.shared_scale_levels / sum_levels over workers, the
keyed encode's split entries, driver's collective helpers, the launcher's
``--workers``) against the JAX package, on the CPU.

Model: tinyllama-1.1b at smoke size with 2 layers, float32 weights from the
reference's key 0 (``test_torch_train._configs``), global batch 8 x 16 from
numpy seeds.  The reference trainer runs once for the module, in one
subprocess with 4 forced host devices on an (n, 1) debug mesh (its data
axis is the federation), and writes its params, shifts and metrics after
every step to a temporary directory: n = 4 at m = 0 for 3 steps, n = 2 at
m = 2 for 1 step, and n = 3 (8 rows do not divide over 3 workers, so every
worker sees the whole batch) for 1 step.

Tolerances, each with its reason:
* ``uplink_mbits`` exactly (the same float32 sum of the same prices);
* loss rtol 1e-5 (the workers' mean of float32 losses, as
  ``test_torch_train``);
* the ``own`` shifts: a level differs where a gradient that differs in its
  last bits moves y - floor(y) across its uniform, and the reference's
  jitted ``norm / s`` (a reciprocal multiply) is an ulp from the port's
  division; a flipped level moves a worker's float32 update by γ · scale,
  and the cast to bf16 can add one bf16 ulp of the shift, at most γ ·
  scale again.  So the shifts may differ at no more than 1e-3 of the
  elements after one step and 2e-2 after three (measured 1.8e-6 and
  1.6e-3 at n = 4), each by at most 2 · γ · S a step, S the largest
  scale the port's step used (the reference's is within ~1e-5 of it,
  as the gradients are);
* the params by at most α · 2 · S + 1e-6 a step: a flipped level of one
  worker moves c̄ by scale / n and all n workers flipping at one element
  by one level step; h̄ carries γ times that into the next step (measured
  9.1e-5 after three steps at n = 4, against 3.6e-4 a step);
* the port's own equalities (n workers in one process = the same workers
  over gloo ranks; n = 1 = the one-worker algorithm; a world-size-1 group
  = no group; the split entries = the fused keyed encode) bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core import compressors as ref_compressors
from repro_torch import convert, random
from repro_torch.configs import get_config
from repro_torch.configs.base import uniform_plan
from repro_torch.core import compressors
from repro_torch.core import dl_flecs
from repro_torch.core import driver
from repro_torch.kernels.dither import ops, ref
from repro_torch.launch import train as train_launch
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

SRC = str(Path(__file__).resolve().parents[1] / "src")
ALPHA, GAMMA, B, S = 3e-3 * 30, 0.5, 8, 16
#: name: (workers, sketch columns m, steps) of the reference runs
RUNS = {"n4_m0": (4, 0, 3), "n2_m2": (2, 2, 1), "n3_uneven": (3, 0, 1)}

REFERENCE = textwrap.dedent('''
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.configs.base import uniform_plan
    from repro.core.dl_flecs import FlecsDLConfig, make_flecs_train_step
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.sharding import batch_specs, named_shardings
    from repro.models import init_params
    from repro.models.context import ModelContext

    ALPHA, B, S, RUNS = {alpha!r}, {B!r}, {S!r}, {runs!r}
    cfg = get_config("tinyllama-1.1b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=2, layer_plan=uniform_plan(
        2, *cfg.layer_plan[0]))
    params0 = init_params(cfg, jax.random.key(0), jnp.float32)
    out = {{"params0": jax.tree.map(np.asarray, params0)}}
    for name, (n, m, steps) in RUNS.items():
        mesh = make_debug_mesh((n, 1), ("data", "model"))
        ctx = ModelContext(mesh=mesh, data_axes=("data",), remat=True)
        batches = []
        for i in range(steps):
            t = np.random.default_rng(i).integers(0, cfg.vocab, (B, S + 1))
            batches.append({{"tokens": jnp.asarray(t[:, :-1], jnp.int32),
                             "labels": jnp.asarray(t[:, 1:], jnp.int32)}})
        pa = jax.eval_shape(lambda: params0)
        ba = jax.eval_shape(lambda: batches[0])
        pshard = named_shardings(pa, mesh)
        bshard = named_shardings(ba, mesh, batch_specs(ba, mesh, ("data",)))
        lower = make_flecs_train_step(cfg, ctx, FlecsDLConfig(alpha=ALPHA,
                                                              m=m))
        jitted, shifts_abs = lower.build(pa, ba, pshard, bshard)
        shifts = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype),
                              shifts_abs)
        p, rec = params0, []
        for i in range(steps):
            p, shifts, met = jitted(p, shifts, batches[i], jnp.int32(i))
            rec.append((jax.tree.map(np.asarray, p),
                        jax.tree.map(np.asarray, shifts),
                        {{k: float(v) for k, v in met.items()}}))
        out[name] = rec
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
''').format(alpha=ALPHA, B=B, S=S, runs=RUNS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    parallel processes, and eight threads a process on a few cores spend
    their time waiting on each other.  Every bitwise comparison here is
    between runs on the same thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference trainer's runs, from one subprocess (XLA on one
    thread, as the module's torch work)."""
    path = tmp_path_factory.mktemp("ref_workers") / "runs.pkl"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


def _cfg(n_layers=2):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    return dataclasses.replace(cfg, n_layers=n_layers, layer_plan=uniform_plan(
        n_layers, *cfg.layer_plan[0]))


def _params(reference=None):
    if reference is not None:
        return convert.params_from_reference(reference["params0"], "cpu")
    from repro_torch.models.model import init_params
    return init_params(_cfg(), random.key(0, "cpu"), torch.float32)


def _batch(seed, rows=B):
    t = np.random.default_rng(seed).integers(0, _cfg().vocab, (rows, S + 1))
    return {"tokens": torch.as_tensor(t[:, :-1]),
            "labels": torch.as_tensor(t[:, 1:])}


def _flat(leaves):
    return np.concatenate([np.asarray(x.float() if isinstance(x, torch.Tensor)
                                      else x, np.float32).reshape(-1)
                           for x in leaves])


def _bits(tree):
    """Every leaf's raw bits as numpy (bf16 as int16, float32 as int32)."""
    return [t.view(torch.int16 if t.element_size() == 2 else torch.int32)
            .numpy().copy() if t.is_floating_point() else t.numpy().copy()
            for t in tree_leaves(tree)]


def _same_bits(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def _run(cfg, params, n, m, steps, group=None, compress=True, rows=B):
    """``steps`` steps of the port's n-worker trainer from ``params`` on
    the batches of seeds 0, 1, ...: (params, shifts, metrics a step)."""
    step = dl_flecs.make_flecs_train_step(
        cfg, dl_flecs.FlecsDLConfig(alpha=ALPHA, m=m, compress=compress),
        remat=True, n_workers=n, group=group)
    n_local = n if group is None else n // group.size
    p, s, mets = params, dl_flecs.init_shifts(params, n_local), []
    for i in range(steps):
        p, s, met = step(p, s, _batch(i, rows), i)
        mets.append({k: float(v) for k, v in met.items()})
    return p, s, mets


# ---------------------------------------------------------------------------
# against the reference trainer
# ---------------------------------------------------------------------------

def _scale_recorder(monkeypatch):
    """Record each step's message scales (``record[-1]``, a list)."""
    inner = dl_flecs.shared_scale_levels
    record = []

    def recorded(key, x, s, group=None):
        levels, scale = inner(key, x, s, group)
        record[-1].append(float(scale))
        return levels, scale

    monkeypatch.setattr(dl_flecs, "shared_scale_levels", recorded)
    return record


@pytest.mark.parametrize("name", sorted(RUNS))
def test_workers_match_reference(reference, monkeypatch, name):
    """n workers against the reference on an (n, 1) mesh, every step:
    uplink exactly, loss rtol 1e-5, shifts and params within the level-flip
    bounds of the module docstring."""
    n, m, steps = RUNS[name]
    record = _scale_recorder(monkeypatch)
    step = dl_flecs.make_flecs_train_step(
        _cfg(), dl_flecs.FlecsDLConfig(alpha=ALPHA, m=m), remat=True,
        n_workers=n)
    p = _params(reference)
    s = dl_flecs.init_shifts(p, n)
    n_leaves = len(tree_leaves(p))
    bound_own = bound_p = 0.0
    for i in range(steps):
        record.append([])
        p, s, met = step(p, s, _batch(i), i)
        ref_p, ref_s, ref_m = reference[name][i]
        assert met["uplink_mbits"].item() == np.float32(ref_m["uplink_mbits"])
        np.testing.assert_allclose(float(met["loss"]), ref_m["loss"],
                                   rtol=1e-5)
        scale = max(record[-1][:n_leaves])          # the gradient messages
        bound_own += 2 * GAMMA * scale
        bound_p += ALPHA * 2 * scale + 1e-6
        own, want = _flat(tree_leaves(s["own"])), _flat(
            jax.tree.leaves(ref_s["own"]))
        assert own.shape == want.shape
        assert (own != want).mean() <= (1e-3 if i == 0 else 2e-2)
        assert np.abs(own - want).max() <= bound_own
        mean, want_mean = _flat(tree_leaves(s["mean"])), _flat(
            jax.tree.leaves(ref_s["mean"]))
        assert np.abs(mean - want_mean).max() <= bound_own
        got_p, want_p = _flat(tree_leaves(p)), _flat(jax.tree.leaves(ref_p))
        assert np.abs(got_p - want_p).max() <= bound_p
    assert [len(r) for r in record] == [n_leaves * (1 + m)] * steps


def test_reference_shifts_carry_across(reference):
    """The reference's [n, ...] own shifts convert leaf for leaf
    (``convert.shifts_from_reference``) and the port's step goes on from
    them, its own shifts [n, ...] too."""
    ref_p, ref_s, _ = reference["n4_m0"][0]
    shifts = convert.shifts_from_reference(ref_s, "cpu")
    params = convert.params_from_reference(ref_p, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(shifts))
    for t, p in zip(tree_leaves(shifts["own"]), tree_leaves(params)):
        assert t.shape == (4,) + p.shape
    np.testing.assert_array_equal(_flat(tree_leaves(shifts)),
                                  _flat(jax.tree.leaves(ref_s)))
    step = dl_flecs.make_flecs_train_step(
        _cfg(), dl_flecs.FlecsDLConfig(alpha=ALPHA), remat=True, n_workers=4)
    _, new, met = step(params, shifts, _batch(1), 1)
    assert all(a.shape == b.shape for a, b in zip(tree_leaves(new),
                                                  tree_leaves(shifts)))
    assert np.isfinite(float(met["loss"]))


# ---------------------------------------------------------------------------
# the collective quantizer against the reference's pmax / psum form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("shape,s", [((2, 64, 96), 127), ((512,), 127),
                                     ((16, 40), 15), ((3, 7, 11), 2047)])
def test_shared_scale_levels_over_workers_matches_reference(n, shape, s):
    """n workers' levels against one pmax-shared norm, and their f16 psum:
    the reference's ``shared_scale_levels`` under ``jax.vmap(...,
    axis_name="w")`` over n workers against the port's over a list, bit
    for bit; every worker draws under the same key."""
    x = (np.random.default_rng(n).normal(size=(n,) + shape) * 3).astype(
        np.float32)
    x[n - 1] *= 4.0                    # the last worker holds the norm
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(29), 2), 5)
    s_cap = ref_compressors.psum_level_cap(s, n)

    def worker(xw):
        levels, scale = ref_compressors.shared_scale_levels(key, xw, s_cap,
                                                            "w")
        total = jax.lax.psum(levels.astype(jnp.float16), "w")
        return levels, scale, total.astype(jnp.float32) * scale / n

    want_lv, want_sc, want_mean = jax.vmap(worker, axis_name="w")(
        jnp.asarray(x))
    levels, scale = compressors.shared_scale_levels(
        convert.key_from_reference(jax.random.key_data(key), "cpu"),
        [torch.as_tensor(w) for w in x], compressors.psum_level_cap(s, n))
    for j in range(n):
        np.testing.assert_array_equal(levels[j].numpy(), np.asarray(
            want_lv[j]))
        assert scale.numpy() == np.asarray(want_sc[j])
    mean = compressors.sum_levels(levels) * scale / torch.tensor(float(n))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(want_mean[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C,br,s", [(16, 128, 8, 127), (24, 77, 3, 255),
                                      (1, 4099, 1, 127), (64, 128, 64, 15)])
def test_split_entries_equal_the_fused_keyed_encode(R, C, br, s, dtype):
    """One worker: ``dither_absmax_into`` into zeroed norms, then
    ``dither_levels_keyed``, is ``dither_encode_keyed`` bit for bit (the
    plain versions, which the card's kernels are held to)."""
    x = torch.as_tensor((np.random.default_rng(R + C).normal(size=(R, C))
                         * 10).astype(np.float32)).to(dtype)
    x[0, 0] = -0.0
    key = random.fold_in(random.key(R, "cpu"), C)
    want_lv, want_sc = ops.dither_encode_keyed(x, key, s=s, block_rows=br)
    norm_bits = torch.zeros(R // br, dtype=torch.int32)
    assert ops.dither_absmax_into(x, norm_bits, block_rows=br) is norm_bits
    lv, sc = ops.dither_levels_keyed(x, key, norm_bits, s=s, block_rows=br)
    assert torch.equal(lv, want_lv)
    assert torch.equal(sc.view(torch.int32), want_sc.view(torch.int32))


def test_absmax_merges_workers_and_edge_values():
    """Successive leaves widen each block's norm (the maximum over the
    workers without stacking them); zero, -0, inf and NaN blocks as the
    fused encode treats them (a zero norm quantizes against 1)."""
    g = np.random.default_rng(3)
    xs = [torch.as_tensor(g.normal(size=(8, 32)).astype(np.float32) * k)
          for k in (1.0, 5.0, 2.0)]
    norm_bits = torch.zeros(2, dtype=torch.int32)
    for x in xs:
        ops.dither_absmax_into(x, norm_bits, block_rows=4)
    want = torch.stack(xs).abs().reshape(3, 2, -1).amax(dim=(0, 2))
    assert torch.equal(norm_bits.view(torch.float32), want)
    # the workers' levels at once (one draw) = one worker at a time
    key = random.key(11, "cpu")
    levels, scale = ops.dither_levels_keyed(xs, key, norm_bits, s=63,
                                            block_rows=4)
    for x, lv in zip(xs, levels):
        one, one_sc = ops.dither_levels_keyed(x, key, norm_bits, s=63,
                                              block_rows=4)
        assert torch.equal(lv, one) and torch.equal(scale, one_sc)
    inf, nan = float("inf"), float("nan")
    x = torch.tensor([[0.0, -0.0, 0.0, 0.0], [1.0, -inf, 3.0, -2.0],
                      [1.0, nan, 3.0, -2.0], [4.0, -4.0, 3.9, -3.9]])
    key = random.key(7, "cpu")
    norm_bits = ops.dither_absmax_into(x, torch.zeros(4, dtype=torch.int32),
                                       block_rows=1)
    lv, sc = ops.dither_levels_keyed(x, key, norm_bits, s=127, block_rows=1)
    want_lv, want_sc = ref.dither_encode_keyed_ref(x, key, 127, 1)
    assert torch.equal(lv, want_lv)
    np.testing.assert_array_equal(sc.numpy(), want_sc.numpy())


def test_split_entries_reject_what_the_kernels_do_not_take():
    x = torch.ones((8, 16))
    key = random.key(0, "cpu")
    with pytest.raises(ValueError, match="norm_bits"):
        ops.dither_absmax_into(x, torch.zeros(1, dtype=torch.int64),
                               block_rows=8)
    with pytest.raises(ValueError, match="norm_bits"):
        ops.dither_absmax_into(x, torch.zeros(2, dtype=torch.int32),
                               block_rows=8)
    with pytest.raises(ValueError, match="multiple"):
        ops.dither_absmax_into(x, torch.zeros(1, dtype=torch.int32),
                               block_rows=3)
    with pytest.raises(TypeError):
        ops.dither_absmax_into(x.double(), torch.zeros(1, dtype=torch.int32),
                               block_rows=8)
    with pytest.raises(ValueError, match="key"):
        ops.dither_levels_keyed(x, key.int(), torch.zeros(1, dtype=torch.int32),
                                block_rows=8)
    with pytest.raises(ValueError, match="norm_bits"):
        ops.dither_levels_keyed(x, key, torch.zeros(1), block_rows=8)
    with pytest.raises(ValueError, match="share"):
        ops.dither_levels_keyed([x, torch.ones((8, 8))], key,
                                torch.zeros(1, dtype=torch.int32),
                                block_rows=8)
    ops.reset_launches()
    nb = ops.dither_absmax_into(x, torch.zeros(1, dtype=torch.int32),
                                block_rows=8)
    ops.dither_levels_keyed(x, key, nb, block_rows=8)
    assert ops.launches == {name: 0 for name in ops.launches}  # plain only


# ---------------------------------------------------------------------------
# the port's own equalities
# ---------------------------------------------------------------------------

def test_worker_rows_and_block():
    batch = _batch(0)
    rows = [dl_flecs.worker_rows(batch, w, 4)["tokens"] for w in range(4)]
    assert torch.equal(torch.cat(rows), batch["tokens"])
    assert all(r.shape == (2, S) for r in rows)
    assert dl_flecs.worker_rows(batch, 2, 3)["tokens"] is batch["tokens"]
    assert driver.worker_block(None, 4) == range(4)
    assert driver.worker_block(driver.WorkerGroup(None, 1, 2), 4) == range(
        2, 4)
    with pytest.raises(ValueError, match="divide"):
        driver.worker_block(driver.WorkerGroup(None, 0, 3), 4)
    with pytest.raises(ValueError, match="at least 1"):
        dl_flecs.make_flecs_train_step(_cfg(), n_workers=0)


def _one_worker_step(cfg, params, shifts, batch, i):
    """FLECS-CGD, m = 0, of one worker as the one-worker trainer took it:
    per leaf the fused keyed encode of g - h, its decode as both the
    worker's and the server's message."""
    loss, grads = value_and_grad(params, batch, cfg, True)
    leaves, treedef = tree_flatten(grads)
    key0 = random.fold_in(random.key(29, "cpu"), i)
    s = compressors.psum_level_cap(127, 1)
    new_p, own, mean = [], [], []
    for j, (p, g, ho, hm) in enumerate(zip(
            tree_leaves(params), leaves, tree_leaves(shifts["own"]),
            tree_leaves(shifts["mean"]))):
        rows = (g - ho[0].float()).reshape(-1, g.shape[-1])
        lv, sc = ops.dither_encode_keyed(rows, random.fold_in(key0, j), s=s,
                                         block_rows=rows.shape[0])
        q = ops.dither_decode(lv, sc, block_rows=rows.shape[0]).reshape(
            g.shape)
        new_p.append((p.float() + ALPHA * -(q + hm.float())).to(p.dtype))
        own.append((ho[0].float() + GAMMA * q).to(ho.dtype)[None])
        mean.append((hm.float() + GAMMA * q).to(hm.dtype))
    return (tree_unflatten(treedef, new_p),
            {"own": tree_unflatten(treedef, own),
             "mean": tree_unflatten(treedef, mean)}, loss)


def test_one_worker_is_the_one_worker_step():
    """n = 1 without a group is the one-worker algorithm bit for bit, and
    launches the fused keyed encode, never the split entries."""
    cfg, params = _cfg(), _params()
    p, s, mets = _run(cfg, params, 1, 0, 2)
    want_p, want_s = params, dl_flecs.init_shifts(params)
    for i in range(2):
        want_p, want_s, loss = _one_worker_step(cfg, want_p, want_s,
                                                _batch(i), i)
    assert mets[-1]["loss"] == float(loss)
    assert _same_bits(_bits(p), _bits(want_p))
    assert _same_bits(_bits(s), _bits(want_s))


def _gloo_worker(rank, world, directory):
    """Rank ``rank`` of 2: the same runs over the 2-rank group and, in a
    one-rank subgroup, at n = 1; rank 0 also runs them in one process.
    Writes its results to ``directory`` (a queue's pipe would fill while
    the parent waits for the ranks to end)."""
    torch.set_num_threads(1)
    group = driver.worker_group(world, rank,
                                f"file://{directory / 'rendezvous'}")
    subgroups = [torch.distributed.new_group([r]) for r in range(world)]
    alone = driver.WorkerGroup(subgroups[rank], 0, 1)
    cfg, params = _cfg(), _params()
    cases = {"n4_m0": dict(n=4, m=0, steps=2),
             "n2_m2": dict(n=2, m=2, steps=1),
             "n2_uncompressed": dict(n=2, m=0, steps=1, compress=False),
             "n4_uneven": dict(n=4, m=0, steps=1, rows=6)}
    out = {}
    for name, kw in cases.items():
        p, s, mets = _run(cfg, params, group=group, **kw)
        out[name] = (_bits(p), _bits(s["mean"]), _bits(s["own"]), mets)
        if rank == 0:
            p, s, mets = _run(cfg, params, **kw)
            out[name + " one process"] = (_bits(p), _bits(s["mean"]),
                                          _bits(s["own"]), mets)
    p, s, mets = _run(cfg, params, 1, 0, 2, group=alone)
    out["n1 world 1"] = (_bits(p), _bits(s["mean"]), _bits(s["own"]), mets)
    if rank == 0:
        p, s, mets = _run(cfg, params, 1, 0, 2)
        out["n1 no group"] = (_bits(p), _bits(s["mean"]), _bits(s["own"]),
                              mets)
    with open(directory / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    directory = tmp_path_factory.mktemp("gloo_workers")
    mp.spawn(_gloo_worker, (2, directory), nprocs=2)
    out = {}
    for rank in (0, 1):
        with open(directory / f"rank{rank}.pkl", "rb") as f:
            out[rank] = pickle.load(f)
    return out


@pytest.mark.parametrize("name", ["n4_m0", "n2_m2", "n2_uncompressed",
                                  "n4_uneven"])
def test_ranks_equal_one_process(gloo, name):
    """n workers over 2 gloo ranks (n / 2 a rank) and in one process: every
    param leaf, h̄ and the metrics on both ranks, and each rank's own
    shifts as its block of the one-process [n, ...] leaves, bit for bit."""
    one_p, one_mean, one_own, one_mets = gloo[0][name + " one process"]
    for rank in (0, 1):
        p, mean, own, mets = gloo[rank][name]
        assert _same_bits(p, one_p), rank
        assert _same_bits(mean, one_mean), rank
        assert mets == one_mets, rank
        half = [w[rank * (w.shape[0] // 2):(rank + 1) * (w.shape[0] // 2)]
                for w in one_own]
        assert _same_bits(own, half), rank


def test_world_size_one_group_equals_no_group(gloo):
    """At n = 1 a one-rank group (split entries, the all-reduces) gives
    the fused one-worker step's bits."""
    want = gloo[0]["n1 no group"]
    for rank in (0, 1):
        got = gloo[rank]["n1 world 1"]
        assert all(_same_bits(a, b) for a, b in zip(got[:3], want[:3]))
        assert got[3] == want[3]


def test_launcher_runs_workers(capsys):
    out = train_launch.main(["--device", "cpu", "--steps", "2", "--flecs",
                             "--workers", "4", "--seq", "16", "--batch",
                             "8"])
    text = capsys.readouterr().out
    assert "4 workers" in text and "uplink" in text
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert all(t.shape[0] == 4 for t in tree_leaves(out["state"]["own"]))
    with pytest.raises(SystemExit):
        train_launch.main(["--device", "cpu", "--workers", "2"])
