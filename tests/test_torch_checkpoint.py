"""repro_torch.checkpoint.store against the JAX package's store, on the CPU.

The two write the same format (``arrays.npz`` with leaf i as ``a{i}`` in
``jax.tree.flatten`` order, ``meta.json`` with the leaves' paths, the step
and numpy's dtype names; bfloat16 widened to float32), so each restores the
other's checkpoints.  Every comparison is exact: a checkpoint moves bits.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.core.dl_flecs import (FlecsDLConfig, init_shifts,
                                       make_flecs_train_step)
from repro_torch.launch import train as train_launch
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _tree(seed=0):
    """Dicts, lists, float32, bfloat16, int32 and 0-d leaves."""
    g = np.random.default_rng(seed)
    return {"w": g.normal(size=(5, 3)).astype(np.float32),
            "blocks": [{"a": g.normal(size=(4,)).astype(np.float32),
                        "b": g.integers(-9, 9, (2, 2)).astype(np.int32)},
                       {"a": g.normal(size=(4,)).astype(np.float32),
                        "b": g.integers(-9, 9, (2, 2)).astype(np.int32)}],
            "half": g.normal(size=(3, 2)).astype(np.float32),
            "t": np.asarray(7, np.int32)}


def _port(tree):
    out = convert.params_from_reference(tree, "cpu")
    out["half"] = out["half"].to(torch.bfloat16)
    return out


def _jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["half"] = out["half"].astype(jnp.bfloat16)
    return out


def _same(port_tree, jax_tree):
    got, want = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                       else b)
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_paths_are_the_references_keys():
    keys, _, _ = ref_store._keys(_jax(_tree()))
    assert tree_paths(_port(_tree())) == keys


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    store.save(tmp_path / "c", _port(_tree()), step=11)
    like = _jax(_tree(1))
    got, step = ref_store.restore(tmp_path / "c", like)
    assert step == 11
    assert jax.tree.map(lambda x: x.dtype, got) == jax.tree.map(
        lambda x: x.dtype, like)
    _same(_port(_tree()), got)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_store.save(tmp_path / "c", _jax(_tree()), step=5)
    like = _port(_tree(1))
    got, step = store.restore(tmp_path / "c", like)
    assert step == 5
    assert [t.dtype for t in tree_leaves(got)] == [
        t.dtype for t in tree_leaves(like)]
    _same(got, _jax(_tree()))


def test_both_write_the_same_files(tmp_path):
    store.save(tmp_path / "port", _port(_tree()), step=3)
    ref_store.save(tmp_path / "ref", _jax(_tree()), step=3)
    meta = [json.loads((tmp_path / d / "meta.json").read_text())
            for d in ("port", "ref")]
    assert meta[0] == meta[1]
    assert "bfloat16" in meta[0]["dtypes"]
    a, b = (np.load(tmp_path / d / "arrays.npz") for d in ("port", "ref"))
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])


def test_model_params_and_shifts_round_trip_both_ways(tmp_path):
    """The smoke tinyllama's float32 params and FLECS-CGD's bfloat16
    shifts, saved by each package and restored by the other."""
    from repro.configs import get_config as ref_get_config
    from repro.models import init_params as ref_init_params
    ref_params = ref_init_params(ref_get_config("tinyllama-1.1b", smoke=True),
                                 jax.random.key(0), jnp.float32)
    params = convert.params_from_reference(jax.tree.map(np.asarray,
                                                        ref_params), "cpu")
    shifts = tree_map(lambda t: t.to(torch.bfloat16), params)
    tree = {"params": params, "shifts": shifts}
    store.save(tmp_path / "p", tree, step=2)
    ref_tree = {"params": ref_params,
                "shifts": jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                       ref_params)}
    got, _ = ref_store.restore(tmp_path / "p", ref_tree)
    _same(tree, got)
    ref_store.save(tmp_path / "r", got, step=2)
    back, _ = store.restore(tmp_path / "r", tree)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_structure_and_shape_are_checked(tmp_path):
    store.save(tmp_path / "c", _port(_tree()))
    other = _port(_tree())
    other["extra"] = torch.zeros(1)
    with pytest.raises(AssertionError, match="structure mismatch"):
        store.restore(tmp_path / "c", other)
    wrong = _port(_tree())
    wrong["w"] = torch.zeros(3, 5)
    with pytest.raises(AssertionError):
        store.restore(tmp_path / "c", wrong)


def test_restore_takes_the_like_trees_dtype(tmp_path):
    store.save(tmp_path / "c", {"x": torch.arange(6.0).reshape(2, 3)})
    got, step = store.restore(tmp_path / "c", {"x": torch.zeros(
        2, 3, dtype=torch.float64)})
    assert step == 0 and got["x"].dtype == torch.float64
    assert torch.equal(got["x"], torch.arange(6.0,
                                              dtype=torch.float64).view(2, 3))


@pytest.mark.parametrize("flecs", [False, True])
def test_save_restore_continue_equals_an_unbroken_run(tmp_path, flecs):
    """Two steps of the launcher's trainer (adam, or FLECS-CGD m = 0), a
    checkpoint of params and state (adam's moments and step count, or the
    bfloat16 shifts), a restore into zeroed trees, two more steps: bit for
    bit four unbroken steps."""
    cfg, params = train_launch.setup(device="cpu")
    if flecs:
        fn = make_flecs_train_step(cfg, FlecsDLConfig(alpha=3e-3 * 30),
                                   remat=True)
        state = init_shifts(params)
    else:
        opt = get_optimizer("adam", 3e-3)
        adam = make_train_step(cfg, opt, remat=True)
        state = opt.init(params)

        def fn(p, s, b, i):
            return adam(p, s, b)

    def run(p, s, steps, start):
        stream = train_launch.token_batches(cfg, 2, 16, torch.device("cpu"))
        batches = [next(stream) for _ in range(start + steps)][start:]
        for i, b in enumerate(batches, start):
            p, s, _ = fn(p, s, b, i)
        return p, s

    whole, _ = run(params, state, 4, 0)
    p, s = run(params, state, 2, 0)
    store.save(tmp_path / "c", {"params": p, "state": s}, step=2)
    back, step = store.restore(tmp_path / "c", {
        "params": tree_map(torch.zeros_like, p),
        "state": tree_map(torch.zeros_like, s)})
    assert step == 2
    p, _ = run(back["params"], back["state"], 2, 2)
    for a, b in zip(tree_leaves(p), tree_leaves(whole)):
        assert torch.equal(a, b)


def test_launcher_checkpoint_restores_its_params(tmp_path, capsys):
    out = train_launch.main(["--device", "cpu", "--steps", "2", "--seq",
                             "16", "--batch", "2", "--checkpoint",
                             str(tmp_path / "ck")])
    assert "saved" in capsys.readouterr().out
    like = tree_map(torch.zeros_like, out["params"])
    got, step = store.restore(tmp_path / "ck", like)
    assert step == 2
    for a, b in zip(tree_leaves(got), tree_leaves(out["params"])):
        assert torch.equal(a, b)
