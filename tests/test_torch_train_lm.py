"""repro_torch.train_lm (the driver users run for FLECS-CGD with m > 0 and
checkpoints) against ``examples/train_lm.py``, on the CPU.

The driver's tokens are the example's bit for bit (the same numpy calls on
the same generator), its preset the example's; its runs at smoke size
finish with finite losses in both modes and at m = 0 and 2, print the
example's lines, and write checkpoints that the JAX package's store
restores bit for bit.  The FLECS-CGD step itself is held to the reference
in ``test_torch_train.py``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import get_config as ref_get_config
from repro_torch import train_lm
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.tree import tree_leaves

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    six parallel processes on a few cores, where eight threads a process
    spend their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "example_train_lm", ROOT / "examples" / "train_lm.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("batch,seq,workers", [(8, 128, 4), (3, 17, 4),
                                               (5, 9, 2)])
def test_tokens_are_the_examples(batch, seq, workers):
    example = _example()
    ref_cfg = ref_get_config("tinyllama-1.1b", smoke=True)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    want = example.token_stream(ref_cfg, np.random.default_rng(0), batch,
                                seq, workers)
    got = train_lm.token_stream(cfg, np.random.default_rng(0), batch, seq,
                                workers)
    for _ in range(3):
        a, b = next(got), next(want)
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int64
            np.testing.assert_array_equal(a[key].numpy(),
                                          np.asarray(b[key]))


def test_preset_is_the_examples():
    want = dataclasses.asdict(_example().preset_100m())
    got = dataclasses.asdict(train_lm.preset_100m())
    for key, value in want.items():
        if key in got:
            assert got[key] == (list(value) if isinstance(value, tuple)
                                and isinstance(got[key], list) else value), \
                key


@pytest.mark.parametrize("args", [
    ["--flecs", "--flecs-m", "2"], ["--flecs"], ["--flecs", "--flecs-m",
                                                 "1", "--remat"], []],
    ids=["flecs-m2", "flecs-m0", "flecs-m1-remat", "adam"])
def test_driver_runs_on_the_cpu(args, capsys):
    out = train_lm.main(["--smoke", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "16"] + args)
    text = capsys.readouterr().out
    assert "arch=tinyllama-1.1b-smoke" in text
    assert "step    0 loss" in text and "step    2 loss" in text
    assert "s/step" in text
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    if "--flecs" in args:
        assert all(m["uplink_mbits"] > 0 for m in out["metrics"])


def test_flecs_m2_spends_more_uplink_than_m0():
    """m = 2 sends each leaf's two compressed HVP columns beside its
    gradient difference: three times the first-order payload."""
    runs = [train_lm.main(["--smoke", "--device", "cpu", "--steps", "1",
                           "--batch", "2", "--seq", "16", "--flecs",
                           "--flecs-m", str(m)]) for m in (0, 2)]
    m0, m2 = (r["metrics"][0]["uplink_mbits"] for r in runs)
    np.testing.assert_allclose(m2, 3 * m0, rtol=1e-6)
    assert runs[0]["metrics"][0]["loss"] == runs[1]["metrics"][0]["loss"]


def test_checkpoint_restores_in_both_packages(tmp_path, capsys):
    out = train_lm.main(["--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--flecs",
                         "--flecs-m", "2", "--checkpoint",
                         str(tmp_path / "ck")])
    assert "checkpoint saved to" in capsys.readouterr().out
    back, step = store.restore(tmp_path / "ck", out["params"])
    assert step == 2
    for a, b in zip(tree_leaves(back), tree_leaves(out["params"])):
        assert torch.equal(a, b)
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                        {k: v for k, v in out["params"].items()},
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    ref_tree, ref_step = ref_store.restore(tmp_path / "ck", like)
    assert ref_step == 2
    for a, b in zip(tree_leaves(out["params"]), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--smoke", "--steps", "1"])
