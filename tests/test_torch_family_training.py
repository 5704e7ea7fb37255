"""Training the other model families (``launch/train.py --arch``): one adam
step and one FLECS-CGD step (m = 0) of each family against the JAX
package's ``make_train_step`` and ``make_flecs_train_step``, on the CPU;
the training inputs of ``launch/inputs.py`` against the reference's
``input_specs``; the trainer's token stream.

Models: each family at smoke size (``reduce_for_smoke``) and depth 2, as
``DEPTH2`` picks its layers (a one-layer smoke plan repeated; for
recurrentgemma an RG-LRU layer and its local attention layer, at an RG-LRU
width of 256 as ``test_torch_archs.py`` takes it), gemma2 at head dim 256
(the flash kernels' (256, 256) pair); float32 weights from the reference's
key 0, carried leaf for leaf (``convert.params_from_reference``); one batch
of 2 x 16 from ``token_batches`` (the shapes of ``input_specs``: codebook
tokens [2, 16, 4] for musicgen, image embeds [2, 8, 128] in bf16 for
llava), handed to both.  The port runs through ``launch/train.train``, as
its CLI does (remat on, adam at lr 3e-3, FLECS-CGD at alpha = 30 · lr).
The reference's FLECS-CGD step runs on a 1x1 debug mesh, as in
``test_torch_train.py``; each family's two reference steps are jitted once
and shared.

Tolerances, each with its reason (``test_torch_train.py``'s, with the
families' gradient tolerance of ``test_torch_archs.py``):
* loss (and adam's grad norm) rtol 1e-5;
* adam's params: a step moves a weight by about lr · g / (|g| + eps), so
  where |g| is as small as the gradients' float32 noise the two steps
  differ by up to ~lr: at most 1e-3 of the elements may differ by more
  than 1e-6, none by more than 2 · lr; its state: m = (1 - b1) g within
  1e-4 · max |m| per leaf and v = (1 - b2) g² within 2e-4 · max |v| (the
  gradients' bound, doubled by the square), t equal;
* FLECS-CGD: ``uplink_mbits`` exactly (every leaf's payload bits, summed
  in the reference's leaf order); a level differs where a gradient that
  differs in its last bits moves y - floor(y) across its uniform, so the
  shifts may differ at no more than 1e-3 of the elements, each by at most
  a level step (γ · scale, scale <= max |h̄| / 127 · 2) and a bf16 ulp of
  the shift (each side rounds h + γ · c to bf16: measured up to 1.13 level
  steps on deepseek's embedding), and the params by at most
  α · 2 · max |h̄| / 127 + 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import InputShape as RefInputShape
from repro.core.dl_flecs import FlecsDLConfig as RefFlecsDLConfig
from repro.core.dl_flecs import make_flecs_train_step as ref_flecs_step
from repro.launch.inputs import input_specs as ref_input_specs
from repro.launch.mesh import make_debug_mesh
from repro.launch.sharding import batch_specs, named_shardings
from repro.models import CPU_CTX
from repro.models import init_params as ref_init_params
from repro.models.context import ModelContext
from repro.optim import optimizers as ref_optimizers
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import inputs
from repro_torch.launch import train as train_launch
from repro_torch.tree import tree_leaves

LR = 3e-3
ALPHA = LR * 30
B, S = 2, 16
#: Each family's depth-2 plan: indices into its smoke plan.
DEPTH2 = {"mamba2-1.3b": (0, 0), "recurrentgemma-9b": (0, 2),
          "gemma2-9b": (0, 1), "deepseek-v3-671b": (0, 1),
          "qwen3-moe-235b-a22b": (0, 0), "llava-next-mistral-7b": (0, 0),
          "musicgen-large": (0, 0)}
FAMILIES = tuple(DEPTH2)
#: The ten configs of the registry.
CONFIGS = FAMILIES + ("tinyllama-1.1b", "gemma3-27b", "yi-34b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    parallel processes, and eight threads a process on a few cores spend
    their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _depth2(cfg):
    """A config cut (or repeated) to the two layers of ``DEPTH2``, gemma2
    at head dim 256 and recurrentgemma's RG-LRU at width 256."""
    plan = tuple(cfg.layer_plan[i] for i in DEPTH2[cfg.arch_id.replace(
        "-smoke", "")])
    cfg = dataclasses.replace(cfg, n_layers=2, layer_plan=plan)
    if cfg.arch_id.startswith("gemma2"):
        cfg = dataclasses.replace(cfg, head_dim=256)
    if cfg.rglru is not None:
        cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, lru_width=256))
    return cfg


def _configs(arch):
    return (_depth2(ref_get_config(arch, smoke=True)),
            _depth2(get_config(arch, smoke=True)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg):
    """The trainer's first batch (``token_batches``, seed 0), and the same
    batch for the reference: tokens and labels int32, image embeds bf16."""
    port = next(train_launch.token_batches(cfg, B, S, "cpu"))
    ref = {k: (jnp.asarray(v.float().numpy(), jnp.bfloat16)
               if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy(),
                                                             jnp.int32))
           for k, v in port.items()}
    return ref, port


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's weights, one adam step and one FLECS-CGD step (m =
    0, 1x1 debug mesh) on the trainer's first batch; once per family."""
    ref_cfg, cfg = _configs(arch)
    params = ref_init_params(ref_cfg, jax.random.key(0), jnp.float32)
    batch, _ = _batch(cfg)
    opt = ref_optimizers.get_optimizer("adam", LR)
    step = jax.jit(ref_make_train_step(ref_cfg, CPU_CTX, opt))
    a_params, a_state, a_m = step(params, opt.init(params), batch)
    out = {"params": _np(params),
           "adam": (_np(a_params), _np(a_state),
                    {k: float(v) for k, v in a_m.items()})}
    mesh = make_debug_mesh((1, 1), ("data", "model"))
    ctx = ModelContext(mesh=mesh, data_axes=("data",), remat=True)
    pa = jax.eval_shape(lambda: params)
    ba = jax.eval_shape(lambda: batch)
    lower = ref_flecs_step(ref_cfg, ctx, RefFlecsDLConfig(alpha=ALPHA, m=0))
    jitted, shifts_abs = lower.build(
        pa, ba, named_shardings(pa, mesh),
        named_shardings(ba, mesh, batch_specs(ba, mesh, ("data",))))
    shifts = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), shifts_abs)
    f_params, f_shifts, f_m = jitted(params, shifts, batch, jnp.int32(0))
    out["flecs"] = (_np(f_params), _np(f_shifts),
                    {k: float(v) for k, v in f_m.items()})
    return out


def _flat(tree):
    return np.concatenate([t.float().numpy().reshape(-1)
                           for t in tree_leaves(tree)])


def _ref_flat(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree.leaves(tree)])


def _port_run(arch, flecs):
    _, cfg = _configs(arch)
    params = convert.params_from_reference(_reference_run(arch)["params"],
                                           "cpu")
    _, batch = _batch(cfg)
    return train_launch.train(cfg, params, iter([batch]), 1, flecs=flecs)


@pytest.mark.parametrize("arch", FAMILIES)
def test_adam_step_matches_reference(arch):
    out = _port_run(arch, flecs=False)
    want_p, want_state, want_m = _reference_run(arch)["adam"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(out["metrics"][0][k], want_m[k],
                                   rtol=1e-5)
    diff = np.abs(_flat(out["params"]) - _ref_flat(want_p))
    assert (diff > 1e-6).mean() <= 1e-3, (diff > 1e-6).mean()
    assert diff.max() <= 2 * LR, diff.max()
    state = out["state"]
    assert int(state["t"]) == int(want_state["t"])
    for name, rel in (("m", 1e-4), ("v", 2e-4)):
        got, want = tree_leaves(state[name]), jax.tree.leaves(
            want_state[name])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.shape == b.shape
            err = float(np.abs(a.numpy() - b).max())
            assert err <= rel * max(float(np.abs(b).max()), 1e-30), (
                name, a.shape, err)


@pytest.mark.parametrize("arch", FAMILIES)
def test_flecs_step_matches_reference(arch):
    out = _port_run(arch, flecs=True)
    want_p, want_shifts, want_m = _reference_run(arch)["flecs"]
    m = out["metrics"][0]
    assert np.float32(m["uplink_mbits"]) == np.float32(want_m["uplink_mbits"])
    np.testing.assert_allclose(m["loss"], want_m["loss"], rtol=1e-5)
    scale = np.abs(_ref_flat(want_shifts["mean"])).max()
    level = 0.5 * 2 * scale / 127
    for name in ("own", "mean"):
        got, want = _flat(out["state"][name]), _ref_flat(want_shifts[name])
        assert (got != want).mean() <= 1e-3, (name, (got != want).mean())
        # a level step, plus a bf16 ulp (<= 2^-7 |h|): each side rounds
        # its h + γ · c to the shift's bf16
        bound = level + 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
        assert (np.abs(got - want) <= bound + 1e-6).all(), name
    assert np.abs(_flat(out["params"]) - _ref_flat(want_p)).max() <= (
        ALPHA * 2 * scale / 127 + 1e-6)


@pytest.mark.parametrize("arch", CONFIGS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(arch, kind):
    """The batch of every config and kind: the reference's shapes, its
    dtypes but the tokens' (int64 here, int32 there)."""
    ref_cfg = ref_get_config(arch, smoke=False)
    cfg = get_config(arch, smoke=False)
    shape = next(s for s in INPUT_SHAPES.values() if s.kind == kind)
    want = ref_input_specs(ref_cfg, RefInputShape(
        shape.name, shape.seq_len, shape.global_batch, shape.kind))
    got = inputs.input_specs(cfg, shape)
    assert sorted(got) == sorted(want)
    for name, (shp, dtype) in got.items():
        assert tuple(want[name].shape) == shp, name
        if name == "image_embeds":
            assert want[name].dtype == jnp.bfloat16
            assert dtype == torch.bfloat16
        else:
            assert want[name].dtype == jnp.int32
            assert dtype == torch.int64


def test_tinyllama_token_stream_is_unchanged():
    """A family without codebooks or image embeds draws [B, S + 1] a batch
    from ``default_rng(seed)``, tokens the first S, labels the last S,
    bit for bit as the trainer always has."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    stream = train_launch.token_batches(cfg, 3, 10, "cpu", seed=5)
    rng = np.random.default_rng(5)
    for _ in range(3):
        t = rng.integers(0, cfg.vocab, (3, 11))
        got = next(stream)
        assert sorted(got) == ["labels", "tokens"]
        assert got["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(got["tokens"].numpy(), t[:, :-1])
        np.testing.assert_array_equal(got["labels"].numpy(), t[:, 1:])


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-mistral-7b"])
def test_token_batches_follow_input_specs(arch):
    """Codebook tokens [B, S, C] with labels shifted along the sequence,
    and a VLM's bf16 image embeds drawn after the tokens."""
    cfg = get_config(arch, smoke=True)
    got = next(train_launch.token_batches(cfg, 2, 12, "cpu", seed=1))
    specs = inputs.input_specs(cfg, InputShape("t", 12, 2, "train"))
    assert sorted(got) == sorted(specs)
    for name, (shape, dtype) in specs.items():
        assert tuple(got[name].shape) == shape and got[name].dtype == dtype
    rng = np.random.default_rng(1)
    tok_shape = specs["tokens"][0]
    t = rng.integers(0, cfg.vocab, (2, 13, *tok_shape[2:]))
    np.testing.assert_array_equal(got["tokens"].numpy(), t[:, :-1])
    np.testing.assert_array_equal(got["labels"].numpy(), t[:, 1:])
    if "image_embeds" in specs:
        img = rng.normal(size=specs["image_embeds"][0]).astype(np.float32)
        torch.testing.assert_close(got["image_embeds"],
                                   torch.as_tensor(img).bfloat16())


def test_launcher_trains_every_family_at_a_depth_cut(capsys):
    """``--arch <family> --layers N`` on the CPU, with and without
    ``--flecs``: musicgen's codebooks, one layer."""
    for flecs in ([], ["--flecs"]):
        out = train_launch.main(["--device", "cpu", "--arch",
                                 "musicgen-large", "--layers", "1",
                                 "--steps", "1", "--batch", "2", "--seq",
                                 "8", *flecs])
        assert np.isfinite(out["metrics"][0]["loss"])
    text = capsys.readouterr().out
    assert "musicgen-large-smoke on cpu" in text and "uplink" in text
