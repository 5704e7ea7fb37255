"""repro_torch's serving path (configs, layers, attention, model, serve)
against the JAX package, on the CPU.

Models: tinyllama-1.1b at smoke size with 3 layers (global attention, GQA,
silu), and gemma2-9b at smoke size (local window 16 alternating with
global, attention and logit soft-caps, post-norms, tied embeddings, gelu).

Tolerances, each with its reason:
* configs: equal field for field (data literals);
* ``init_params``: rtol 1e-6, atol 1e-7 — the uniforms are the reference's
  bit for bit, and ``random.normal``'s erfinv agrees with XLA's to a few
  ulps (tests/test_torch_random.py);
* layers: rtol = atol = 1e-6 (float32, elementwise ops and small matmuls);
* prefill and decode logits, from the same weights
  (``convert.params_from_reference``): max |Δ| <= 1e-5 · max |logits|
  (float32 matmuls summed in another order over 2-3 layers), caches
  rtol = atol = 1e-5; greedy ids equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs.base import uniform_plan as ref_uniform_plan
from repro.models import CPU_CTX
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import prefill as ref_prefill
from repro_torch import convert, random
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import uniform_plan
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.model import (decode_step, forward, head_logits,
                                      init_cache, init_params, prefill)

MODELS = ("tinyllama3", "gemma2")


def _configs(name):
    """(reference config, port config) of one test model."""
    if name == "tinyllama3":
        ref = ref_get_config("tinyllama-1.1b", smoke=True)
        ref = dataclasses.replace(ref, n_layers=3, layer_plan=ref_uniform_plan(
            3, *ref.layer_plan[0]))
        port = get_config("tinyllama-1.1b", smoke=True)
        port = dataclasses.replace(port, n_layers=3, layer_plan=uniform_plan(
            3, *port.layer_plan[0]))
        return ref, port
    return (ref_get_config("gemma2-9b", smoke=True),
            get_config("gemma2-9b", smoke=True))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    """(path, leaf) of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for p, leaf in _leaves(tree[k]):
                yield f"{k}/{p}", leaf
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            for p, leaf in _leaves(t):
                yield f"{i}/{p}", leaf
    else:
        yield "", tree


@functools.lru_cache(maxsize=None)
def _reference_run(name, B=2, S=24, gen=5):
    """The reference's weights, prompt, prefill and greedy decode (jitted;
    computed once per model and shared by the tests below)."""
    cfg, _ = _configs(name)
    params = ref_init_params(cfg, jax.random.key(0), jnp.float32)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    pre = jax.jit(functools.partial(ref_prefill, cfg=cfg, ctx=CPU_CTX,
                                    max_len=S + gen))
    step = jax.jit(functools.partial(ref_decode_step, cfg=cfg, ctx=CPU_CTX))
    logits, cache = pre(params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    out = {"params": _np_tree(params), "tokens": tokens,
           "prefill_cache": _np_tree(cache), "logits": [np.asarray(logits)],
           "fed": []}
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(S, S + gen):
        out["fed"].append(np.array(tok, np.int64))
        logits, cache = step(params, cache, {"tokens": tok}, pos=jnp.int32(t))
        out["logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return out


def _assert_logits(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("arch", ref_list_archs())
def test_configs_are_the_reference_copies(arch):
    assert list_archs() == ref_list_archs()
    for smoke in (False, True):
        want = dataclasses.asdict(ref_get_config(arch, smoke=smoke))
        got = dataclasses.asdict(get_config(arch, smoke=smoke))
        assert got == want
        assert (get_config(arch, smoke=smoke).layer_groups()
                == ref_get_config(arch, smoke=smoke).layer_groups())


def test_layers_match_reference():
    g = np.random.default_rng(0)
    x = g.normal(size=(2, 5, 3, 32)).astype(np.float32) * 3
    scale = g.normal(size=(32,)).astype(np.float32)
    t = torch.as_tensor

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    close(layers.rms_norm(t(x), t(scale)), ref_layers.rms_norm(x, scale))
    close(layers.softcap(t(x), 2.5), ref_layers.softcap(x, 2.5))
    assert layers.softcap(t(x), 0.0) is not None
    for act in ("silu", "gelu"):
        close(layers.act_fn(act)(t(x)), ref_layers.act_fn(act)(x))
    np.testing.assert_array_equal(layers.rope_freqs(32, 10000.0),
                                  ref_layers.rope_freqs(32, 10000.0))
    pos = np.arange(5)[None, :] + np.array([[0], [7]])
    close(layers.apply_rope(t(x), t(pos), 10000.0),
          ref_layers.apply_rope(x, jnp.asarray(pos), 10000.0))
    ffn_ref = ref_layers.init_ffn(jax.random.key(3), 32, 48, jnp.float32)
    ffn_port = layers.init_ffn(random.key(3, "cpu"), 32, 48, torch.float32)
    for name in ffn_ref:
        np.testing.assert_allclose(ffn_port[name].numpy(),
                                   np.asarray(ffn_ref[name]), rtol=1e-6,
                                   atol=1e-7)
    ffn_ref = _np_tree(ffn_ref)
    for act in ("silu", "gelu"):
        close(layers.ffn(convert.params_from_reference(ffn_ref, "cpu"),
                         t(x[..., 0, :]), act),
              ref_layers.ffn(ffn_ref, x[..., 0, :], act))


@pytest.mark.parametrize("name", MODELS)
def test_init_params_matches_reference(name):
    _, cfg = _configs(name)
    want = dict(_leaves(_reference_run(name)["params"]))
    got = dict(_leaves(init_params(cfg, random.key(0, "cpu"), torch.float32)))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape, path
        assert leaf.dtype == torch.float32, path
        np.testing.assert_allclose(leaf.numpy(), want[path], rtol=1e-6,
                                   atol=1e-7, err_msg=path)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_reference(name):
    _, cfg = _configs(name)
    ref = _reference_run(name)
    params = convert.params_from_reference(ref["params"], "cpu")
    B, S = ref["tokens"].shape
    gen = len(ref["fed"])
    batch = {"tokens": torch.as_tensor(ref["tokens"])}
    logits, cache = prefill(params, batch, cfg, max_len=S + gen)
    assert logits.shape == (B, 1, cfg.vocab)
    _assert_logits(logits, ref["logits"][0])
    # forward runs the same blocks without capturing caches
    hidden, aux = forward(params, batch, cfg)
    assert hidden.shape == (B, S, cfg.d_model) and float(aux) == 0.0
    assert torch.equal(head_logits(params, hidden[:, -1:], cfg), logits)
    want_cache = dict(_leaves(ref["prefill_cache"]))
    got_cache = dict(_leaves(cache))
    assert sorted(got_cache) == sorted(want_cache)
    for path, leaf in got_cache.items():
        np.testing.assert_allclose(leaf.numpy(), want_cache[path], rtol=1e-5,
                                   atol=1e-5, err_msg=path)
    for i, tok in enumerate(ref["fed"]):
        tok = torch.as_tensor(tok)
        assert torch.equal(logits.argmax(-1), tok)
        logits, cache = decode_step(params, cache, {"tokens": tok}, S + i,
                                    cfg)
        _assert_logits(logits, ref["logits"][i + 1])


def test_init_cache_mirrors_the_block_structure():
    _, cfg = _configs("gemma2")
    cache = init_cache(cfg, batch=2, max_len=40, dtype=torch.float32)
    shapes = [c["k"].shape for group in cache for c in group]
    # local layer: a ring of `window` slots; global layer: max_len slots
    assert shapes == [(1, 2, 16, 2, 32), (1, 2, 40, 2, 32)]


def test_serve_runs_on_the_cpu():
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "9",
                      "--gen", "3"])
    assert out["generated"].shape == (2, 3)
    assert out["logits"].shape == (4, 2, 512)
    assert torch.isfinite(out["logits"]).all()
    assert out["prefill_flash_launches"] == 0


def test_params_from_reference_keeps_structure_and_bf16_bits():
    tree = {"a": [np.arange(3, dtype=np.float32)],
            "b": np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))}
    got = convert.params_from_reference(tree, "cpu")
    assert got["a"][0].dtype == torch.float32
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  np.asarray(tree["b"], np.float32))
