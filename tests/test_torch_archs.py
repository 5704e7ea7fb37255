"""The other model families of repro_torch's serving and training paths
(SSM, RG-LRU, MLA, MoE, VLM image embeds, audio codebooks) against the JAX
package, on the CPU, whole model by whole model.

Models, each at smoke size (``reduce_for_smoke``; float32 weights from key
0): mamba2-1.3b (SSM, no FFN), recurrentgemma-9b (RG-LRU and a local
window), deepseek-v3-671b (MLA, a dense and a MoE layer with a shared
expert), qwen3-moe-235b-a22b (GQA and MoE), llava-next-mistral-7b (image
embeds over the first 8 positions), musicgen-large (4 codebooks), gemma2-9b
at ``head_dim = 256`` (the flash forward's new pair), and deepseek's
smoke config with ``v_head_dim = 24`` against qk_nope + qk_rope = 32 (MLA
at Dk != Dv).  Batch 2 x 24, 5 greedy steps; the reference is jitted once
per model and shared.

Tolerances, each with its reason:
* ``init_params``: rtol 1e-6, atol 1e-7 — the uniforms are the reference's
  bit for bit, ``random.normal``'s erfinv agrees with XLA's to a few ulps.
  At the erfinv polynomial's switch (w = -log1p(-u²) = 5, |z| ~ 2.94) a
  last-ulp difference in ``log1p`` (torch's vectorised and scalar paths
  differ, and which elements take which depends on how the CPU splits the
  tensor across threads) picks the other polynomial, 2.5e-4 apart there:
  so at most 1e-3 of a leaf's elements may differ by up to rtol 1e-3;
* prefill and decode logits, from the same weights
  (``convert.params_from_reference``): max |Δ| <= 1e-5 · max |logits|
  (float32 matmuls, the SSD's contractions and the RG-LRU scan combined in
  another order); caches rtol = atol = 1e-5; greedy ids and MoE routing
  ids equal wherever the margin (top-1 over top-2 logit, k-th over
  (k+1)-th router probability) exceeds that bound;
* the loss with the router loss: rtol 1e-5; gradients of ``_loss_fn``
  against ``jax.value_and_grad`` of the reference's: max |Δ| <= 1e-4 ·
  max |g| per leaf (float32 products and their transposes summed in
  another order through 2-4 layers; the SSD's and the scan's backward
  differ in order too; measured below 2e-5);
* prefill plus decode against the port's own full forward over the same
  tokens: max |Δ| <= 1e-5 · max |logits| (chunked SSD and scans against
  their one-step forms).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import CPU_CTX
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import moe as ref_moe
from repro.models import prefill as ref_prefill
from repro.train.step import _loss_fn as ref_loss_fn
from repro_torch import convert, random
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.model import (decode_step, forward, head_logits,
                                      init_params, prefill)
from repro_torch.train.step import value_and_grad

ARCH = {"mamba2": "mamba2-1.3b", "recurrentgemma": "recurrentgemma-9b",
        "deepseek": "deepseek-v3-671b", "qwen3moe": "qwen3-moe-235b-a22b",
        "llava": "llava-next-mistral-7b", "musicgen": "musicgen-large",
        "gemma2_256": "gemma2-9b", "mla_dv": "deepseek-v3-671b"}
#: Smoke widths changed per test model: the flash forward's (256, 256),
#: MLA with a value head dim apart from the key's, and an RG-LRU width of
#: 256 (the smoke config keeps the full 4096, whose [4096, 4096] gates cost
#: the reference's jit ~15 s on the CPU).
WIDTHS = {"gemma2_256": dict(head_dim=256), "mla_dv": dict(v_head_dim=24),
          "recurrentgemma": dict(lru_width=256)}
MODELS = tuple(ARCH)
B, S, GEN = 2, 24, 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    parallel processes, and eight threads a process on a few cores spend
    their time waiting on each other (this file took 12x its time alone
    under the suite's six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name):
    """(reference config, port config) of one test model."""
    ref = ref_get_config(ARCH[name], smoke=True)
    port = get_config(ARCH[name], smoke=True)
    w = dict(WIDTHS.get(name, {}))
    if "lru_width" in w:
        lru = w.pop("lru_width")
        return tuple(dataclasses.replace(c, rglru=dataclasses.replace(
            c.rglru, lru_width=lru)) for c in (ref, port))
    return dataclasses.replace(ref, **w), dataclasses.replace(port, **w)


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


def _inputs(cfg, seed, length):
    """tokens [B, length] (or [B, length, C]), labels like them, and a
    VLM's image embeds [B, 8, D], from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    shape = (B, length, cfg.n_codebooks) if cfg.n_codebooks else (B, length)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape),
             "labels": rng.integers(0, cfg.vocab, shape)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(B, min(cfg.n_img_tokens, length), cfg.d_model)).astype(
                np.float32)
    return batch


def _jax_batch(batch, keys=("tokens", "image_embeds", "labels")):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items() if k in keys}


def _torch_batch(batch, keys=("tokens", "image_embeds", "labels")):
    return {k: torch.as_tensor(v) for k, v in batch.items() if k in keys}


@functools.lru_cache(maxsize=None)
def _reference_run(name):
    """The reference's weights, prompt, prefill and greedy decode, and its
    loss and gradients on a training batch (jitted; once per model)."""
    cfg, _ = _configs(name)
    params = ref_init_params(cfg, jax.random.key(0), jnp.float32)
    prompt = _inputs(cfg, 0, S)
    pre = jax.jit(functools.partial(ref_prefill, cfg=cfg, ctx=CPU_CTX,
                                    max_len=S + GEN))
    step = jax.jit(functools.partial(ref_decode_step, cfg=cfg, ctx=CPU_CTX))
    logits, cache = pre(params, _jax_batch(prompt, ("tokens",
                                                    "image_embeds")))
    out = {"params": _np_tree(params), "prompt": prompt,
           "prefill_cache": _np_tree(cache), "logits": [np.asarray(logits)],
           "fed": []}
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(S, S + GEN):
        out["fed"].append(np.array(tok, np.int64))
        logits, cache = step(params, cache, {"tokens": tok}, pos=jnp.int32(t))
        out["logits"].append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out["final_cache"] = _np_tree(cache)
    train = _inputs(cfg, 1, S)
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        ref_loss_fn, cfg=cfg, ctx=CPU_CTX)))(params, _jax_batch(train))
    out.update(train=train, loss=float(loss), grads=_np_tree(grads))
    return out


def _port_params(name):
    return convert.params_from_reference(_reference_run(name)["params"],
                                         "cpu")


def _assert_logits(got, want, what=""):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (what, err)


def _clear(logits, bound):
    """Positions whose top-1 logit leads the top-2 by more than 2 bound."""
    top2 = torch.as_tensor(np.array(logits)).topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 2 * bound


def _assert_tree(got, want, rtol, what):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want), what
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, (what, path)
        np.testing.assert_allclose(leaf.float().numpy(), want[path],
                                   rtol=rtol, atol=rtol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", MODELS)
def test_init_params_match_reference(name):
    _, cfg = _configs(name)
    want = dict(_leaves(_reference_run(name)["params"]))
    got = dict(_leaves(init_params(cfg, random.key(0, "cpu"), torch.float32)))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape, path
        assert leaf.dtype == torch.float32, path
        a, w = leaf.numpy(), want[path]
        off = np.abs(a - w) > 1e-7 + 1e-6 * np.abs(w)
        assert off.mean() <= 1e-3, (path, off.sum())
        np.testing.assert_allclose(a, w, rtol=1e-3, atol=1e-7, err_msg=path)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_reference(name):
    _, cfg = _configs(name)
    ref = _reference_run(name)
    params = _port_params(name)
    batch = _torch_batch(ref["prompt"], ("tokens", "image_embeds"))
    logits, cache = prefill(params, batch, cfg, max_len=S + GEN)
    tail = (cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks else (cfg.vocab,)
    assert logits.shape == (B, 1) + tail
    _assert_logits(logits, ref["logits"][0], "prefill")
    _assert_tree(cache, ref["prefill_cache"], 1e-5, "prefill cache")
    for i, tok in enumerate(ref["fed"]):
        want = ref["logits"][i]
        sure = _clear(want, 1e-5 * np.abs(want).max())
        assert torch.equal(logits.argmax(-1)[sure],
                           torch.as_tensor(tok)[sure]), i
        logits, cache = decode_step(params, cache,
                                    {"tokens": torch.as_tensor(tok)}, S + i,
                                    cfg)
        _assert_logits(logits, ref["logits"][i + 1], f"step {i}")
    _assert_tree(cache, ref["final_cache"], 1e-5, "final cache")


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_equal_the_full_forward(name):
    """The logits of a prefill over the prompt and of decode steps fed the
    next tokens are the full forward's over the whole sequence."""
    _, cfg = _configs(name)
    ref = _reference_run(name)
    params = _port_params(name)
    prompt = _torch_batch(ref["prompt"], ("tokens", "image_embeds"))
    fed = torch.stack([torch.as_tensor(t) for t in ref["fed"]], dim=1)
    whole = dict(prompt, tokens=torch.cat([prompt["tokens"], fed[:, :, 0]],
                                          dim=1))
    hidden, _ = forward(params, whole, cfg)
    want = head_logits(params, hidden, cfg)          # [B, S + GEN, ...]
    bound = 1e-5 * float(want.abs().max())
    logits, cache = prefill(params, prompt, cfg, max_len=S + GEN)
    got = [logits[:, 0]]
    for i in range(GEN - 1):
        logits, cache = decode_step(params, cache, {"tokens": fed[:, i]},
                                    S + i, cfg)
        got.append(logits[:, 0])
    err = float((torch.stack(got, 1) - want[:, S - 1:S + GEN - 1]).abs()
                .max())
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_gradients_match_reference(name):
    """The loss, with the router loss where the model has MoE layers, and
    every gradient leaf, from the same weights and batch."""
    _, cfg = _configs(name)
    ref = _reference_run(name)
    loss, grads = value_and_grad(_port_params(name),
                                 _torch_batch(ref["train"]), cfg)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    want = dict(_leaves(ref["grads"]))
    got = dict(_leaves(grads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-30), (path, err)


@pytest.mark.parametrize("name", ["deepseek", "qwen3moe"])
def test_moe_routing_ids_match_reference(name, monkeypatch):
    """Every MoE layer's routing in the prefill: the port's ids are the
    reference ``_route``'s on the same input wherever the k-th and
    (k+1)-th probabilities part by more than 1e-5, and the router loss
    enters the port's loss."""
    ref_cfg, cfg = _configs(name)
    ref = _reference_run(name)
    seen = []
    route = moe.route

    def recording(params, x, c):
        seen.append((params, x))
        return route(params, x, c)

    monkeypatch.setattr(moe, "route", recording)
    prefill(_port_params(name), _torch_batch(ref["prompt"], ("tokens",)),
            cfg)
    assert len(seen) == sum(f == "moe" for _, f in cfg.layer_plan)
    k = cfg.moe.top_k
    for params, x in seen:
        _, ids, aux = route(params, x, cfg)
        _, want, want_aux = ref_moe._route(
            {"router": params["router"].numpy()}, x.numpy(), ref_cfg)
        probs = torch.softmax(x @ params["router"], -1)
        top = probs.topk(k + 1, dim=-1).values
        sure = ((top[:, :-1] - top[:, 1:]) > 1e-5).all(-1)
        assert sure.float().mean() > 0.9
        assert torch.equal(ids[sure], torch.as_tensor(np.array(want))[sure]
                           .long())
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("name", ["deepseek", "mamba2"])
def test_params_from_reference_keep_the_mixed_dtypes(name):
    """The reference's bf16 weights carry across with their float32 leaves
    (the MoE router; the SSM's A_log, dt_bias and D_skip) and bf16 bits,
    and the port's own bf16 init gives every leaf the same dtype: its
    float32 leaves within ``init_params``'s rtol 1e-6, its bf16 leaves the
    same bits but where a float32 ulp moves a value across a bf16 rounding
    tie (at most 1e-3 of a leaf's elements, by one bf16 ulp)."""
    ref_cfg, cfg = _configs(name)
    want = _np_tree(ref_init_params(ref_cfg, jax.random.key(0)))
    got = convert.params_from_reference(want, "cpu")
    own = dict(_leaves(init_params(cfg, random.key(0, "cpu"),
                                   torch.bfloat16)))
    floats = {"moe/router", "mixer/A_log", "mixer/dt_bias", "mixer/D_skip"}
    for path, leaf in _leaves(got):
        w = dict(_leaves(want))[path]
        f32 = any(path.endswith(f + "/") for f in floats)
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(w, np.float32), path)
        assert own[path].dtype == leaf.dtype, path
        if f32:
            torch.testing.assert_close(own[path], leaf, rtol=1e-6, atol=1e-7)
            continue
        off = own[path] != leaf
        assert off.float().mean() <= 1e-3, (path, int(off.sum()))
        torch.testing.assert_close(own[path], leaf, rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("arch", sorted(set(ARCH.values())))
def test_serve_runs_every_family_on_the_cpu(arch):
    out = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "10", "--gen", "3"])
    cfg = get_config(arch, smoke=True)
    tail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    assert out["generated"].shape == (2, 3) + tail
    assert out["logits"].shape == (4, 2) + tail + (cfg.vocab,)
    assert torch.isfinite(out["logits"]).all()
    assert out["prefill_flash_launches"] == 0
