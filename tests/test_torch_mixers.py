"""The other model families' modules of repro_torch (``layers.causal_conv1d``,
``models/ssm.py``, ``models/rglru.py``, ``models/mla.py``, ``models/moe.py``,
the flash forward's plain version at the new head dims, the sliced weight
draw) against the JAX package, on the CPU, module by module.

Inputs from numpy seeds; the reference functions are jitted (eager JAX
compiles every primitive per shape).  Tolerances, each with its reason:
* ``causal_conv1d``: float32 rtol = atol = 1e-6 (K products summed in the
  same order); bfloat16 equal bit for bit (the same taps rounded in the same
  order);
* ``ssd_scan``, ``ssm_forward``/``ssm_decode``, ``rglru_forward``/
  ``rglru_decode``, ``mla_forward``/``mla_decode``: max |Δ| <= 1e-5 ·
  max |out| (float32 contractions in another order: the SSD's four-operand
  einsums split into two-operand steps, the RG-LRU's associative scan a
  sequential one), states rtol = atol = 1e-5;
* ``route``: ids equal wherever the k-th and (k+1)-th probabilities part by
  more than 1e-5, weights and router loss rtol 1e-5; ``moe_ref`` max |Δ|
  <= 1e-5 · max |out|;
* the sorted dispatch against the plain gather formula: float32 max |Δ| <=
  1e-5 · max |out| (the same products as matmuls of another shape);
  bfloat16 <= 2e-2 · max |out| (bf16 matmul outputs rounded apart);
* ``attention_ref`` against ``chunked_attention``: rtol = atol = 1e-5 at
  head dim 256 with a window and a cap, and at Dk 48 / Dv 32;
* the sliced draw (``random.normal_cast``) equal bit for bit to the
  whole-leaf draw.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro_torch import convert, random
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import layers, mla, model, moe, rglru, ssm


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    parallel processes, and eight threads a process on a few cores spend
    their time waiting on each other (``test_torch_archs.py`` took 12x
    its time alone under the suite's six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return convert.params_from_reference(_np(tree), "cpu")


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), err


def _cfg(arch, **widths):
    return (dataclasses.replace(ref_get_config(arch, smoke=True), **widths),
            dataclasses.replace(get_config(arch, smoke=True), **widths))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    x, w = _x((2, 9, 6)), _x((4, 6), 1)
    state = _x((2, 3, 6), 2) if with_state else None
    want, want_state = jax.jit(ref_layers.causal_conv1d)(x, w, state)
    got, got_state = layers.causal_conv1d(
        torch.as_tensor(x), torch.as_tensor(w),
        None if state is None else torch.as_tensor(state))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_state.numpy(), want_state)
    # bfloat16: the same taps, rounded where the reference rounds them
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    want = np.asarray(jax.jit(ref_layers.causal_conv1d)(xb, wb)[0],
                      np.float32)
    got = layers.causal_conv1d(*(convert.params_from_reference(
        [np.asarray(xb), np.asarray(wb)], "cpu")))[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("S, chunk, init", [(24, 8, False), (24, 7, True),
                                             (5, 8, False)])
def test_ssd_scan_matches_reference(S, chunk, init):
    """Chunks of 8, a chunk that does not divide S (the largest divisor
    below it, 6), and S below the chunk; with a carried state."""
    g = np.random.default_rng(3)
    B, H, P, N = 2, 3, 4, 5
    xh, Bm, Cm = _x((B, S, H, P), 4), _x((B, S, N), 5), _x((B, S, N), 6)
    dt = g.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    A_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    s0 = _x((B, H, P, N), 7) if init else None
    want_y, want_s = jax.jit(ref_ssm.ssd_scan, static_argnums=5)(
        xh, dt, A_log, Bm, Cm, chunk, s0)
    t = torch.as_tensor
    got_y, got_s = ssm.ssd_scan(t(xh), t(dt), t(A_log), t(Bm), t(Cm), chunk,
                                None if s0 is None else t(s0))
    _close(got_y, want_y)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5, atol=1e-5)


def _mixer_params(ref_init, cfg, key=3):
    p = ref_init(jax.random.key(key), cfg, jnp.float32)
    return p, _port(p)


def test_ssm_forward_and_decode_match_reference():
    ref_cfg, cfg = _cfg("mamba2-1.3b")
    p_ref, p = _mixer_params(ref_ssm.init_ssm, ref_cfg)
    x = _x((2, 20, cfg.d_model), 8)
    out, (state, convs) = jax.jit(functools.partial(
        ref_ssm.ssm_forward, cfg=ref_cfg))(p_ref, x)
    got, (got_state, got_convs) = ssm.ssm_forward(p, torch.as_tensor(x), cfg)
    _close(got, out)
    np.testing.assert_allclose(got_state.numpy(), state, rtol=1e-5,
                               atol=1e-5)
    for k in ("x", "B", "C"):
        np.testing.assert_allclose(got_convs[k].numpy(), convs[k], rtol=1e-6,
                                   atol=1e-6)
    cache_ref = {"state": state, "conv_x": convs["x"], "conv_B": convs["B"],
                 "conv_C": convs["C"]}
    cache = {k: torch.as_tensor(np.array(v)) for k, v in cache_ref.items()}
    step = jax.jit(functools.partial(ref_ssm.ssm_decode, cfg=ref_cfg))
    for i in range(3):
        x1 = _x((2, 1, cfg.d_model), 20 + i)
        out, cache_ref = step(p_ref, x1, cache_ref)
        got, cache = ssm.ssm_decode(p, torch.as_tensor(x1), cache, cfg)
        _close(got, out)
        for k, v in cache_ref.items():
            np.testing.assert_allclose(cache[k].numpy(), v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def _rglru_cfg():
    ref_cfg, cfg = _cfg("recurrentgemma-9b")
    return tuple(dataclasses.replace(c, rglru=dataclasses.replace(
        c.rglru, lru_width=64)) for c in (ref_cfg, cfg))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_forward_and_decode_match_reference(with_h0):
    ref_cfg, cfg = _rglru_cfg()
    p_ref, p = _mixer_params(ref_rglru.init_rglru, ref_cfg)
    own = rglru.init_rglru(random.key(3, "cpu"), cfg, torch.float32)
    np.testing.assert_array_equal(own["lam"].numpy(), np.asarray(p_ref["lam"]))
    x = _x((2, 20, cfg.d_model), 9)
    h0 = _x((2, 64), 10) if with_h0 else None
    conv0 = _x((2, 3, 64), 11) if with_h0 else None
    out, (h, conv) = jax.jit(functools.partial(
        ref_rglru.rglru_forward, cfg=ref_cfg))(p_ref, x, h0=h0,
                                               conv_state=conv0)
    t = torch.as_tensor
    got, (got_h, got_conv) = rglru.rglru_forward(
        p, t(x), cfg, h0=None if h0 is None else t(h0),
        conv_state=None if conv0 is None else t(conv0))
    _close(got, out)
    np.testing.assert_allclose(got_h.numpy(), h, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_conv.numpy(), conv, rtol=1e-6, atol=1e-6)
    cache_ref = {"state": h, "conv": conv}
    cache = {k: t(np.array(v)) for k, v in cache_ref.items()}
    step = jax.jit(functools.partial(ref_rglru.rglru_decode, cfg=ref_cfg))
    for i in range(3):
        x1 = _x((2, 1, cfg.d_model), 30 + i)
        out, cache_ref = step(p_ref, x1, cache_ref)
        got, cache = rglru.rglru_decode(p, t(x1), cache, cfg)
        _close(got, out)
        np.testing.assert_allclose(cache["state"].numpy(), cache_ref["state"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v_head_dim", [32, 24])
def test_mla_forward_and_decode_match_reference(v_head_dim):
    """qk_nope + qk_rope = 32 against a value head dim of 32 and of 24."""
    ref_cfg, cfg = _cfg("deepseek-v3-671b", v_head_dim=v_head_dim)
    p_ref, p = _mixer_params(ref_mla.init_mla, ref_cfg)
    S, gen = 12, 3
    x = _x((2, S, cfg.d_model), 12)
    out = jax.jit(functools.partial(ref_mla.mla_forward, cfg=ref_cfg))(
        p_ref, x)
    got, c_kv, k_rope = mla.mla_forward(p, torch.as_tensor(x), cfg)
    _close(got, out)
    pos = jnp.arange(S)[None, :]
    _, _, want_ckv, want_krope = ref_mla._latents(p_ref, x, ref_cfg, pos)
    np.testing.assert_allclose(c_kv.numpy(), want_ckv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(k_rope.numpy(), want_krope, rtol=1e-5,
                               atol=1e-5)
    pad = ((0, 0), (0, gen), (0, 0))
    cache_ref = {"c_kv": jnp.pad(want_ckv, pad),
                 "k_rope": jnp.pad(want_krope, pad)}
    cache = {k: torch.as_tensor(np.array(v)) for k, v in cache_ref.items()}
    step = jax.jit(functools.partial(ref_mla.mla_decode, cfg=ref_cfg))
    for i in range(gen):
        x1 = _x((2, 1, cfg.d_model), 40 + i)
        out, cache_ref = step(p_ref, x1, cache_ref, S + i)
        got, cache = mla.mla_decode(p, torch.as_tensor(x1), cache, S + i, cfg)
        _close(got, out)
        for k, v in cache_ref.items():
            np.testing.assert_allclose(cache[k].numpy(), v, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen3-moe-235b-a22b"])
def test_route_and_moe_ref_match_reference(arch):
    ref_cfg, cfg = _cfg(arch)
    p_ref, p = _mixer_params(ref_moe.init_moe, ref_cfg)
    assert p["router"].dtype == torch.float32
    x = _x((40, cfg.d_model), 13)
    w, ids, aux = jax.jit(functools.partial(ref_moe._route, cfg=ref_cfg))(
        p_ref, x)
    got_w, got_ids, got_aux = moe.route(p, torch.as_tensor(x), cfg)
    k = cfg.moe.top_k
    top = torch.softmax(torch.as_tensor(x) @ p["router"], -1).topk(
        k + 1, -1).values
    sure = ((top[:, :-1] - top[:, 1:]) > 1e-5).all(-1)
    assert sure.float().mean() > 0.9
    assert torch.equal(got_ids[sure], torch.as_tensor(np.array(ids))[sure]
                       .long())
    np.testing.assert_allclose(got_w.numpy()[sure.numpy()],
                               np.asarray(w)[sure.numpy()], rtol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-5)
    out, aux = jax.jit(functools.partial(ref_moe.moe_ref, cfg=ref_cfg))(
        p_ref, x.reshape(2, 20, -1))
    got, got_aux = moe.moe_ref(p, torch.as_tensor(x).view(2, 20, -1), cfg)
    assert got.shape == (2, 20, cfg.d_model)
    _close(got, out)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-5)


@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_sorted_dispatch_is_the_gather_formula(dtype, rel):
    """``moe_forward`` (the main path) against ``moe_ref`` on the same
    weights: 64 tokens over 8 experts, top 3, experts with no token
    included; the same router loss."""
    _, cfg = _cfg("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=3))
    p = moe.init_moe(random.key(5, "cpu"), cfg, dtype)
    x = torch.as_tensor(_x((4, 16, cfg.d_model), 14)).to(dtype)
    want, want_aux = moe.moe_ref(p, x, cfg)
    got, aux = moe.moe_forward(p, x, cfg)
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, want.float().numpy(), rel)
    assert torch.equal(aux, want_aux)
    # a token whose experts all but one lie idle
    one = x[:1, :1]
    _close(moe.moe_forward(p, one, cfg)[0], moe.moe_ref(p, one, cfg)[0]
           .float().numpy(), rel)


@pytest.mark.parametrize("shape, window, cap", [
    ((1, 4, 2, 40, 256, 256), 16, 50.0), ((2, 2, 1, 33, 256, 256), 0, 0.0),
    ((1, 4, 4, 24, 48, 32), 0, 0.0), ((2, 2, 1, 20, 192, 128), 7, 30.0)])
def test_attention_ref_at_new_head_dims_matches_chunked_attention(
        shape, window, cap):
    B, H, KV, S, Dk, Dv = shape
    q, k, v = (_x(s, i) for i, s in enumerate(
        ((B, S, H, Dk), (B, S, KV, Dk), (B, S, KV, Dv))))
    want = jax.jit(functools.partial(ref_attention.chunked_attention,
                                     window=window, cap=cap))(q, k, v)
    got = fa_ops.attention(*(torch.as_tensor(a) for a in (q, k, v)),
                           window=window, cap=cap)
    assert got.shape == (B, S, H, Dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    kt = [torch.as_tensor(a).transpose(1, 2) for a in (q, k, v)]
    assert torch.equal(fa_ref.attention_ref(*kt, window, cap),
                       got.transpose(1, 2))


def test_card_checks_name_the_head_dims_they_take():
    """On the card the forward takes its built (Dk, Dv) pairs, gemma2's
    (256, 256) and MLA's (192, 128) among them; the float32 backward takes
    the same pairs, the bfloat16 backward refuses the two new ones, and the
    tangents refuse them, each naming the queue item that brings them.
    Called on the shapes alone (on the CPU the plain version serves every
    dim)."""
    for dk, dv in ((256, 256), (192, 128), (64, 64)):
        fa_ops.check_forward_dims(dk, dv)
    with pytest.raises(ValueError, match=r"head dims \(48, 48\)"):
        fa_ops.check_forward_dims(48, 48)
    with pytest.raises(ValueError, match=r"head dims \(192, 192\)"):
        fa_ops.check_forward_dims(192, 192)
    for dk, dv in fa_ops.FWD_HEAD_DIMS:
        fa_ops.check_backward_dims(dk, dv, torch.float32)
    with pytest.raises(ValueError, match=r"\(192, 192\)"):
        fa_ops.check_backward_dims(192, 192, torch.float32)
    for dk, dv in ((256, 256), (192, 128)):
        with pytest.raises(ValueError, match="'bf16 family backward'"):
            fa_ops.check_backward_dims(dk, dv, torch.bfloat16)
        with pytest.raises(ValueError, match="'family HVPs'"):
            fa_ops.check_tangent_dims(dk, dv)
    for d in fa_ops.HEAD_DIMS:
        fa_ops.check_backward_dims(d, d, torch.bfloat16)
        fa_ops.check_tangent_dims(d, d)


def test_dual_remat_refuses_a_moe_layer():
    """Remat under forward AD would drop a MoE layer's router loss: the
    layer raises, naming the queue item, and never returns zero."""
    _, cfg = _cfg("qwen3-moe-235b-a22b")
    params = model.init_params(cfg, random.key(0, "cpu"), torch.float32)
    sp = model._unstack(params["blocks"][0][0], 1)[0]
    x = torch.as_tensor(_x((1, 6, cfg.d_model), 15))
    pos = torch.arange(6)[None, :]
    with fwAD.dual_level():
        xd = fwAD.make_dual(x, torch.ones_like(x))
        with pytest.raises(NotImplementedError, match="'family HVPs'"):
            model._block_remat(sp, xd, cfg.layer_plan[0], cfg, pos)


def test_sliced_draw_is_the_whole_leaf_draw(monkeypatch):
    """``random.normal_cast`` in slices of 4,096 counters (a shorter last
    one), scaled and cast to bfloat16 slice by slice, equals the cast of
    the whole-leaf draw bit for bit; the model's init draws through it.
    The leaf (19,200 elements) and the slices are multiples of 32 and
    below torch's 32,768-element grain, so no element takes ``log1p``'s
    scalar tail path on either side."""
    key = random.split(random.key(7, "cpu"), 3)[1]
    shape = (3, 50, 128)
    s = np.float32(0.125)
    whole = random.normal(key, shape)
    monkeypatch.setitem(random._SLICE, "cpu", 4096)
    for dtype in (torch.float32, torch.bfloat16):
        got = random.normal_cast(key, shape, dtype, lambda z: z * s)
        assert got.dtype == dtype and got.shape == shape
        assert torch.equal(got, (whole * s).to(dtype))
    assert torch.equal(layers.init_normal(key, shape, 0.125, torch.float32),
                       whole * s)
