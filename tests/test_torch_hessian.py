"""Hessian-vector products (core/hessian.py), attention's tangents and the
sketch of the m > 0 FLECS-CGD step, against the JAX package on the CPU.

* ``hvp`` / ``sketched_hessian`` on a quadratic plus a log-sum-exp term
  against ``repro.core.hessian``'s: rtol 1e-5 (float32 products summed in
  another order);
* ``hvp_pytree`` through the smoke tinyllama's ``_loss_fn`` (2 layers)
  against the reference's on the same weights and batch: max |Δ| <=
  2e-5 · max |Hv| per leaf (twice the gradients' 1e-5: the tangent pass
  differentiates the gradient's own float32 sums once more); with remat
  the port's HVP is its HVP without remat bit for bit (the same ops on the
  same values);
* attention's tangent plain versions (``ref.attention_jvp_ref``,
  ``ref.attention_backward_jvp_ref``) against ``jax.jvp`` of the
  reference's ``chunked_attention`` (of its ``jax.vjp`` for the backward)
  and against ``torch.autograd.forward_ad`` through ``ref.attention_ref``:
  max |Δ| <= 1e-5 · max |t| (float32 einsums in another order);
* the ``FlashAttention`` Functions' wiring (jvp, the backward's own jvp,
  remat) with the kernels' launches replaced by their plain versions on
  CPU tensors: the HVP through them within 1e-5 · max |Hv| of the plain
  path's, with every tangent launch counted;
* ``_tensor_sketch``, the sketch signs and the Y compression keys bit for
  bit the reference's; ``_fedsonia_tensor`` on the same inputs within
  rtol 1e-5 (QR, SVD and eigh of LAPACK on both sides, sums in another
  order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from repro.core import dl_flecs as ref_dl_flecs
from repro.core import hessian as ref_hessian
from repro.models import CPU_CTX
from repro.models.attention import chunked_attention
from repro.train.step import _loss_fn as ref_loss_fn
from repro_torch import random
from repro_torch.core import dl_flecs, hessian
from repro_torch.kernels import dual
from repro_torch.kernels.compressor import ops as c_ops
from repro_torch.kernels.dither import ops as d_ops
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers, model
from repro_torch.train.step import _loss_fn, value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

import test_torch_train as tt


# ---------------------------------------------------------------------------
# hvp, sketched_hessian on a small function
# ---------------------------------------------------------------------------

def _problem(seed=0, d=12):
    g = np.random.default_rng(seed)
    A = g.normal(size=(d, d)).astype(np.float32)
    A = (A @ A.T / d).astype(np.float32)
    C = g.normal(size=(5, d)).astype(np.float32)
    w = g.normal(size=d).astype(np.float32)
    return A, C, w


def _f_torch(w, A, C):
    return 0.5 * w @ (A @ w) + torch.logsumexp(C @ w, dim=0)


def _f_jax(w, A, C):
    return 0.5 * w @ (A @ w) + jax.nn.logsumexp(C @ w)


@pytest.mark.parametrize("seed", [0, 1])
def test_hvp_matches_reference(seed):
    A, C, w = _problem(seed)
    v = np.random.default_rng(10 + seed).normal(size=w.shape).astype(
        np.float32)
    want = ref_hessian.hvp(_f_jax, jnp.asarray(w), jnp.asarray(v),
                           jnp.asarray(A), jnp.asarray(C))
    got = hessian.hvp(_f_torch, torch.as_tensor(w), torch.as_tensor(v),
                      torch.as_tensor(A), torch.as_tensor(C))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("m", [1, 3])
def test_sketched_hessian_matches_reference(m):
    A, C, w = _problem(2)
    S = np.random.default_rng(m).normal(size=(w.shape[0], m)).astype(
        np.float32)
    want = ref_hessian.sketched_hessian(_f_jax, jnp.asarray(w),
                                        jnp.asarray(S), jnp.asarray(A),
                                        jnp.asarray(C))
    got = hessian.sketched_hessian(_f_torch, torch.as_tensor(w),
                                   torch.as_tensor(S), torch.as_tensor(A),
                                   torch.as_tensor(C))
    assert got.shape == (w.shape[0], m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_hvp_of_a_quadratic_is_its_matrix():
    A, C, w = _problem(3)
    v = torch.randn(w.shape[0], generator=torch.Generator().manual_seed(0))
    got = hessian.hvp(lambda x, M: 0.5 * x @ (M @ x), torch.as_tensor(w), v,
                      torch.as_tensor(A))
    torch.testing.assert_close(got, torch.as_tensor(A) @ v, rtol=1e-5,
                               atol=1e-6)


def test_leaf_outside_the_graph_has_a_zero_hvp():
    got = hessian.hvp_pytree(lambda p: (p["a"] ** 3).sum(),
                             {"a": torch.ones(3), "b": torch.ones(2)},
                             {"a": torch.ones(3), "b": torch.ones(2)})
    assert torch.equal(got["b"], torch.zeros(2))
    assert torch.equal(got["a"], torch.full((3,), 6.0))


# ---------------------------------------------------------------------------
# hvp_pytree through the model
# ---------------------------------------------------------------------------

def _tangent_np(seed=7):
    g = np.random.default_rng(seed)
    return jax.tree.map(lambda p: g.choice([-1.0, 1.0], size=p.shape).astype(
        np.float32), tt._reference_params())


@functools.lru_cache(maxsize=None)
def _reference_hvp():
    ref_cfg, _ = tt._configs()
    ref_batch, _ = tt._batch()
    params = jax.tree.map(jnp.asarray, tt._reference_params())
    v = jax.tree.map(jnp.asarray, _tangent_np())
    fn = jax.jit(lambda p, t, b: ref_hessian.hvp_pytree(
        lambda pp, bb: ref_loss_fn(pp, bb, ref_cfg, CPU_CTX), p, t, b))
    return [np.asarray(x) for x in jax.tree.leaves(fn(params, v, ref_batch))]


@functools.lru_cache(maxsize=None)
def _port_hvp(remat):
    _, cfg = tt._configs()
    _, batch = tt._batch()
    v = tt.convert.params_from_reference(_tangent_np(), "cpu")
    return hessian.hvp_pytree(
        lambda p, b: _loss_fn(p, b, cfg, remat), tt._params(), v, batch)


def test_hvp_pytree_matches_reference_on_the_model():
    got = tree_leaves(_port_hvp(False))
    want = _reference_hvp()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 2e-5 * np.abs(b).max()


def test_hvp_pytree_with_remat_is_without_remat_bitwise():
    for a, b in zip(tree_leaves(_port_hvp(True)),
                    tree_leaves(_port_hvp(False))):
        assert torch.equal(a, b)


def test_hvp_remat_does_not_use_torch_checkpoint(monkeypatch):
    """Under a dual level remat goes through the model's own
    ``_dual_remat``: ``torch.utils.checkpoint`` refuses forward AD in some
    torch releases (an ``autograd.Function`` without ``jvp``)."""
    def refuse(*args, **kwargs):
        raise NotImplementedError("no jvp")

    monkeypatch.setattr(model, "checkpoint", refuse)
    _, cfg = tt._configs()
    _, batch = tt._batch()
    v = tt.convert.params_from_reference(_tangent_np(), "cpu")
    got = hessian.hvp_pytree(lambda p, b: _loss_fn(p, b, cfg, True),
                             tt._params(), v, batch)
    for a, b in zip(tree_leaves(got), tree_leaves(_port_hvp(False))):
        assert torch.equal(a, b)


def test_dual_remat_gives_torch_checkpoints_bits(monkeypatch):
    """On inputs without tangents ``_dual_remat`` gives the loss and
    gradients that ``torch.utils.checkpoint`` (the gradient pass's remat)
    gives, bit for bit: the two remats differ in what they recompute, not
    in what they compute."""
    _, cfg = tt._configs()
    _, batch = tt._batch()
    want = value_and_grad(tt._params(), batch, cfg, remat=True)

    def dual_remat(fn, sp, x, m, cfg, positions, **kwargs):
        leaves, treedef = tree_flatten(sp)
        return model._dual_remat(
            lambda *ts: fn(tree_unflatten(treedef, list(ts[:-1])), ts[-1],
                           m, cfg, positions)[0],
            *leaves, x), torch.zeros(())

    monkeypatch.setattr(model, "checkpoint", dual_remat)
    got = value_and_grad(tt._params(), batch, cfg, remat=True)
    assert torch.equal(got[0], want[0])
    for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert torch.equal(a, b)


def test_hvp_pytree_matches_reverse_over_reverse():
    """Forward over reverse against a double backward of the same port
    loss (the Hessian is symmetric): max |Δ| <= 1e-5 · max |Hv|."""
    _, cfg = tt._configs()
    _, batch = tt._batch()
    params = tt._params()
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    v = tree_leaves(tt.convert.params_from_reference(_tangent_np(), "cpu"))
    _, treedef = tree_flatten(params)
    loss = _loss_fn(tree_unflatten(treedef, leaves), batch, cfg)
    g = torch.autograd.grad(loss, leaves, create_graph=True)
    want = torch.autograd.grad(sum((a * b).sum() for a, b in zip(g, v)),
                               leaves)
    for a, b in zip(tree_leaves(_port_hvp(False)), want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ---------------------------------------------------------------------------
# silu under forward AD
# ---------------------------------------------------------------------------

def test_silu_is_f_silu_outside_a_dual_level():
    x = torch.randn(50, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    g1 = torch.autograd.grad(layers.silu(x).sum(), x)[0]
    g2 = torch.autograd.grad(F.silu(x).sum(), x)[0]
    assert torch.equal(layers.silu(x), F.silu(x)) and torch.equal(g1, g2)


def test_silu_passes_forward_over_reverse():
    x0 = torch.randn(40, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2))
    t = torch.randn(40, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    with fwAD.dual_level():
        x = x0.clone().requires_grad_(True)
        y = layers.silu(fwAD.make_dual(x, t))
        tangent = fwAD.unpack_dual(y).tangent
        g = torch.autograd.grad((y ** 2).sum(), x)[0]
        hv = fwAD.unpack_dual(g).tangent
    xr = x0.clone().requires_grad_(True)
    yr = F.silu(xr)
    gr = torch.autograd.grad((yr ** 2).sum(), xr, create_graph=True)[0]
    hr = torch.autograd.grad((gr * t).sum(), xr)[0]
    torch.testing.assert_close(hv, hr, rtol=1e-12, atol=1e-12)
    xs = x0.clone().requires_grad_(True)
    slope = torch.autograd.grad(F.silu(xs).sum(), xs)[0]
    torch.testing.assert_close(tangent, t * slope, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# attention's tangents
# ---------------------------------------------------------------------------

TANGENT_SHAPES = [(2, 4, 2, 37, 32, 0, 0.0), (1, 4, 1, 64, 64, 9, 0.0),
                  (2, 2, 2, 20, 32, 5, 3.0), (1, 2, 1, 45, 128, 0, 30.0),
                  (1, 2, 2, 1, 32, 0, 0.0)]


def _attn_inputs(B, H, KV, S, D, seed=0):
    g = np.random.default_rng(seed)
    shapes = [(B, H, S, D), (B, KV, S, D), (B, KV, S, D)] * 2 + [
        (B, H, S, D)] * 2
    return [g.normal(size=s).astype(np.float32) for s in shapes]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, rel=1e-5):
    want = [_np(w) for w in want]
    scale = max(float(np.abs(w).max()) for w in want)
    for a, b in zip(got, want):
        a = _np(a)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * scale


def _to_model(x):
    return jnp.swapaxes(jnp.asarray(x), 1, 2)


@functools.lru_cache(maxsize=None)
def _jax_tangents(window, cap):
    def attn(q, k, v):
        return chunked_attention(q, k, v, window=window, cap=cap)

    def fwd(q, k, v, tq, tk, tv):
        return jax.jvp(attn, (q, k, v), (tq, tk, tv))

    def bwd(q, k, v, do, tq, tk, tv, tdo):
        def grads(q, k, v, do):
            return jax.vjp(attn, q, k, v)[1](do)
        return jax.jvp(grads, (q, k, v, do), (tq, tk, tv, tdo))[1]

    return jax.jit(fwd), jax.jit(bwd)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", TANGENT_SHAPES)
def test_tangent_plain_versions_match_jax_jvp(B, H, KV, S, D, window, cap):
    q, k, v, tq, tk, tv, do, tdo = _attn_inputs(B, H, KV, S, D)
    fwd, bwd = _jax_tangents(window, cap)
    m = [_to_model(x) for x in (q, k, v, tq, tk, tv, do, tdo)]
    o_want, to_want = fwd(*m[:6])
    t = [torch.as_tensor(x) for x in (q, k, v, tq, tk, tv, do, tdo)]
    o, to, lse, tlse = ref.attention_jvp_ref(*t[:6], window, cap)
    _close([o.transpose(1, 2)], [o_want])
    _close([to.transpose(1, 2)], [to_want])
    want = bwd(m[0], m[1], m[2], m[6], m[3], m[4], m[5], m[7])
    got = ref.attention_backward_jvp_ref(t[0], t[1], t[2], o, t[6], lse,
                                         t[3], t[4], t[5], to, t[7], tlse,
                                         window, cap)
    _close([x.transpose(1, 2) for x in got], want)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", TANGENT_SHAPES)
def test_tangent_plain_versions_match_forward_ad(B, H, KV, S, D, window,
                                                 cap):
    t = [torch.as_tensor(x) for x in _attn_inputs(B, H, KV, S, D, seed=1)]
    q, k, v, tq, tk, tv, do, tdo = t
    with fwAD.dual_level():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        duals = [fwAD.make_dual(x, tx) for x, tx in zip(leaves,
                                                        (tq, tk, tv))]
        out = ref.attention_ref(*duals, window, cap)
        o_want, to_want = fwAD.unpack_dual(out)
        grads = torch.autograd.grad(out, leaves, fwAD.make_dual(do, tdo))
        want = [fwAD.unpack_dual(g).tangent for g in grads]
    o, to, lse, tlse = ref.attention_jvp_ref(q, k, v, tq, tk, tv, window,
                                             cap)
    _close([o, to], [o_want, to_want])
    got = ref.attention_backward_jvp_ref(q, k, v, o, do, lse, tq, tk, tv,
                                         to, tdo, tlse, window, cap)
    _close(got, want)


def _tangent_sums(q, k, v, tq, tk, tv, window, cap):
    """The forward tangent's sums before its last step, from the plain
    version's pieces in the kernel layout: A = Σⱼ (P tS) V + P tV
    [B, H, S, D] and t_lse [B, H, S]; tO = A − t_lse·O."""
    B, H, S, D = q.shape
    s, ts0, c1, _, mask = ref._pairs(q, k, tq, tk, window, cap)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    pts = p * torch.where(mask, c1 * ts0, 0.0)
    a = (torch.einsum("bkgqs,bksd->bkgqd", pts, v.float())
         + torch.einsum("bkgqs,bksd->bkgqd", p, tv.float()))
    return a.reshape(B, H, S, D), pts.sum(dim=-1).reshape(B, H, S)


def test_forward_tangent_is_a_minus_t_lse_times_o():
    """The identity the forward-tangent kernel relies on: tO = A − t_lse·O
    with O the plain forward's output (not P V summed beside A), within
    1e-5 · max |tO|, at a window-and-cap shape."""
    t = [torch.as_tensor(x) for x in _attn_inputs(2, 4, 2, 45, 32, seed=2)]
    q, k, v, tq, tk, tv = t[:6]
    _, to, _, tlse = ref.attention_jvp_ref(q, k, v, tq, tk, tv, 7, 5.0)
    o = ref.attention_ref(q, k, v, 7, 5.0)
    a, tl = _tangent_sums(q, k, v, tq, tk, tv, 7, 5.0)
    _close([a - tl[..., None] * o], [to])
    _close([tl], [tlse])


def _plain_launches(monkeypatch):
    """Replace the four raw launches with their plain versions, writing
    into the outputs as the kernels do, so the Functions run on CPU
    tensors; each still refuses duals and counts its launch."""
    def launch(q, k, v, out, window, cap, lse=None):
        dual.refuse_duals("flash_attention", q, k, v, out, lse)
        o, _, l, _ = ref.attention_jvp_ref(q, k, v, q, k, v, window, cap)
        out.copy_(o)
        if lse is not None:
            lse.copy_(l)
        ops.launches["flash_attention"] += 1

    def launch_backward(q, k, v, out, dout, lse, dq, dk, dv, window, cap):
        dual.refuse_duals("flash_attention_backward", q, k, v, out, dout,
                          lse)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            g = torch.autograd.grad(ref.attention_ref(*leaves, window, cap),
                                    leaves, dout)
        for dst, src in zip((dq, dk, dv), g):
            dst.copy_(src)
        ops.launches["flash_attention_backward"] += 1

    def launch_jvp(q, k, v, out, lse, tq, tk, tv, tout, tlse, window, cap):
        dual.refuse_duals("flash_attention_jvp", q, k, v, out, lse, tq, tk,
                          tv)
        a, tl = _tangent_sums(q, k, v, tq, tk, tv, window, cap)
        tout.copy_(a - tl[..., None] * out)   # the forward's out, as given
        tlse.copy_(tl)
        ops.launches["flash_attention_jvp"] += 1

    def launch_backward_jvp(q, k, v, out, dout, lse, tq, tk, tv, tout, tdout,
                            tlse, tdq, tdk, tdv, window, cap):
        dual.refuse_duals("flash_attention_backward_jvp", q, k, v, out, dout,
                          lse, tq, tk, tv, tout, tdout, tlse)
        got = ref.attention_backward_jvp_ref(q, k, v, out, dout, lse, tq, tk,
                                             tv, tout, tdout, tlse, window,
                                             cap)
        for dst, src in zip((tdq, tdk, tdv), got):
            dst.copy_(src)
        ops.launches["flash_attention_backward_jvp"] += 1

    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(ops, "_launch_backward", launch_backward)
    monkeypatch.setattr(ops, "_launch_jvp", launch_jvp)
    monkeypatch.setattr(ops, "_launch_backward_jvp", launch_backward_jvp)


def _flash_hvps(monkeypatch, remat, head):
    """The HVP of ``head(o, q)`` (o attention's output in the model layout,
    window and cap) through the Functions with plain launches and through
    the plain path, and the launch counts of the Functions' run."""
    _plain_launches(monkeypatch)
    g = torch.Generator().manual_seed(4)
    B, S, H, KV, D, E = 2, 19, 4, 2, 32, 8
    W = [torch.randn(E, n * D, generator=g) * 0.3 for n in (H, KV, KV)]
    T = [torch.randn(w.shape, generator=g) for w in W]
    x = torch.randn(B, S, E, generator=g)

    def loss(ws, through_function):
        def block(*ts):
            q, k, v = ((ts[-1] @ w).view(B, S, -1, D) for w in ts[:-1])
            if through_function:
                o = ops.FlashAttention.apply(q, k, v, 3, 5.0, True)
            else:
                o = ref.attention_ref(*(t.transpose(1, 2)
                                        for t in (q, k, v)), 3,
                                      5.0).transpose(1, 2)
            return head(o, q)
        if remat:
            return model._dual_remat(block, *ws, x)
        return block(*ws, x)

    hv = {}
    for through in (False, True):
        ops.reset_launches()
        hv[through] = hessian.hvp_pytree(lambda ws: loss(ws, through), W, T)
    return hv[True], hv[False], dict(ops.launches)


def _hvp_counts(remat):
    n = 2 if remat else 1
    return {"flash_attention": n, "flash_attention_backward": 1,
            "flash_attention_jvp": n, "flash_attention_backward_jvp": 1}


@pytest.mark.parametrize("remat", [False, True])
def test_flash_functions_carry_the_hvp(monkeypatch, remat):
    """Forward over reverse through FlashAttention (jvp) and
    FlashAttentionBackward (jvp), model layout, window and cap, against
    the plain path's HVP; remat recomputes the forward and its tangent."""
    got, want, counts = _flash_hvps(
        monkeypatch, remat, lambda o, q: (o ** 2).sum() + (o * q).sum())
    assert counts == _hvp_counts(remat)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("remat", [False, True])
def test_flash_hvp_of_a_loss_linear_in_the_output(monkeypatch, remat):
    """A loss that reads attention's output through a constant, (o · c)
    summed, gives the backward a grad_out without a tangent while q, k and
    v carry theirs: the backward-tangent kernel still gets tO and t_lse
    (zeros there would be a wrong HVP), same tolerance as above."""
    c = torch.randn(2, 19, 4, 32, generator=torch.Generator().manual_seed(5))
    got, want, counts = _flash_hvps(monkeypatch, remat,
                                    lambda o, q: (o * c).sum())
    assert counts == _hvp_counts(remat)
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_flash_tangents_refuse_bfloat16(monkeypatch):
    _plain_launches(monkeypatch)
    q = torch.randn(1, 8, 2, 32).to(torch.bfloat16)
    with fwAD.dual_level():
        qd = fwAD.make_dual(q, torch.ones_like(q))
        with pytest.raises(TypeError, match="float32 only"):
            ops.FlashAttention.apply(qd, q, q, 0, 0.0, True)


# ---------------------------------------------------------------------------
# a dual never reaches a raw launch
# ---------------------------------------------------------------------------

def _dual_case():
    x = torch.randn(4, 8)
    return x, fwAD.make_dual(x, torch.ones_like(x))


def test_raw_flash_launches_refuse_duals():
    with fwAD.dual_level():
        x, xd = _dual_case()
        q = xd.view(1, 1, 4, 8)
        for call in (lambda: ops._launch(q, q, q, q, 0, 0.0),
                     lambda: ops._launch_backward(q, q, q, q, q, q, q, q, q,
                                                  0, 0.0),
                     lambda: ops._launch_jvp(*([q] * 10), 0, 0.0),
                     lambda: ops._launch_backward_jvp(*([q] * 15), 0, 0.0)):
            with pytest.raises(RuntimeError, match="dual tensor"):
                call()


def test_codec_and_compressor_launches_refuse_duals(monkeypatch):
    """On the card (``_on_card`` forced: the guard runs before any CUDA
    call) the dither codec's and the compressor's wrappers raise on a
    dual; on the CPU their plain versions carry the tangent through."""
    monkeypatch.setattr(d_ops, "_on_card", lambda t: True)
    monkeypatch.setattr(c_ops, "_on_card", lambda device: True)
    key = random.key(0, "cpu")
    with fwAD.dual_level():
        x, xd = _dual_case()
        for call in (
                lambda: d_ops.dither_encode_keyed(xd, key, block_rows=4),
                lambda: d_ops.dither_encode(xd, torch.rand(4, 8),
                                            block_rows=4),
                lambda: d_ops.dither_decode(
                    torch.zeros(4, 8, dtype=torch.int8),
                    fwAD.make_dual(torch.ones(1), torch.ones(1)),
                    block_rows=4),
                lambda: c_ops.fused_dither(xd, torch.rand(4, 8), 4.0),
                lambda: c_ops.fused_dither_keyed(xd, key, 4.0),
                lambda: c_ops.fused_topk(xd, 0.5),
                lambda: c_ops.fused_dither_keyed_grouped(
                    xd, key[None], torch.ones(1)),
                lambda: c_ops.dither_bits_grouped(
                    fwAD.make_dual(torch.ones(2), torch.ones(2)), 10)):
            with pytest.raises(RuntimeError, match="dual tensor"):
                call()


def test_attention_routes_duals_through_the_function():
    """On the card a dual operand without requires_grad still goes through
    FlashAttention (whose jvp launches the tangent kernel), never the bare
    forward launch."""
    assert ops._needs_grad(torch.zeros(1)) is False
    with fwAD.dual_level():
        _, xd = _dual_case()
        with torch.no_grad():
            assert ops._needs_grad(xd) is True


# ---------------------------------------------------------------------------
# the sketch, the Y keys and FedSONIA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,idx,shape,m", [(0, 0, (13, 11), 2),
                                              (5, 7, (3, 4, 5), 1),
                                              (2, 11, (257,), 3)])
def test_tensor_sketch_bit_for_bit(step, idx, shape, m):
    want = np.asarray(ref_dl_flecs._tensor_sketch(jnp.int32(step), idx,
                                                  shape, m))
    got = dl_flecs._tensor_sketch(step, idx, shape, m)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    signs = dl_flecs._sketch_signs(step, idx, int(np.prod(shape)), m,
                                   torch.device("cpu"))
    assert signs.dtype == torch.int8
    np.testing.assert_array_equal(np.sign(want), signs.numpy())


@pytest.mark.parametrize("col,i", [(0, 0), (1, 11), (3, 2)])
def test_y_keys_bit_for_bit(col, i):
    key0 = jax.random.fold_in(jax.random.key(29), 4)
    want = jax.random.key_data(jax.random.fold_in(
        jax.random.fold_in(key0, col), 1000 + i))
    k0 = random.fold_in(random.key(29, "cpu"), 4)
    got = random.fold_in(random.fold_in(k0, col), 1000 + i)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_fedsonia_tensor_matches_reference(m):
    g = np.random.default_rng(m)
    d = 40
    y = g.normal(size=(d, m)).astype(np.float32)
    V = g.choice([-1.0, 1.0], size=(d, m)).astype(np.float32)
    mmat = (V.T @ y).astype(np.float32)
    gv = g.normal(size=d).astype(np.float32)
    cfg = ref_dl_flecs.FlecsDLConfig(m=m)
    want = ref_dl_flecs._fedsonia_tensor(jnp.asarray(y), jnp.asarray(mmat),
                                         jnp.asarray(gv), cfg)
    got = dl_flecs._fedsonia_tensor(torch.as_tensor(y),
                                    torch.as_tensor(mmat),
                                    torch.as_tensor(gv),
                                    dl_flecs.FlecsDLConfig(m=m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_config_defaults_are_the_references():
    a, b = ref_dl_flecs.FlecsDLConfig(), dl_flecs.FlecsDLConfig()
    for name in ("alpha", "gamma", "s_levels", "m", "omega", "Omega", "rho",
                 "compress"):
        assert getattr(a, name) == getattr(b, name), name
