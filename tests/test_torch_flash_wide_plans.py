"""The plans of the flash-attention kernels at the wide head-dim pairs, on
the CPU: the float32 backward at (256, 256) and (192, 128) (one dK/dV and
one dQ launch of eight warps) and the bfloat16 forward on ``wgmma`` at
MLA's (192, 128), each emulated step by step in PyTorch and held to the
plain version and to the JAX package's ``chunked_attention``; and the
wrapper's routing (``ops.forward_plan``).

Tolerances: the backward 1e-5 · max |grad| over dq, dk and dv (float32's,
as ``tests/test_torch_flash_attention.py`` holds the 3xTF32 plan); the
bf16 forward rtol = atol = 2e-2 (one bf16 ulp of the output, row 7's).
The kernels themselves are held to the same plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash_attention as tfa
from repro_torch.kernels.flash_attention import ops, ref

#: q rows a dK/dV step of the wide backward (DKDV_STEP in
#: csrc/flash_attention.cu)
DKDV_STEP = 32


def dq_step(dk, dv):
    """Keys a dQ step of the wide backward (``dq_step`` in
    csrc/flash_attention.cu)."""
    return 32 if dk + dv <= 320 else 16


#: keys a KV tile of the wgmma forward at (192, 128) (wgf::fwd_bk)
WG_BK = 64
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    parallel processes, and eight threads a process on a few cores spend
    their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mask(S, window):
    pos = torch.arange(S)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    return keep


def _wide_backward(q, k, v, dout, window, cap):
    """The wide backward's arithmetic in the kernel layout: S^T and dP^T
    (or S and dP) as 3xTF32 over the whole depth, once a step; P from the
    plain forward's log-sum-exp (masked 0) and P dcap; dS = P dcap (dP -
    Delta); then, a step at a time, dV += P^T dO and dK += dS^T Q over
    ``DKDV_STEP`` q rows (steps over the group's heads, then the q rows), and
    dQ += dS K over ``dq_step`` keys, each step's product 3xTF32 on P^T,
    dS^T and dS split once as they are staged, summed apart and added to
    the running float32 sum."""
    B, H, S, Dk = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    G = H // KV
    scale = float(np.float32(1.0 / np.sqrt(Dk)))
    kk, vv = (t.repeat_interleave(G, dim=1) for t in (k, v))
    keep = _mask(S, window)

    def capped(s):
        if not cap:
            return s, torch.ones_like(s)
        th = torch.tanh(s / cap)
        return cap * th, 1.0 - th * th

    lse = torch.logsumexp(torch.where(keep, capped(
        (q @ kk.transpose(-1, -2)) * scale)[0], ref.NEG), -1, keepdim=True)
    out = ref.attention_ref(q, k, v, window, cap)
    delta = (dout * out).sum(-1, keepdim=True)
    x, dcap = capped(tfa._mm_3xtf32(q, kk.transpose(-1, -2)) * scale)
    p = torch.where(keep, torch.exp(x - lse), 0.0)
    ds = (p * dcap) * (tfa._mm_3xtf32(dout, vv.transpose(-1, -2)) - delta)

    step = DKDV_STEP
    pg, dsg = (t.reshape(B, KV, G, S, S) for t in (p, ds))
    qg, dog = (t.reshape(B, KV, G, S, -1) for t in (q, dout))
    dk = torch.zeros(B, KV, S, Dk)
    dv = torch.zeros(B, KV, S, Dv)
    for g in range(G):
        for lo in range(0, S, step):
            rows = slice(lo, lo + step)
            dv = dv + tfa._mm_3xtf32(pg[:, :, g, rows].transpose(-1, -2),
                                     dog[:, :, g, rows])
            dk = dk + tfa._mm_3xtf32(dsg[:, :, g, rows].transpose(-1, -2),
                                     qg[:, :, g, rows])
    dq = torch.zeros(B, H, S, Dk)
    for lo in range(0, S, dq_step(Dk, Dv)):
        keys = slice(lo, lo + dq_step(Dk, Dv))
        dq = dq + tfa._mm_3xtf32(ds[..., keys], kk[:, :, keys])
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("B,H,KV,S,dk,dv,window,cap", [
    # gemma2's window and cap under MQA at a ragged length, MLA's pair, and
    # recurrentgemma's band past the window
    pytest.param(1, 4, 1, 80, 256, 256, 24, 50.0, id="256-256-mqa-cap"),
    pytest.param(1, 4, 1, 72, 256, 256, 40, 0.0, id="256-256-band"),
    pytest.param(1, 4, 4, 72, 192, 128, 0, 0.0, id="192-128"),
    pytest.param(2, 2, 1, 53, 192, 128, 0, 20.0, id="192-128-cap-ragged"),
])
def test_wide_backward_plan_within_float32_tolerance(B, H, KV, S, dk, dv,
                                                     window, cap):
    """The wide backward's plan, emulated with its step of q rows and keys,
    its per-step sums added in float32 and P^T, dS^T and dS split as they
    are staged, stays within 1e-5 · max |grad| of the plain version's
    autograd and of jax.grad of the model's chunked_attention."""
    arrays = tfa._inputs(B, H, KV, S, dk, seed=12)
    arrays[2] = np.random.default_rng(13).normal(
        size=(B, KV, S, dv)).astype(np.float32)
    g = np.random.default_rng(14).normal(size=(B, H, S, dv)).astype(
        np.float32)
    q, k, v = tfa._port(arrays, torch.float32)
    dout = torch.as_tensor(g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(ref.attention_ref(*leaves, window, cap),
                                leaves, dout)
    want_jax = [np.swapaxes(np.asarray(w), 1, 2) for w in tfa._jitted_grad(
        window, cap)(*(jnp.swapaxes(t, 1, 2) for t in tfa._jax(
            arrays, jnp.float32)), jnp.swapaxes(jnp.asarray(g), 1, 2))]
    got = _wide_backward(q, k, v, dout, window, cap)
    scale = max(float(w.abs().max()) for w in plain)
    for a, b, c in zip(got, plain, want_jax):
        assert a.shape == b.shape == c.shape
        assert float((a - b).abs().max()) <= 1e-5 * scale
        assert float(np.abs(a.numpy() - c).max()) <= 1e-5 * scale


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _wgmma_forward(q, k, v, window, cap, bk=WG_BK):
    """The bf16 forward on wgmma, emulated: bf16 operands, S = Q K^T summed
    in float32 a KV tile of ``bk`` keys at a time; the score times log2 e
    (scale log2 e folded into one product, or cap tanh(s scale / cap) log2
    e), masked to NEG; the online softmax in base 2 (running max m, corr =
    2^(m - m_new), P = 2^(y - m_new)), the row sums l from the float32 P;
    O = O corr + P V with P rounded to bf16; O / l (l == 0 -> 1) rounded to
    bf16; the lse m ln 2 + ln l."""
    B, H, S, Dk = q.shape
    G = H // k.shape[1]
    scale = float(np.float32(1.0 / np.sqrt(Dk)))
    qf = _bf16(q)
    kk, vv = (_bf16(t).repeat_interleave(G, dim=1) for t in (k, v))
    keep = _mask(S, window)
    m = torch.full((B, H, S, 1), ref.NEG)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, v.shape[-1]))
    for lo in range(0, S, bk):
        hi = min(S, lo + bk)
        s = qf @ kk[:, :, lo:hi].transpose(-1, -2)
        y = (cap * torch.tanh(s * scale / cap) * LOG2E if cap
             else s * (scale * LOG2E))
        y = torch.where(keep[:, lo:hi], y, ref.NEG)
        m_new = torch.maximum(m, y.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(y - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _bf16(p) @ vv[:, :, lo:hi]
        m = m_new
    l = torch.where(l == 0, 1.0, l)
    return (acc / l).to(torch.bfloat16), (m * np.log(2.0) + torch.log(l))[
        ..., 0]


@pytest.mark.parametrize("B,H,KV,S,window,cap", [
    (1, 4, 4, 128, 0, 0.0),          # tile-multiple length
    (2, 4, 2, 200, 0, 0.0),          # ragged last tile
    (1, 4, 1, 130, 40, 20.0),        # window and cap, MQA
])
def test_wgmma_forward_plan_within_bf16_tolerance(B, H, KV, S, window, cap):
    """The bf16 forward on wgmma at (192, 128), emulated, stays within
    rtol = atol = 2e-2 of the plain version and of the model's
    chunked_attention in bfloat16, and its log-sum-exp within 1e-4 of the
    plain one's."""
    dk, dv = 192, 128
    arrays = tfa._inputs(B, H, KV, S, dk, seed=15)
    arrays[2] = np.random.default_rng(16).normal(
        size=(B, KV, S, dv)).astype(np.float32)
    q, k, v = tfa._port(arrays, torch.bfloat16)
    got, lse = _wgmma_forward(q, k, v, window, cap)
    want = ref.attention_ref(q, k, v, window, cap)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (B, H, S, dv)
    tfa._close(got, want.float().numpy(), 2e-2)
    chunked = tfa._jitted(window, cap)[1]
    jq, jk, jv = tfa._jax(arrays, jnp.bfloat16)
    want_jax = chunked(*(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)))
    tfa._close(got.transpose(1, 2), want_jax, 2e-2)
    G = H // KV
    s = (q.float() @ k.float().repeat_interleave(G, 1).transpose(-1, -2)
         / np.sqrt(dk))
    if cap:
        s = cap * torch.tanh(s / cap)
    want_lse = torch.logsumexp(torch.where(_mask(S, window), s, ref.NEG), -1)
    assert float((lse - want_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", ops.FWD_HEAD_DIMS)
def test_forward_plan_routes_only_bf16_mla_to_wgmma(dtype, pair):
    """bf16 at (192, 128) takes the wgmma forward; float32 at the wide
    pairs the eight-warp mma.sync kernel; every other (dtype, pair) keeps
    the mma.sync kernel."""
    want = ("wgmma" if dtype == torch.bfloat16 and pair == (192, 128)
            else "mma_sync_wide" if dtype == torch.float32
            and pair in ((256, 256), (192, 128)) else "mma_sync")
    assert ops.forward_plan(dtype, *pair) == want
    assert want in ops.FWD_KERNELS
    if want == "wgmma":
        assert pair in ops.WGMMA_FWD_HEAD_DIMS


def test_wgmma_forward_takes_bf16_at_its_pairs_only():
    """A forced wgmma launch of float32, or of a pair the kernel is not
    built for, raises before reaching the library."""
    q = torch.zeros(1, 2, 8, 192)
    k = torch.zeros(1, 2, 8, 192)
    v = torch.zeros(1, 2, 8, 128)
    out = torch.zeros(1, 2, 8, 128)
    with pytest.raises(ValueError, match="wgmma forward takes bfloat16"):
        ops._launch(q, k, v, out, 0, 0.0, kernel="wgmma")
    q32, k32 = q[..., :32].bfloat16(), k[..., :32].bfloat16()
    with pytest.raises(ValueError, match=r"\(32, 32\)"):
        ops._launch(q32, k32, k32, out[..., :32].bfloat16(), 0, 0.0,
                    kernel="wgmma")
    ops.reset_launches()
    assert ops.forward_launches_by_kernel == {"mma_sync": 0, "wgmma": 0,
                                              "mma_sync_wide": 0}
