"""The float32 forward at the wide head-dim pairs, (256, 256) and MLA's
(192, 128), on the CPU: ``flash_fwd_wide_kernel`` of
``csrc/flash_attention.cu`` (128 q rows a CTA, 16 a warp, eight warps
sharing each staged KV tile) emulated step by step in PyTorch and held to
the plain version and to the JAX package's ``chunked_attention``.

The emulation follows the kernel's plan: KV tiles of ``fwd_wide_bk`` keys;
each operand split into a TF32 high part and its remainder (``to_tf32``'s
rounding); S = Q K^T as its three 3xTF32 terms over the whole depth, the
two small ones summed apart and added to the large one; the score scaled,
capped and masked with the finite NEG; the online softmax of each row
(corr = exp(m - m_new)), O = O corr + P V with each tile's P V summed apart
and added in float32; a tile none of a warp's 16 rows sees left out for
those rows; O / l (l == 0 -> 1) and the log-sum-exp m + log l.

Tolerances: rtol = atol = 2e-5 for the output (float32's, as
``chip_smoke.check_forward`` holds the kernel on the card); 1e-4 for the
log-sum-exp, which the wide backward reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash_attention as tfa
from repro_torch.kernels.flash_attention import ops, ref

#: q rows a CTA and a warp (FWD_WIDE_BQ, and the warp's m tile)
CTA_ROWS, WARP_ROWS = 128, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    parallel processes, and eight threads a process on a few cores spend
    their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fwd_wide_bk(dk, dv):
    """Keys a KV tile (``fwd_wide_bk`` in csrc/flash_attention.cu)."""
    return 32 if dk + dv <= 320 else 16


def _split(x):
    """x = hi + lo as the kernel splits it: hi = to_tf32(x), lo = x - hi as
    the tensor core reads it (its low 13 mantissa bits dropped)."""
    hi = tfa._tf32(x)
    return hi, tfa._tf32_read(x - hi)


def _scores(q, k):
    """S = Q K^T as ``wide_scores`` sums it: the terms hi.lo and lo.hi in
    accumulators of their own, added to hi.hi at the end."""
    (qh, ql), (kh, kl) = _split(q), _split(k.transpose(-1, -2))
    return qh @ kh + (qh @ kl + ql @ kh)


def _wide_forward(q, k, v, window, cap):
    """The wide forward's arithmetic in the kernel layout: (output, lse)."""
    B, H, S, Dk = q.shape
    Dv = v.shape[-1]
    bk = fwd_wide_bk(Dk, Dv)
    G = H // k.shape[1]
    scale = float(np.float32(1.0 / np.sqrt(Dk)))
    kk, vv = (t.repeat_interleave(G, dim=1) for t in (k, v))
    pos = torch.arange(S)
    r0 = pos // WARP_ROWS * WARP_ROWS          # each row's warp's first row
    m = torch.full((B, H, S, 1), ref.NEG)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, Dv))
    for lo in range(0, S, bk):
        hi = min(S, lo + bk)
        # the rows whose warp sees some key of the tile
        live = (lo <= r0 + WARP_ROWS - 1)
        if window:
            live &= lo + bk - 1 > r0 - window
        live = live[:, None]
        x = _scores(q, kk[:, :, lo:hi]) * scale
        if cap:
            x = cap * torch.tanh(x / cap)
        keep = pos[:, None] >= pos[None, lo:hi]
        if window:
            keep &= (pos[:, None] - pos[None, lo:hi]) < window
        x = torch.where(keep, x, ref.NEG)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        part = tfa._mm_3xtf32(p, vv[:, :, lo:hi])     # summed apart
        l = torch.where(live, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(live, acc * corr + part, acc)
        m = torch.where(live, m_new, m)
    l = torch.where(l == 0, 1.0, l)
    return acc / l, (m + torch.log(l))[..., 0]


def _inputs(B, H, KV, S, dk, dv, seed):
    arrays = tfa._inputs(B, H, KV, S, dk, seed=seed)
    arrays[2] = np.random.default_rng(seed + 1).normal(
        size=(B, KV, S, dv)).astype(np.float32)
    return arrays


@pytest.mark.parametrize("B,H,KV,S,dk,dv,window,cap", [
    # gemma2's cap with a window, recurrentgemma's MQA band (window < S),
    # ragged lengths (past a multiple of neither the tile nor 128 rows),
    # MLA's pair causal over two CTAs, ragged, and with a window and cap
    pytest.param(1, 4, 2, 160, 256, 256, 40, 50.0, id="256-256-cap-window"),
    pytest.param(1, 4, 1, 144, 256, 256, 50, 0.0, id="256-256-mqa-band"),
    pytest.param(2, 2, 2, 150, 256, 256, 0, 30.0, id="256-256-ragged"),
    pytest.param(1, 4, 4, 256, 192, 128, 0, 0.0, id="192-128-causal"),
    pytest.param(2, 4, 2, 200, 192, 128, 0, 0.0, id="192-128-ragged"),
    pytest.param(1, 4, 1, 170, 192, 128, 64, 20.0,
                 id="192-128-mqa-window-cap"),
])
def test_wide_forward_plan_within_float32_tolerance(B, H, KV, S, dk, dv,
                                                    window, cap):
    """The wide forward's plan, emulated tile by tile, stays within rtol =
    atol = 2e-5 of the plain version and of the model's chunked_attention,
    and its log-sum-exp within 1e-4 of the plain scores' logsumexp."""
    arrays = _inputs(B, H, KV, S, dk, dv, seed=20)
    q, k, v = tfa._port(arrays, torch.float32)
    got, lse = _wide_forward(q, k, v, window, cap)
    want = ref.attention_ref(q, k, v, window, cap)
    assert got.shape == want.shape == (B, H, S, dv)
    tfa._close(got, want.numpy(), 2e-5)
    chunked = tfa._jitted(window, cap)[1]
    want_jax = chunked(*(jnp.swapaxes(t, 1, 2)
                         for t in tfa._jax(arrays, jnp.float32)))
    tfa._close(got.transpose(1, 2), want_jax, 2e-5)
    s = (q @ k.repeat_interleave(H // KV, 1).transpose(-1, -2)
         / np.sqrt(dk))
    if cap:
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(S)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    want_lse = torch.logsumexp(torch.where(keep, s, ref.NEG), -1)
    assert float((lse - want_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("pair", [(256, 256), (192, 128)])
def test_wide_forward_pairs_route_to_the_wide_kernel(pair):
    """float32 at each wide pair takes the eight-warp kernel
    ("mma_sync_wide", counted under that name) and bfloat16 does not; a
    launch forced onto the other mma.sync kernel raises before reaching
    the library, as does the wide kernel at a pair it is not built for."""
    assert pair in ops.FWD_HEAD_DIMS and pair in ops.BWD_HEAD_DIMS[
        torch.float32]
    assert ops.forward_plan(torch.float32, *pair) == "mma_sync_wide"
    assert ops.forward_plan(torch.bfloat16, *pair) != "mma_sync_wide"
    dk, dv = pair
    q, k = torch.zeros(1, 2, 8, dk), torch.zeros(1, 2, 8, dk)
    v, out = torch.zeros(1, 2, 8, dv), torch.zeros(1, 2, 8, dv)
    with pytest.raises(ValueError, match="mma_sync_wide forward"):
        ops._launch(q, k, v, out, 0, 0.0, kernel="mma_sync")
    q64 = q[..., :64]
    with pytest.raises(ValueError, match="mma_sync_wide forward"):
        ops._launch(q64, q64, q64, out[..., :64], 0, 0.0,
                    kernel="mma_sync_wide")
    ops.reset_launches()
    assert ops.forward_launches_by_kernel == {
        "mma_sync": 0, "wgmma": 0, "mma_sync_wide": 0}


def test_forward_launch_counters_reset_together():
    """``reset_launches`` clears the forward's counts by pair with the
    others."""
    ops.forward_launches_by_pair[("float32", 256, 256)] = 3
    ops.reset_launches()
    assert ops.forward_launches_by_pair == {}
    assert ops.launches["flash_attention"] == 0
