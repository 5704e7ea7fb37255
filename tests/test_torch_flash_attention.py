"""repro_torch.kernels.flash_attention against the JAX package, on the CPU.

The port's plain version (``ref.attention_ref``, the CPU path of ``ops``) is
held to the Pallas kernel in interpret mode, to the reference's own oracle
(``repro.kernels.flash_attention.ref.attention_ref``) and to the model's
``chunked_attention`` (its dense branch, and its chunked branches at
S = 1024), on the same numpy inputs.

Tolerances are those of the reference's kernel test (tests/test_kernels.py):
rtol = atol = 2e-5 in float32 (sums taken in another order), 2e-2 in
bfloat16 (one bf16 ulp of the output, rounded from float32 results that
differ in the last bits).  The card's kernel is held to the same plain
version in tests/test_torch_gpu.py and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import chunked_attention
from repro_torch.kernels.flash_attention import ops, ref

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    six parallel processes on a few cores, where eight threads a process
    spend their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the shapes of tests/test_kernels.py's flash-attention test
SHAPES = [
    (1, 4, 2, 256, 64, 0, 0.0),
    (2, 4, 4, 128, 32, 0, 50.0),
    (1, 8, 2, 512, 64, 128, 0.0),
    (2, 2, 1, 256, 128, 64, 30.0),
    (1, 2, 2, 384, 64, 0, 0.0),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, H, KV, S, D, seed=0, layout="kernel"):
    g = np.random.default_rng(seed)
    if layout == "kernel":
        shapes = ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))
    else:
        shapes = ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    return [g.normal(size=s).astype(np.float32) for s in shapes]


def _port(arrays, tdtype):
    return [torch.as_tensor(a).to(tdtype) for a in arrays]


def _jax(arrays, jdtype):
    return [jnp.asarray(a, jdtype) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jitted(window, cap):
    """The reference's two oracles, each compiled as one program (eager
    JAX compiles every primitive at every new shape, which costs seconds)."""
    oracle = jax.jit(functools.partial(jax_ref, window=window, cap=cap))
    chunked = jax.jit(functools.partial(chunked_attention, window=window,
                                        cap=cap))
    return oracle, chunked


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", [
    (1, 2, 1, 128, 32, 0, 0.0),
    (1, 4, 2, 128, 64, 48, 30.0),
])
def test_plain_version_matches_pallas_interpret(B, H, KV, S, D, window, cap):
    arrays = _inputs(B, H, KV, S, D, seed=1)
    want = pallas_flash(*_jax(arrays, jnp.float32), window=window, cap=cap,
                        block_q=64, block_k=64, interpret=True)
    got = ops.flash_attention(*_port(arrays, torch.float32), window=window,
                              cap=cap)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,KV,S,D,window,cap", SHAPES)
def test_plain_version_matches_reference_oracles(B, H, KV, S, D, window, cap,
                                                 dtype):
    jdtype, tdtype, tol = DTYPES[dtype]
    arrays = _inputs(B, H, KV, S, D)
    got = ref.attention_ref(*_port(arrays, tdtype), window=window, cap=cap)
    assert got.dtype == tdtype and got.shape == (B, H, S, D)
    oracle, chunked = _jitted(window, cap)
    jq, jk, jv = _jax(arrays, jdtype)
    _close(got, oracle(jq, jk, jv), tol)
    # the model's attention in model layout ([B, S, H, D]); S <= 512 takes
    # its dense branch
    want = chunked(*(jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv)))
    _close(got.transpose(1, 2), want, tol)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (300, 20.0)])
def test_plain_version_matches_chunked_branches(window, cap):
    """S = 1024 takes chunked_attention's chunked branches: the KV scan
    (no window) and the banded gather (window < S)."""
    B, H, KV, S, D = 1, 2, 1, 1024, 32
    arrays = _inputs(B, H, KV, S, D, seed=2, layout="model")
    want = _jitted(window, cap)[1](*_jax(arrays, jnp.float32))
    got = ops.attention(*_port(arrays, torch.float32), window=window, cap=cap)
    _close(got, want, 2e-5)


def test_model_layout_on_cpu_tensors():
    B, H, KV, S, D = 2, 4, 2, 96, 64
    q, k, v = _port(_inputs(B, H, KV, S, D, seed=3, layout="model"),
                    torch.float32)
    ops.reset_launches()
    out = ops.attention(q, k, v, window=40, cap=10.0)
    assert out.shape == (B, S, H, D)
    want = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), 40, 10.0).transpose(1, 2)
    assert torch.equal(out, want)
    # the CPU path takes the plain version: no launch is counted
    assert ops.launches == {"flash_attention": 0,
                            "flash_attention_backward": 0,
                            "flash_attention_jvp": 0,
                            "flash_attention_backward_jvp": 0}


def test_ragged_length_and_fully_masked_rows():
    """Any S (the Pallas wrapper needs S % 128 == 0); every output row is
    finite, including rows whose window leaves a whole tile masked."""
    q, k, v = _port(_inputs(1, 2, 1, 200, 32, seed=4), torch.float32)
    out = ops.flash_attention(q, k, v, window=7)
    assert torch.isfinite(out).all()
    # row 0 sees only key 0
    assert torch.equal(out[:, :, 0], v[:, [0, 0], 0])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _port(_inputs(1, 4, 2, 64, 64), torch.float32)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, k[:, :, :32], v[:, :, :32])
    # the card's forward takes its built (Dk, Dv) pairs only; on the CPU
    # the plain version takes any, v's apart from k's
    with pytest.raises(ValueError, match=r"head dims \(48, 48\)"):
        ops.check_forward_dims(48, 48)
    q48, k48, v48 = _port(_inputs(1, 4, 2, 64, 48), torch.float32)
    assert ops.flash_attention(q48, k48, v48[..., :32]).shape == (1, 4, 64,
                                                                  32)
    with pytest.raises(ValueError, match="k/v"):
        ops.flash_attention(q48, k, v)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q[:, :3], k, v)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v)


@functools.lru_cache(maxsize=None)
def _jitted_grad(window, cap):
    """jax.grad of <chunked_attention(q, k, v), g> by q, k and v."""
    def f(q, k, v, g):
        out = chunked_attention(q, k, v, window=window, cap=cap)
        return jnp.sum(out.astype(jnp.float32) * g)

    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", [
    (1, 4, 2, 64, 32, 0, 0.0),
    (2, 4, 1, 48, 32, 16, 30.0),
    (1, 2, 2, 96, 64, 7, 0.0),
    (1, 2, 1, 1024, 32, 300, 20.0),      # the banded chunked branch
])
def test_plain_version_gradients_match_jax_grad(B, H, KV, S, D, window, cap):
    """The counterpart of the card's backward kernel: the plain version
    under autograd against jax.grad of the model's chunked_attention, in
    model layout; max |Δ| <= 1e-5 · max |grad| over dq, dk and dv (float32
    sums in another order)."""
    arrays = _inputs(B, H, KV, S, D, seed=6, layout="model")
    g = np.random.default_rng(7).normal(size=(B, S, H, D)).astype(np.float32)
    want = _jitted_grad(window, cap)(*_jax(arrays, jnp.float32),
                                     jnp.asarray(g))
    qkv = [t.requires_grad_(True) for t in _port(arrays, torch.float32)]
    out = ops.attention(*qkv, window=window, cap=cap)
    got = torch.autograd.grad(out, qkv, torch.as_tensor(g))
    bound = 1e-5 * max(float(np.abs(np.asarray(w)).max()) for w in want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= bound


def _tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to a 10-bit mantissa, ties away
    from zero (add half of the dropped 13 bits to the pattern, clear
    them; the sign bit is not touched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(x):
    """A float32 operand as the TF32 tensor core reads it: its low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the backward kernel computes it for float32 inputs: each
    operand split x = hi + lo, hi = tf32(x), lo = x - hi passed as it is
    (the tensor core reads its top 19 bits), and a_hi b_lo + a_lo b_hi +
    a_hi b_hi summed in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_read(a - a_hi), _tf32_read(b - b_hi)
    return a_hi @ b_lo + a_lo @ b_hi + a_hi @ b_hi


def _mm_tf32(a, b):
    """a @ b with each operand rounded to TF32 once (one mma.sync)."""
    return _tf32(a) @ _tf32(b)


def _backward_by_products(q, k, v, dout, window, cap, mm):
    """The backward kernels' arithmetic in the kernel layout, each of the
    five products by ``mm``: P from the plain forward's log-sum-exp, masked
    entries 0; dV = P^T dO, dP = dO V^T, dS = P (dP - Delta) (1 - tanh^2
    under a cap), dQ = dS K scale, dK = dS^T Q scale (P and dS split like
    any operand), the GQA sum over each group."""
    B, H, S, D = q.shape
    KV, Dv = k.shape[1], v.shape[-1]
    G = H // KV
    scale = float(np.float32(1.0 / np.sqrt(D)))
    kk, vv = (t.repeat_interleave(G, dim=1) for t in (k, v))
    pos = torch.arange(S)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window

    def capped(s):
        if not cap:
            return s, torch.ones_like(s)
        th = torch.tanh(s / cap)
        return cap * th, 1.0 - th * th

    lse = torch.logsumexp(torch.where(mask, capped((q @ kk.transpose(
        -1, -2)) * scale)[0], ref.NEG), dim=-1, keepdim=True)
    x, dcap = capped(mm(q, kk.transpose(-1, -2)) * scale)
    p = torch.where(mask, torch.exp(x - lse), 0.0)
    out = ref.attention_ref(q, k, v, window, cap)
    delta = (dout * out).sum(-1, keepdim=True)
    dv = mm(p.transpose(-1, -2), dout)
    ds = p * (mm(dout, vv.transpose(-1, -2)) - delta) * dcap
    dq = mm(ds, kk) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    return (dq, dk.reshape(B, KV, G, S, D).sum(2),
            dv.reshape(B, KV, G, S, Dv).sum(2))


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", SHAPES[:4] + [
    # the float32-only pairs (D as (Dk, Dv)): gemma2's window and cap under
    # MQA with a ragged length, and MLA's (192, 128)
    pytest.param(1, 4, 1, 80, (256, 256), 24, 50.0, id="256-256-mqa"),
    pytest.param(1, 4, 4, 72, (192, 128), 0, 0.0, id="192-128"),
])
def test_3xtf32_backward_plan_within_float32_tolerance(B, H, KV, S, D,
                                                       window, cap):
    """The backward kernel computes float32 products as 3xTF32 on the
    tensor cores.  Emulated here (cvt.rna.tf32 in PyTorch), its gradients
    stay within the float32 tolerance, 1e-5 · max |grad| over dq, dk and
    dv, of the plain version's autograd and of jax.grad of the model's
    chunked_attention; one TF32 product a step does worse (its error is
    printed for the record).  The same holds at the head-dim pairs the
    float32 backward alone takes, whose five products run at Dk (S, dQ, dK)
    and Dv (dP, dV)."""
    dk, dv = D if isinstance(D, tuple) else (D, D)
    arrays = _inputs(B, H, KV, S, dk, seed=8)
    if dv != dk:
        arrays[2] = np.random.default_rng(10).normal(
            size=(B, KV, S, dv)).astype(np.float32)
    g = np.random.default_rng(9).normal(size=(B, H, S, dv)).astype(
        np.float32)
    q, k, v = _port(arrays, torch.float32)
    dout = torch.as_tensor(g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = torch.autograd.grad(ref.attention_ref(*leaves, window, cap),
                                leaves, dout)
    want_jax = [np.swapaxes(np.asarray(w), 1, 2) for w in _jitted_grad(
        window, cap)(*(jnp.swapaxes(t, 1, 2) for t in _jax(arrays,
                                                           jnp.float32)),
                     jnp.swapaxes(jnp.asarray(g), 1, 2))]
    three = _backward_by_products(q, k, v, dout, window, cap, _mm_3xtf32)
    one = _backward_by_products(q, k, v, dout, window, cap, _mm_tf32)

    def worst(got, want):
        return max(float(np.abs(a.numpy() - np.asarray(b)).max())
                   for a, b in zip(got, want))

    scale = max(float(w.abs().max()) for w in plain)
    err3, err1 = worst(three, plain), worst(one, plain)
    err3_jax = worst(three, want_jax)
    print(f"3xTF32 backward at {(B, H, KV, S, D, window, cap)}: "
          f"{err3 / scale:.3e} of max |grad| against autograd, "
          f"{err3_jax / scale:.3e} against jax.grad; one TF32 product: "
          f"{err1 / scale:.3e}")
    assert err3 <= 1e-5 * scale
    assert err3_jax <= 1e-5 * scale
    assert err3 < err1


def _forward_by_tiles(q, k, v, window, cap, mm, bk=64):
    """The forward kernel's arithmetic in the kernel layout: for each KV
    tile of ``bk`` keys, S = mm(Q, K^T) scaled, capped and masked (NEG),
    the online softmax (running max m and sum l, corr = exp(m - m_new)),
    and O = O * corr + mm(P, V), each tile's P V summed apart and added in
    float32; O / l at the end (l == 0 -> 1).  Tiles the kernel skips (all
    masked for a q tile) change nothing here: their p is 0 after a real
    score, and corr = 0 wipes them before one."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    scale = float(np.float32(1.0 / np.sqrt(D)))
    kk, vv = (t.repeat_interleave(G, dim=1) for t in (k, v))
    pos = torch.arange(S)
    m = torch.full((B, H, S, 1), ref.NEG)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for lo in range(0, S, bk):
        hi = min(S, lo + bk)
        x = mm(q, kk[:, :, lo:hi].transpose(-1, -2)) * scale
        if cap:
            x = cap * torch.tanh(x / cap)
        keep = pos[:, None] >= pos[None, lo:hi]
        if window:
            keep &= (pos[:, None] - pos[None, lo:hi]) < window
        x = torch.where(keep, x, ref.NEG)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm(p, vv[:, :, lo:hi])
        m = m_new
    return acc / torch.where(l == 0, 1.0, l)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", SHAPES + [
    (1, 4, 2, 200, 64, 0, 0.0), (2, 4, 1, 200, 32, 70, 20.0)])
def test_3xtf32_forward_plan_within_float32_tolerance(B, H, KV, S, D, window,
                                                      cap):
    """The forward kernel computes float32 products as 3xTF32 on the
    tensor cores (S = Q K^T and each tile's P V).  Emulated here, its
    output stays within the float32 tolerance (rtol = atol = 2e-5) of the
    plain version and, where S % 128 == 0, of the Pallas kernel in
    interpret mode; one TF32 product each falls outside it (its error is
    printed for the record)."""
    arrays = _inputs(B, H, KV, S, D, seed=10)
    q, k, v = _port(arrays, torch.float32)
    want = ref.attention_ref(q, k, v, window, cap)
    three = _forward_by_tiles(q, k, v, window, cap, _mm_3xtf32)
    one = _forward_by_tiles(q, k, v, window, cap, _mm_tf32)
    err3 = float((three - want).abs().max())
    err1 = float((one - want).abs().max())
    print(f"3xTF32 forward at {(B, H, KV, S, D, window, cap)}: max |Δ| "
          f"{err3:.3e}; one TF32 product: {err1:.3e}")
    _close(three, want.numpy(), 2e-5)
    if S % 128 == 0:
        pallas = pallas_flash(*_jax(arrays, jnp.float32), window=window,
                              cap=cap, block_q=64, block_k=64,
                              interpret=True)
        _close(three, pallas, 2e-5)
    assert not torch.allclose(one, want, rtol=2e-5, atol=2e-5)


def test_backward_copies_rows_that_are_not_16_byte_aligned():
    """The backward stages q, k, v and dout with 16-byte copies: a view
    whose rows do not start on 16 bytes is copied, an aligned one (the
    model layout's transposed view too) is passed as it is."""
    odd = torch.zeros(2, 3, 5, 65)[..., :64]      # rows 260 bytes apart
    copy = ops._rows_aligned(odd)
    assert copy is not odd and copy.is_contiguous()
    assert torch.equal(copy, odd)
    for t in (torch.zeros(2, 3, 5, 64), torch.zeros(2, 5, 3, 32).transpose(
            1, 2), torch.zeros(1, 3, 1, 64, dtype=torch.bfloat16)):
        assert ops._rows_aligned(t) is t
