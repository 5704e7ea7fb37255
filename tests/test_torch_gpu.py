"""The port's kernels on the card against their plain versions, and the
serving and training paths on the card against the port on the CPU.

These tests need an NVIDIA card and nvcc; they skip without them (the
decision is taken in a fixture, never at import).  Run them on a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances:
* compressor kernels: none — they evaluate the plain versions' expressions
  in the same order without FMA contraction, so results are bit-identical;
* flash attention: rtol = atol = 2e-5 in float32 and 2e-2 in bfloat16, the
  reference's own kernel test's (sums in another order; one bf16 ulp);
* serving (smoke config): logits max |Δ| <= 1e-4 · max |logits| between
  the card and the CPU (float32 matmuls of cuBLAS against the CPU's);
* dither codec kernels: none — bit-identical to the plain versions, as the
  compressor kernels;
* flash-attention backward against the plain version under autograd on the
  same card: max |Δ| <= 1e-5 · max |grad| in float32 (the kernel's
  products are 3xTF32, about float32's accuracy, summed in another order;
  max over dq, dk and dv), 1e-2 · max |grad| in bfloat16 (gradients
  rounded to bf16 from float32 results that differ in the last bits: one
  bf16 ulp is 2^-8 of the value); two backward runs give the same bits;
* training (smoke config): gradients on the card within 1e-4 · max |g| of
  the CPU's per leaf, losses within 1e-5 relative, ``uplink_mbits`` equal.
This file imports no JAX (the card's machine has none).
"""
import numpy as np
import pytest
import torch

from repro_torch import random
from repro_torch.kernels.compressor import ops, ref
from repro_torch.kernels.dither import ops as d_ops
from repro_torch.kernels.dither import ref as d_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve
from repro_torch.launch import train as train_launch
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.train.step import value_and_grad

pytestmark = pytest.mark.gpu

SHAPES = [(20, 123), (20, 492), (3, 1), (3, 127), (3, 128), (3, 129),
          (2, 5000), (2, 20000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _same(a, b):
    """Bit-identical, NaN matching NaN (NaN payloads differ by device)."""
    a, b = a.cpu(), b.cpu()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    keep = ~torch.isnan(b)
    assert torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def _rows(shape, seed, kind="normal"):
    g = np.random.default_rng(seed)
    if kind == "ties":
        return torch.as_tensor(g.integers(-3, 4, size=shape).astype(
            np.float32))
    return torch.as_tensor((g.normal(size=shape) * 10).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s", [1.0, 64.0])
def test_fused_dither_bit_identical(cuda, shape, s):
    x = _rows(shape, 0)
    u = torch.as_tensor(np.random.default_rng(1).random(shape, np.float32))
    out, bits = ops.fused_dither(x.to(cuda), u.to(cuda), s)
    want, want_bits = ref.fused_dither_ref(x, u, s)
    _same(out, want)
    _same(bits, want_bits)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_fused_topk_bit_identical(cuda, shape, frac, kind):
    x = _rows(shape, 2, kind)
    out, bits = ops.fused_topk(x.to(cuda), frac)
    want, want_bits = ref.fused_topk_ref(x, frac)
    _same(out, want)
    _same(bits, want_bits)


def test_edge_rows(cuda):
    rows = torch.tensor([[0.0] * 6,
                         [1.0, float("inf"), 3.0, -2.0, 0.0, -float("inf")],
                         [1.0, float("nan"), 3.0, -2.0, -0.0, 0.5]])
    u = torch.full(rows.shape, 0.25)
    _same(ops.fused_dither(rows.to(cuda), u.to(cuda), 15.0)[0],
          ref.fused_dither_ref(rows, u, 15.0)[0])
    for frac in (1 / 6, 0.5, 1.0):
        _same(ops.fused_topk(rows.to(cuda), frac)[0],
              ref.fused_topk_ref(rows, frac)[0])


@pytest.mark.parametrize("n,C", [(1, 8), (20, 4), (40, 2), (200, 1)])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_fused_topk_cluster_sizes(cuda, n, C, kind):
    """Every cluster size: n rows of 20,000 take C CTAs a row on 132 SMs
    (20,037 makes the shares ragged)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132:
        assert ops.topk_cluster(n, 20000, sms) == C
    for L in (20000, 20037):
        x = _rows((n, L), n, kind)
        for frac in (0.001, 0.1, 0.5):
            out, bits = ops.fused_topk(x.to(cuda), frac)
            want, want_bits = ref.fused_topk_ref(x, frac)
            _same(out, want)
            _same(bits, want_bits)


def _split_rows():
    """Rows that cross the shares of a cluster: ties straddling the CTA
    boundaries of a 16,384-element row split 8 ways (shares of 2,048), an
    all-equal row, denormals, and a mix."""
    g = np.random.default_rng(9)
    L = 16384
    straddle = (g.normal(size=L) * 1e-3).astype(np.float32)
    for c in range(1, 8):                       # ties around each boundary
        straddle[c * 2048 - 40:c * 2048 + 40] = 5.0
    straddle[g.integers(0, L, 30)] = 9.0        # a few above the ties
    equal = np.full(L, -2.5, np.float32)
    denormal = (g.normal(size=L) * 1e-41).astype(np.float32)
    denormal[::7] = 0.0
    denormal[::11] = -0.0
    mixed = (g.integers(-3, 4, size=L) * np.float32(1e-40)).astype(np.float32)
    mixed[::13] = g.normal(size=mixed[::13].shape)
    return torch.as_tensor(np.stack([straddle, equal, denormal, mixed]))


@pytest.mark.parametrize("frac", [0.001, 0.01, 0.5, 1.0])
def test_fused_topk_rows_across_the_cluster(cuda, frac):
    rows = _split_rows()
    for r in range(rows.shape[0]):
        x = rows[r:r + 1]                       # one row: 8 CTAs
        out, bits = ops.fused_topk(x.to(cuda), frac)
        want, want_bits = ref.fused_topk_ref(x, frac)
        _same(out, want)
        _same(bits, want_bits)
    out, _ = ops.fused_topk(rows.to(cuda), frac)   # four rows: 8 CTAs each
    _same(out, ref.fused_topk_ref(rows, frac)[0])


@pytest.mark.parametrize("L", [300_000, 3_000_000])
def test_fused_topk_long_rows(cuda, L):
    """One row: 8 shares of 37,500 (held in shared memory) and of 375,000
    (streamed from device memory on every pass)."""
    g = np.random.default_rng(L)
    x = torch.as_tensor(g.normal(size=(1, L)).astype(np.float32))
    ties = torch.as_tensor(g.integers(-50, 51, size=(1, L)).astype(
        np.float32))
    for row in (x, ties):
        for frac in (1e-4, 0.1):
            out, bits = ops.fused_topk(row.to(cuda), frac)
            want, want_bits = ref.fused_topk_ref(row, frac)
            _same(out, want)
            _same(bits, want_bits)


@pytest.mark.parametrize("d", [1, 2, 123, 128, 129, 492, 4096, 5000, 20000])
def test_ledger_kernels_equal_formulas(cuda, d):
    for s in (1.0, 64.0, 1000.0):
        assert (ops.dither_bits(s, d, cuda).item()
                == ref.dither_bits_ref(s, d, "cpu").item())
    for frac in (0.01, 0.1, 0.37, 1.0):
        assert (ops.topk_bits(frac, d, cuda).item()
                == ref.topk_bits_ref(frac, d, "cpu").item())


def test_launches_counted_and_inputs_checked(cuda):
    ops.reset_launches()
    x = torch.ones((4, 33), device=cuda)
    ops.fused_topk(x, 0.5)
    ops.fused_dither(x, torch.zeros_like(x), 8.0)
    ops.fused_dither_keyed(x, random.key(0, cuda), 8.0)
    ops.dither_bits(8.0, 33, cuda)
    assert ops.launches == {"fused_dither": 1, "fused_dither_keyed": 1,
                            "fused_topk": 1, "dither_bits": 1,
                            "topk_bits": 0}
    with pytest.raises(TypeError):
        ops.fused_topk(x.double(), 0.5)
    with pytest.raises(ValueError):
        ops.fused_topk(x.T, 0.5)
    with pytest.raises(ValueError):
        ops.fused_dither(x, torch.zeros_like(x).cpu(), 8.0)
    with pytest.raises(ValueError, match="key"):
        ops.fused_dither_keyed(x, random.key(0, "cpu"), 8.0)
    torch.cuda.synchronize()


def _keyed_dither_against_plain(cuda, x, key, s):
    """fused_dither_keyed on the card against its plain version on the CPU
    and against the u-taking kernel fed the same uniforms drawn on the
    card, bit for bit; the keyed counter moves, the u-taking one does
    not."""
    ops.reset_launches()
    out, bits = ops.fused_dither_keyed(x.to(cuda), key.to(cuda), s)
    assert ops.launches["fused_dither_keyed"] == 1
    assert ops.launches["fused_dither"] == 0
    want, want_bits = ref.fused_dither_keyed_ref(x, key, s)
    _same(out, want)
    _same(bits, want_bits)
    u = random.uniform(random.split(key.to(cuda), x.shape[0]),
                       (x.shape[1],))
    _same(out, ops.fused_dither(x.to(cuda), u, s)[0])


@pytest.mark.parametrize("n,C", [(1, 8), (20, 4), (40, 2), (200, 1)])
@pytest.mark.parametrize("L", [1, 123, 492, 5000, 20000, 20001])
def test_fused_dither_keyed_bit_identical(cuda, n, C, L):
    """Every cluster size: n rows of 20,000 take C CTAs a row on 132 SMs
    (shorter rows fewer; 20,001 makes the shares ragged).  Row 0's first
    half is zero, so some shares' maxima are 0."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms == 132 and L >= 20000:
        assert ops.dither_cluster(n, L, sms) == C
    x = _rows((n, L), n + L)
    x[0, :L // 2] = 0.0
    _keyed_dither_against_plain(cuda, x, random.key(n * L, "cpu"), 64.0)


@pytest.mark.parametrize("s", [1.0, 15.0, 64.0])
def test_fused_dither_keyed_edge_rows(cuda, s):
    """Zero, -0, ±inf and NaN rows, one row of each through an 8-CTA
    cluster and all of them as 8 rows."""
    L = 20000
    g = np.random.default_rng(4)
    rows = torch.as_tensor(g.normal(size=(8, L)).astype(np.float32))
    rows[0] = 0.0
    rows[1] = -0.0
    rows[2, ::3] = -0.0
    rows[3, 12345] = float("inf")
    rows[4, 19999] = -float("inf")
    rows[5, 3] = float("nan")
    rows[6, ::2] = 0.0
    key = random.fold_in(random.key(8, "cpu"), int(s))
    for r in range(rows.shape[0]):
        _keyed_dither_against_plain(cuda, rows[r:r + 1], key, s)
    _keyed_dither_against_plain(cuda, rows, key, s)


def test_round_launches_the_keyed_dither(cuda):
    """Algorithm 1's round on the card compresses through the keyed kernel
    only (twice a round with dither on both messages), with the CPU's
    ledgers and objective (rtol 1e-4, as chip_smoke.py's quickstart)."""
    from repro_torch import quickstart
    from repro_torch.core.driver import run_experiment
    kw = dict(d=24, n_workers=4, r=24, m=2, seed=3)
    traces = {}
    for dev in (cuda, torch.device("cpu")):
        prob, step, state, key = quickstart.setup(device=dev, **kw)
        ops.reset_launches()
        state, traces[dev.type] = run_experiment(
            step, state, key, 3, record=lambda st: prob.metrics(st.w))
        if dev.type == "cuda":
            assert ops.launches["fused_dither_keyed"] == 6
            assert ops.launches["fused_dither"] == 0
    assert torch.equal(traces["cuda"]["bits_per_node"].cpu(),
                       traces["cpu"]["bits_per_node"])
    torch.testing.assert_close(traces["cuda"]["F"].cpu(), traces["cpu"]["F"],
                               rtol=1e-4, atol=0)


# the shapes of tests/test_kernels.py's flash-attention test, a ragged
# length, and D = 64 with a window that masks whole tiles
FLASH_SHAPES = [(1, 4, 2, 256, 64, 0, 0.0), (2, 4, 4, 128, 32, 0, 50.0),
                (1, 8, 2, 512, 64, 128, 0.0), (2, 2, 1, 256, 128, 64, 30.0),
                (1, 2, 2, 384, 64, 0, 0.0), (1, 4, 2, 200, 64, 0, 0.0),
                (2, 4, 1, 200, 32, 70, 20.0), (1, 2, 1, 1, 128, 0, 0.0),
                (1, 2, 2, 333, 64, 5, 0.0)]


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda, B, H, KV, S, D, window,
                                               cap, dtype):
    g = np.random.default_rng(S + D)
    q, k, v = (torch.as_tensor(g.normal(size=s).astype(np.float32)).to(
        cuda, dtype) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))
    fa_ops.reset_launches()
    got = fa_ops.flash_attention(q, k, v, window=window, cap=cap)
    assert fa_ops.launches == {"flash_attention": 1,
                               "flash_attention_backward": 0}
    want = fa_ref.attention_ref(q, k, v, window, cap)
    assert got.dtype == dtype and got.shape == (B, H, S, D)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_forward_is_deterministic_with_lse(
        cuda, B, H, KV, S, D, window, cap, dtype):
    """No float atomics: two forward runs give the same bits, the output
    and the log-sum-exp; the log-sum-exp equals the plain version's
    logsumexp of the scaled, capped, masked scores (float32 tolerance, the
    scores of bf16 inputs being exact products summed in float32)."""
    g = np.random.default_rng(S + D + 3)
    q, k, v = (torch.as_tensor(g.normal(size=s).astype(np.float32)).to(
        cuda, dtype) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))
    runs = []
    for _ in range(2):
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=cuda)
        fa_ops._launch(q, k, v, out, window, cap, lse)
        runs.append((out, lse))
    for a, b in zip(*runs):
        _same_exact(a, b)
    qf, kf = q.float(), k.float().repeat_interleave(H // KV, dim=1)
    s = qf @ kf.transpose(-1, -2) / float(np.sqrt(D))
    if cap:
        s = cap * torch.tanh(s / cap)
    pos = torch.arange(S, device=cuda)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    want = torch.logsumexp(torch.where(mask, s, fa_ref.NEG), dim=-1)
    torch.testing.assert_close(runs[0][1], want, rtol=2e-5, atol=2e-5)


def test_flash_attention_model_layout_strides(cuda):
    """ops.attention reads and writes [B, S, H, D] through strides."""
    g = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(g.normal(size=s).astype(np.float32)).to(cuda)
               for s in ((2, 300, 8, 64), (2, 300, 2, 64), (2, 300, 2, 64)))
    got = fa_ops.attention(q, k, v, window=100, cap=0.0)
    want = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), 100, 0.0).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    # [B, H, S, D] whose head dimension is strided
    q_strided = q.transpose(1, 2).transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="head dimension"):
        fa_ops.flash_attention(q_strided, k.transpose(1, 2),
                               v.transpose(1, 2))
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(*(t[..., :48].transpose(1, 2).contiguous()
                                 for t in (q, k, v)))
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-9b"])
def test_serve_on_the_card_matches_the_cpu(cuda, arch):
    cfg, params, tokens = serve.setup(arch, smoke=True, batch=2,
                                      prompt_len=40, device=cuda)
    out = serve.generate(cfg, params, tokens, gen=6)
    n_attn = sum(1 for m, _ in cfg.layer_plan)
    assert out["prefill_flash_launches"] == n_attn
    cpu = serve.generate(cfg, tree_map(lambda t: t.cpu(), params),
                         tokens.cpu(), gen=6, feed=out["generated"].cpu())
    got, want = out["logits"].cpu(), cpu["logits"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _same_exact(a, b):
    """Equal element for element, NaN matching NaN, any dtype."""
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        _same(a.float(), b.float())
    else:
        assert torch.equal(a, b)


# the shapes of tests/test_kernels.py's dither test, and a block larger
# than one CTA's chunk (the two-pass path)
DITHER_SHAPES = [(16, 128, 8, 127), (32, 256, 8, 63), (8, 512, 4, 15),
                 (64, 128, 16, 127), (300, 1000, 300, 127),
                 (24, 77, 3, 255)]


@pytest.mark.parametrize("R,C,br,s", DITHER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dither_codec_bit_identical(cuda, R, C, br, s, dtype):
    g = np.random.default_rng(R + C)
    x = torch.as_tensor((g.normal(size=(R, C)) * 10).astype(np.float32)).to(
        dtype)
    u = random.uniform(random.key(0, "cpu"), (R, C))
    d_ops.reset_launches()
    lv, sc = d_ops.dither_encode(x.to(cuda), u.to(cuda), s=s, block_rows=br)
    out = d_ops.dither_decode(lv, sc, block_rows=br)
    assert d_ops.launches == {"dither_encode": 1, "dither_encode_keyed": 0,
                              "dither_decode": 1}
    want_lv, want_sc = d_ref.dither_encode_ref(x, u, s, br)
    _same_exact(lv, want_lv)
    _same_exact(sc, want_sc)
    _same_exact(out, d_ref.dither_decode_ref(want_lv, want_sc, br))


def test_dither_codec_edge_rows(cuda):
    """Zero, ±inf and NaN blocks, and s = 255 (levels past 127 saturate)."""
    inf, nan = float("inf"), float("nan")
    x = torch.tensor([[0.0] * 4, [-0.0] * 4,
                      [1.0, inf, 3.0, -2.0], [0.5, -inf, 0.0, 7.0],
                      [1.0, nan, 3.0, -2.0], [-0.0, 0.5, 2.0, 1.0],
                      [4.0, -4.0, 3.9, -3.9], [1e-3, 2e-3, -4.0, 0.25]])
    u = torch.as_tensor(np.random.default_rng(3).random(x.shape, np.float32))
    for s in (15, 127, 255):
        lv, sc = d_ops.dither_encode(x.to(cuda), u.to(cuda), s=s,
                                     block_rows=2)
        want_lv, want_sc = d_ref.dither_encode_ref(x, u, s, 2)
        _same_exact(lv, want_lv)
        _same_exact(sc, want_sc)
        _same_exact(d_ops.dither_decode(lv, sc, block_rows=2),
                    d_ref.dither_decode_ref(want_lv, want_sc, 2))


@pytest.mark.parametrize("shape", [(1000,), (33, 77), (4, 5, 6), (128, 512)])
def test_quantize_bit_identical(cuda, shape):
    x = torch.as_tensor(np.random.default_rng(1).normal(size=shape).astype(
        np.float32))
    got = d_ops.quantize(random.key(1, cuda), x.to(cuda), s=63)
    want = d_ops.quantize(random.key(1, "cpu"), x, s=63)
    for a, b in zip(got[:2], want[:2]):
        _same_exact(a, b)
    assert got[2] == want[2]
    _same_exact(d_ops.dequantize(*got), d_ops.dequantize(*want))


def test_dither_inputs_checked(cuda):
    x = torch.ones((8, 16), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        d_ops.dither_encode(x, torch.zeros_like(x), block_rows=3)
    with pytest.raises(TypeError):
        d_ops.dither_encode(x.double(), torch.zeros_like(x), block_rows=8)
    with pytest.raises(ValueError):
        d_ops.dither_encode(x.T, torch.zeros_like(x.T), block_rows=1)
    with pytest.raises(ValueError, match="key"):
        d_ops.dither_encode_keyed(x, random.key(0, "cpu"), block_rows=8)
    lv, sc = d_ops.dither_encode(x, torch.zeros_like(x), block_rows=8)
    # levels at any address decode (the kernel's scalar path)
    odd = lv.reshape(-1)[1:17].reshape(1, 16)
    _same_exact(d_ops.dither_decode(odd, sc[:1], block_rows=1),
                d_ref.dither_decode_ref(odd.cpu(), sc[:1].cpu(), 1))
    torch.cuda.synchronize()


@pytest.mark.parametrize("R,C,br,offset", [
    (64, 128, 16, 0), (300, 1000, 300, 0), (45056 // 64, 5632, 704, 0),
    (24, 77, 3, 0), (7, 5, 7, 0), (64, 128, 16, 1), (64, 128, 16, 4),
    (64, 128, 16, 8), (33, 12, 11, 4), (5, 3, 5, 2)])
def test_dither_decode_layouts(cuda, R, C, br, offset):
    """The decode on multi-block levels, ragged blocks (length not a
    multiple of 4: the scalar kernel), and levels that start 1, 2, 4 or 8
    bytes past an aligned address (4-aligned but not 16-aligned takes the
    vector kernel), bit for bit against the plain version."""
    g = np.random.default_rng(R * C + offset)
    buf = torch.as_tensor(g.integers(-128, 128, size=R * C + offset,
                                     dtype=np.int8))
    lv = buf.to(cuda)[offset:].view(R, C)
    assert lv.data_ptr() % 16 == offset
    sc = torch.as_tensor(g.random(R // br, dtype=np.float32) + 0.5)
    d_ops.reset_launches()
    got = d_ops.dither_decode(lv, sc.to(cuda), block_rows=br)
    assert d_ops.launches["dither_decode"] == 1
    _same_exact(got, d_ref.dither_decode_ref(lv.cpu(), sc, br))


@pytest.mark.parametrize("R,C,br", [(40000, 54000, 5000),
                                    (40008, 53999, 5001)])
def test_dither_decode_beyond_2_31_levels(cuda, R, C, br):
    """The decode of more than 2^31 levels (2.2 GB of int8, 8.6 GB out):
    the vector kernel (blocks of a multiple of 4) and the scalar kernel
    (odd blocks) index past 32 bits, bit for bit against the plain version
    on the card."""
    assert R * C > 2 ** 31
    g = torch.Generator(device=cuda).manual_seed(R)
    lv = torch.randint(-128, 128, (R, C), generator=g, dtype=torch.int8,
                       device=cuda)
    sc = torch.rand(R // br, generator=g, device=cuda) + 0.5
    d_ops.reset_launches()
    got = d_ops.dither_decode(lv, sc, block_rows=br)
    assert d_ops.launches["dither_decode"] == 1
    want = d_ref.dither_decode_ref(lv, sc, br)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    del lv, got, want
    torch.cuda.empty_cache()


def _keyed_against_plain(cuda, x, s, br, seed):
    """The keyed encode on the card against its plain version on the CPU
    (uniform(key, x.shape), then the plain encode), and against the
    u-taking kernel fed the same uniforms drawn on the card: bit for bit."""
    key = random.fold_in(random.key(seed, "cpu"), 3)
    d_ops.reset_launches()
    lv, sc = d_ops.dither_encode_keyed(x.to(cuda), key.to(cuda), s=s,
                                       block_rows=br)
    assert d_ops.launches == {"dither_encode": 0, "dither_encode_keyed": 1,
                              "dither_decode": 0}
    want_lv, want_sc = d_ref.dither_encode_keyed_ref(x, key, s, br)
    _same_exact(lv, want_lv)
    _same_exact(sc, want_sc)
    u = random.uniform(key.to(cuda), tuple(x.shape))
    u_lv, u_sc = d_ops.dither_encode(x.to(cuda), u, s=s, block_rows=br)
    _same_exact(lv, u_lv)
    _same_exact(sc, u_sc)


@pytest.mark.parametrize("R,C,br,s", DITHER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dither_encode_keyed_bit_identical(cuda, R, C, br, s, dtype):
    g = np.random.default_rng(R * C)
    x = torch.as_tensor((g.normal(size=(R, C)) * 10).astype(np.float32)).to(
        dtype)
    _keyed_against_plain(cuda, x, s, br, R + C)


@pytest.mark.parametrize("R,C", [(64, 2048), (1, 4099), (513, 77),
                                 (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dither_encode_keyed_one_block_leaves(cuda, R, C, dtype):
    """A whole tensor as one block (the trainer's leaves), including
    lengths that are not a multiple of 4 (the scalar path)."""
    g = np.random.default_rng(R + 7 * C)
    x = torch.as_tensor((g.normal(size=(R, C)) * 1e-3).astype(
        np.float32)).to(dtype)
    _keyed_against_plain(cuda, x, 127, R, C)


@pytest.mark.parametrize("s", [15, 127, 255])
def test_dither_encode_keyed_edge_rows(cuda, s):
    """Zero, ±inf and NaN blocks, and s = 255, through the keyed entry."""
    inf, nan = float("inf"), float("nan")
    x = torch.tensor([[0.0] * 4, [-0.0] * 4,
                      [1.0, inf, 3.0, -2.0], [0.5, -inf, 0.0, 7.0],
                      [1.0, nan, 3.0, -2.0], [-0.0, 0.5, 2.0, 1.0],
                      [4.0, -4.0, 3.9, -3.9], [1e-3, 2e-3, -4.0, 0.25]])
    _keyed_against_plain(cuda, x, s, 2, s)


def test_dither_encode_keyed_unaligned_x(cuda):
    """x whose start is not 16-byte aligned takes the scalar path."""
    g = np.random.default_rng(12)
    buf = torch.as_tensor(g.normal(size=64 * 128 + 1).astype(np.float32))
    x = buf.to(cuda)[1:].view(64, 128)
    assert x.data_ptr() % 16
    key = random.key(9, "cpu")
    lv, sc = d_ops.dither_encode_keyed(x, key.to(cuda), s=127,
                                       block_rows=16)
    want_lv, want_sc = d_ref.dither_encode_keyed_ref(x.cpu(), key, 127, 16)
    _same_exact(lv, want_lv)
    _same_exact(sc, want_sc)


def _grads(fn, tensors):
    leaves = [t.detach().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    g_out = torch.as_tensor(np.random.default_rng(7).normal(
        size=tuple(out.shape)).astype(np.float32)).to(out.device, out.dtype)
    return out, torch.autograd.grad(out, leaves, g_out)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain_version(
        cuda, B, H, KV, S, D, window, cap, dtype):
    g = np.random.default_rng(S + D + 1)
    qkv = [torch.as_tensor(g.normal(size=s).astype(np.float32)).to(
        cuda, dtype) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]
    fa_ops.reset_launches()
    out, got = _grads(lambda q, k, v: fa_ops.flash_attention(
        q, k, v, window=window, cap=cap), qkv)
    assert fa_ops.launches == {"flash_attention": 1,
                               "flash_attention_backward": 1}
    # the forward is the same with and without the log-sum-exp output
    with torch.no_grad():
        _same(out.float(), fa_ops.flash_attention(*qkv, window=window,
                                                  cap=cap).float())
    _, want = _grads(lambda q, k, v: fa_ref.attention_ref(q, k, v, window,
                                                          cap), qkv)
    # max |grad| over dq, dk and dv: at S = 1 dq is 0 in exact arithmetic
    # (dS = P (dP - Delta) with P = 1 and dP = Delta) and rounding residue
    # on either side is measured against the gradients' scale
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    bound = rel * max(float(b.float().abs().max()) for b in want)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", [
    (1, 4, 2, 200, 64, 0, 0.0), (2, 4, 1, 200, 32, 70, 20.0),
    (2, 2, 1, 256, 128, 64, 30.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(cuda, B, H, KV, S, D,
                                                   window, cap, dtype):
    """No float atomics: two backward runs give the same bits."""
    g = np.random.default_rng(S + D + 2)
    qkv = [torch.as_tensor(g.normal(size=s).astype(np.float32)).to(
        cuda, dtype) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]
    fn = lambda q, k, v: fa_ops.flash_attention(      # noqa: E731
        q, k, v, window=window, cap=cap)
    _, first = _grads(fn, qkv)
    _, second = _grads(fn, qkv)
    for a, b in zip(first, second):
        _same_exact(a, b)


def test_flash_attention_backward_unaligned_rows(cuda):
    """Operands whose rows do not start on 16 bytes (a view of every 65th
    float) are copied before the backward stages them."""
    g = np.random.default_rng(11)
    qkv = [torch.as_tensor(g.normal(size=s).astype(np.float32)).to(cuda)[
        ..., :64] for s in ((1, 4, 100, 65), (1, 2, 100, 65), (1, 2, 100, 65))]
    _, got = _grads(lambda q, k, v: fa_ops.flash_attention(q, k, v), qkv)
    _, want = _grads(lambda q, k, v: fa_ref.attention_ref(q, k, v), qkv)
    bound = 1e-5 * max(float(b.abs().max()) for b in want)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= bound


def test_attention_weights_get_gradients_on_the_card(cuda):
    """The attention projections' gradients exist on the card and equal the
    port's on the CPU (a forward kernel alone would leave wq, wk and wv
    without gradients)."""
    cfg, params = train_launch.setup("tinyllama-1.1b", smoke=True,
                                     device=cuda)
    batch = next(train_launch.token_batches(cfg, 2, 48, cuda))
    fa_ops.reset_launches()
    loss, grads = value_and_grad(params, batch, cfg, remat=True)
    n_attn = cfg.n_layers
    assert fa_ops.launches == {"flash_attention": 2 * n_attn,
                               "flash_attention_backward": n_attn}
    cpu_loss, cpu_grads = value_and_grad(
        tree_map(lambda t: t.cpu(), params),
        tree_map(lambda t: t.cpu(), batch), cfg, remat=True)
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    mixer = grads["blocks"][0][0]["mixer"]
    for name in ("wq", "wk", "wv"):
        assert float(mixer[name].abs().max()) > 0, name
    for a, b in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())


@pytest.mark.parametrize("flecs", [False, True])
def test_train_on_the_card_matches_the_cpu(cuda, flecs):
    cfg, params = train_launch.setup("tinyllama-1.1b", smoke=True,
                                     device=cuda)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        batches = train_launch.token_batches(cfg, 4, 32, dev)
        d_ops.reset_launches()
        runs[dev.type] = train_launch.train(cfg, p, batches, 3, flecs=flecs)
        if flecs:
            n = len(tree_leaves(params)) * 3 if dev.type == "cuda" else 0
            assert d_ops.launches == {"dither_encode": 0,
                                      "dither_encode_keyed": n,
                                      "dither_decode": n}
    for a, b in zip(runs["cuda"]["metrics"], runs["cpu"]["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        if flecs:
            assert a["uplink_mbits"] == b["uplink_mbits"]
