"""The port's kernels on the card against their plain versions, and the
serving path on the card against the port on the CPU.

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
  the card and the CPU (float32 matmuls of cuBLAS against the CPU's).
This file imports no JAX (the card's machine has none).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.compressor import ops, ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve
from repro_torch.models.model import tree_map

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
    ops.dither_bits(8.0, 33, cuda)
    assert ops.launches == {"fused_dither": 1, "fused_topk": 1,
                            "dither_bits": 1, "topk_bits": 0}
    with pytest.raises(TypeError):
        ops.fused_topk(x.double(), 0.5)
    with pytest.raises(ValueError):
        ops.fused_topk(x.T, 0.5)
    with pytest.raises(ValueError):
        ops.fused_dither(x, torch.zeros_like(x).cpu(), 8.0)
    torch.cuda.synchronize()


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
    assert fa_ops.launches == {"flash_attention": 1}
    want = fa_ref.attention_ref(q, k, v, window, cap)
    assert got.dtype == dtype and got.shape == (B, H, S, D)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
