"""The compressor kernels on the card against their plain versions.

These tests need an NVIDIA card and nvcc; they skip without them (the
decision is taken in a fixture, never at import).  Run them on a machine
with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: none — the kernels evaluate the plain versions' expressions in
the same order without FMA contraction, so results are bit-identical.
This file imports no JAX (the card's machine has none).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.compressor import ops, ref

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
