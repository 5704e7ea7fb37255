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
  the CPU's per leaf, losses within 1e-5 relative, ``uplink_mbits`` equal;
* grouped compressor entries: none — bit-identical to their plain versions
  and to G launches of the scalar entries;
* plans (budget-fair, small): ledgers, counts and budget rounds equal to
  the CPU's, final objectives within rtol 1e-4;
* the stochastic setting: key streams, exact-k masks and natural
  bit-identical to the CPU's; the count sketch's table and min-max's ℓ1
  norm (float64 sums rounded once) bit-identical or, where the float64 sum
  lands next to a float32 midpoint, one ulp apart (a double rounding,
  warned about), min-max's messages bit-identical where the norms agree;
  a stochastic run's every card message the plain compressor's on its
  recorded input, and F within rtol 1e-4 of the CPU's at every round or
  within 3x the CPU's own ulp envelope (``plan_drift.verdict``);
* the async engine: tau = 0 async steps equal the sync steps on the card
  bit for bit; delays, sends, arrivals, the availability chain and the
  ledgers bit for bit the CPU's, except a geometric delay whose
  log(u) / log(q) lies within 4 ulps of an integer (each such one warned
  about); the async grid held by ``plan_drift.verdict``.
* attention's tangent kernels (forward and backward) against their plain
  versions on the same card and inputs: max |Δ| <= 1e-5 · max |t| (the
  float32 backward's tolerance; CUDA-core float32 sums in another order),
  the same bits over two runs; a Hessian-vector product through
  ``ops.attention`` within 1e-5 · max |Hv| of the plain path's on the card,
  also for a loss linear in attention's output (its backward's grad_out
  carries no tangent);
* the sketched-Hessian FLECS-CGD step (m = 2, smoke config) on the card
  against the CPU: ``uplink_mbits`` equal, losses within 1e-5 relative
  (before and after the step).
* ``models/model._dual_remat`` against ``torch.utils.checkpoint`` on the
  card, inputs without tangents: loss and gradients bit for bit (the same
  operations).
This file imports no JAX (the card's machine has none).
"""
import warnings

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


def _same_sum(a, b):
    """Bit-identical, or else every differing element one ulp apart: a
    float64 sum of float32 terms is not always exact, so two orders of it
    can round to neighbouring float32 values next to a midpoint (a double
    rounding, reported as a warning, not a port fault)."""
    a, b = a.cpu(), b.cpu()
    ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1, f"{int(ulps.max())} ulps apart"
    if int(ulps.sum()):
        warnings.warn(f"{int(ulps.sum())} element(s) one ulp apart: a double "
                      "rounding of a float64 sum")


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
    """One row of 300,000 and of 3,000,000: the grid-wide instance (chunks
    of ``ops.topk_chunk`` over the whole card), normal values and integer ties,
    through both entries, the same bits over two runs."""
    g = np.random.default_rng(L)
    x = torch.as_tensor(g.normal(size=(1, L)).astype(np.float32))
    ties = torch.as_tensor(g.integers(-50, 51, size=(1, L)).astype(
        np.float32))
    for row in (x, ties):
        for frac in (1e-4, 0.1):
            ops.reset_launches()
            out, bits = ops.fused_topk(row.to(cuda), frac)
            assert ops.topk_instances["fused_topk"]["grid"] == 1
            want, want_bits = ref.fused_topk_ref(row, frac)
            _same(out, want)
            _same(bits, want_bits)
            _same_exact(out, ops.fused_topk(row.to(cuda), frac)[0])
            grouped, _ = ops.fused_topk_grouped(
                row.to(cuda), torch.tensor([frac], device=cuda))
            _same(grouped, want)


def _grid_rows():
    """Rows for the grid-wide instance: (what, rows)."""
    g = np.random.default_rng(23)
    L = 200_003                      # odd: rows after the first unaligned
    edges = g.normal(size=(3, L)) * 1e-3
    chunk = ops.topk_chunk(3, L, 132)
    for c in range(1, L // chunk + 1):
        edges[:, c * chunk - 50:c * chunk + 50] = 5.0
    edges[:, g.integers(0, L, 40)] = 9.0
    special = g.normal(size=(2, 150_001))
    special[:, ::97] = np.nan
    special[:, 5::89] = np.inf
    special[:, 7::83] = -np.inf
    special[:, ::13] = -0.0
    subnormal = g.normal(size=(1, 140_000)) * 1e-41
    subnormal[:, ::7] = 0.0
    rows = [("chunk-edge ties", edges),
            ("all-equal (candidates overflow)", np.full((1, 300_001), -2.5)),
            ("more ties than the budget", g.integers(-3, 4, (2, 150_001))),
            ("nan inf -0", special), ("subnormals", subnormal)]
    return [(what, torch.as_tensor(np.asarray(x, np.float32)))
            for what, x in rows]


@pytest.mark.parametrize("index", range(5))
@pytest.mark.parametrize("frac", [1e-4, 0.01, 0.3, 1.0])
def test_fused_topk_grid_rows_bit_identical(cuda, index, frac):
    """The grid-wide instance on the rows that test its routes: ties across
    chunk edges in rows of odd length, the candidate buffer's overflow,
    ranked ties, NaN/inf/-0 and subnormals; both entries, two runs."""
    what, x = _grid_rows()[index]
    xd = x.to(cuda)
    ops.reset_launches()
    out, bits = ops.fused_topk(xd, frac)
    assert ops.topk_instances["fused_topk"] == {"cluster": 0, "grid": 1}
    want, want_bits = ref.fused_topk_ref(x, frac)
    _same(out, want)
    _same(bits, want_bits)
    _same_exact(out, ops.fused_topk(xd, frac)[0])
    grouped, gbits = ops.fused_topk_grouped(
        xd, torch.full((x.shape[0],), frac, device=cuda))
    _same(grouped, want)
    _same(gbits, want_bits)


def test_fused_topk_grid_grouped_mixed_frac(cuda):
    """A grouped call on long rows with a different frac a point, read on
    the device, against the plain version."""
    x = _rows((6, 200_003), 5)
    frac = torch.tensor([0.01, 0.25, 1e-4])
    ops.reset_launches()
    out, bits = ops.fused_topk_grouped(x.to(cuda), frac.to(cuda))
    assert ops.topk_instances["fused_topk_grouped"]["grid"] == 1
    want, want_bits = ref.fused_topk_grouped_ref(x, frac)
    _same(out, want)
    _same(bits, want_bits)


@pytest.mark.parametrize("rows,L", [(20, 20000), (1, 131_071), (1, 131_072),
                                    (60, 15129), (2, 300_000)])
def test_topk_takes_the_planned_instance(cuda, rows, L):
    """Each side of the crossover takes the instance topk_plan names, by the
    per-instance launch counts, and both agree with the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    kind, _ = ops.topk_plan(rows, L, sms)
    x = _rows((rows, L), L)
    ops.reset_launches()
    out, _ = ops.fused_topk(x.to(cuda), 0.1)
    assert ops.topk_instances["fused_topk"] == {
        "cluster": int(kind == "cluster"), "grid": int(kind == "grid")}
    _same(out, ref.fused_topk_ref(x, 0.1)[0])


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
                            "topk_bits": 0, "fused_dither_keyed_grouped": 0,
                            "fused_topk_grouped": 0,
                            "dither_bits_grouped": 0,
                            "topk_bits_grouped": 0}
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
    only, as the grouped entry of the sweep step's [1] grid (twice a round
    with dither on both messages; the scalar and u-taking entries never),
    with the CPU's ledgers and objective (rtol 1e-4, as chip_smoke.py's
    quickstart)."""
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
            assert ops.launches["fused_dither_keyed_grouped"] == 6
            assert ops.launches["fused_dither_keyed"] == 0
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
                               "flash_attention_backward": 0,
                               "flash_attention_jvp": 0,
                               "flash_attention_backward_jvp": 0}
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
                              "dither_absmax": 0, "dither_levels_keyed": 0,
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
                              "dither_absmax": 0, "dither_levels_keyed": 0,
                              "dither_decode": 0}
    want_lv, want_sc = d_ref.dither_encode_keyed_ref(x, key, s, br)
    _same_exact(lv, want_lv)
    _same_exact(sc, want_sc)
    u = random.uniform(key.to(cuda), tuple(x.shape))
    u_lv, u_sc = d_ops.dither_encode(x.to(cuda), u, s=s, block_rows=br)
    _same_exact(lv, u_lv)
    _same_exact(sc, u_sc)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("R,C,br,s", DITHER_SHAPES + [(24, 77, 3, 255),
                                                     (1, 4099, 1, 127)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dither_split_entries_bit_identical(cuda, R, C, br, s, dtype,
                                            workers):
    """The keyed encode's split entries on the card: the norm pass over
    each worker's x into zeroed norms, then each worker's levels, against
    their plain versions on the CPU, and at one worker against the fused
    keyed encode, bit for bit; one launch of each a worker."""
    g = np.random.default_rng(R * C + workers)
    xs = [torch.as_tensor((g.normal(size=(R, C)) * (10 + j)).astype(
        np.float32)).to(dtype) for j in range(workers)]
    key = random.fold_in(random.key(R + C, "cpu"), 5)
    nb = R // br
    bits = torch.zeros(nb, dtype=torch.int32, device=cuda)
    want_bits = torch.zeros(nb, dtype=torch.int32)
    d_ops.reset_launches()
    for x in xs:
        d_ops.dither_absmax_into(x.to(cuda), bits, block_rows=br)
        d_ref.dither_absmax_into_ref(x, want_bits, br)
    _same_exact(bits, want_bits)
    for x in xs:
        lv, sc = d_ops.dither_levels_keyed(x.to(cuda), key.to(cuda), bits,
                                           s=s, block_rows=br)
        want_lv, want_sc = d_ref.dither_levels_keyed_ref(x, key, want_bits,
                                                         s, br)
        _same_exact(lv, want_lv)
        _same_exact(sc, want_sc)
    assert d_ops.launches["dither_absmax"] == workers
    assert d_ops.launches["dither_levels_keyed"] == workers
    if workers == 1:
        f_lv, f_sc = d_ops.dither_encode_keyed(xs[0].to(cuda), key.to(cuda),
                                               s=s, block_rows=br)
        _same_exact(lv, f_lv.cpu())
        _same_exact(sc, f_sc.cpu())


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


#: The backward's shapes: the forward's, a window of 7, a cap of 50 at
#: S = 200, and the training shape (tinyllama-1.1b, batch 8 x 1024).
BWD_SHAPES = FLASH_SHAPES + [(1, 4, 2, 200, 64, 7, 0.0),
                             (2, 4, 1, 200, 32, 0, 50.0),
                             (8, 32, 4, 1024, 64, 0, 0.0)]


@pytest.mark.parametrize("B,H,KV,S,D,window,cap", BWD_SHAPES)
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
                               "flash_attention_backward": 1,
                               "flash_attention_jvp": 0,
                               "flash_attention_backward_jvp": 0}
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


def test_flash_attention_backward_bf16_runs_on_wgmma(cuda):
    """The bf16 backward's kernels (dK/dV and dQ at D = 32, 64, 128) hold
    HGMMA in the SASS of the library built (cuobjdump), so a fall back to
    mma.sync cannot pass unseen."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    counts = chip_smoke.bwd_wgmma_sass(fa_ops)
    assert len(counts) == 6 and all(counts.values()), counts


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
                               "flash_attention_backward": n_attn,
                               "flash_attention_jvp": 0,
                               "flash_attention_backward_jvp": 0}
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
                                      "dither_absmax": 0,
                                      "dither_levels_keyed": 0,
                                      "dither_decode": n}
    for a, b in zip(runs["cuda"]["metrics"], runs["cpu"]["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        if flecs:
            assert a["uplink_mbits"] == b["uplink_mbits"]


# ---------------------------------------------------------------------------
# Grouped entries: a grid of G points in one launch
# ---------------------------------------------------------------------------

GROUPED_CASES = [(1, 20, 123), (3, 20, 123), (8, 20, 492), (3, 4, 5000),
                 (1, 1, 20000), (3, 2, 20001), (8, 1, 300)]


def _grid(G, n, L, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((rng.normal(size=(G * n, L)) * 10).astype(
        np.float32))
    x[0, :L // 2] = 0.0
    s = torch.as_tensor(rng.choice([1.0, 15.0, 64.0, 127.0], G).astype(
        np.float32))
    frac = torch.as_tensor(rng.choice([1e-4, 0.01, 0.25, 1.0], G).astype(
        np.float32))
    return x, random.split(random.key(seed, "cpu"), G), s, frac


@pytest.mark.parametrize("G,n,L", GROUPED_CASES)
def test_grouped_dither_keyed_bit_identical(cuda, G, n, L):
    """One launch for the grid, bit for bit its plain version on the CPU
    and G launches of the scalar entry (G = 1: today's call)."""
    x, keys, s, _ = _grid(G, n, L, G * L)
    ops.reset_launches()
    out, bits = ops.fused_dither_keyed_grouped(x.to(cuda), keys.to(cuda),
                                               s.to(cuda))
    assert ops.launches["fused_dither_keyed_grouped"] == 1
    want, want_bits = ref.fused_dither_keyed_grouped_ref(x, keys, s)
    _same(out, want)
    _same(bits, want_bits)
    for g in range(G):
        rows = slice(g * n, (g + 1) * n)
        o, b = ops.fused_dither_keyed(x[rows].to(cuda), keys[g].to(cuda),
                                      float(s[g]))
        _same(out[rows], o)
        _same(bits[rows], b)


@pytest.mark.parametrize("G,n,L", GROUPED_CASES)
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_grouped_topk_bit_identical(cuda, G, n, L, kind):
    x, _, _, frac = _grid(G, n, L, 7 * G + L)
    if kind == "ties":
        x = torch.round(x / 5)
    ops.reset_launches()
    out, bits = ops.fused_topk_grouped(x.to(cuda), frac.to(cuda))
    assert ops.launches["fused_topk_grouped"] == 1
    want, want_bits = ref.fused_topk_grouped_ref(x, frac)
    _same(out, want)
    _same(bits, want_bits)
    for g in range(G):
        rows = slice(g * n, (g + 1) * n)
        o, b = ops.fused_topk(x[rows].to(cuda), float(frac[g]))
        _same(out[rows], o)
        _same(bits[rows], b)


@pytest.mark.parametrize("G", [1, 3, 8, 300])
@pytest.mark.parametrize("d", [1, 123, 5000, 25_000_000])
def test_grouped_ledgers_bit_identical(cuda, G, d):
    _, _, s, frac = _grid(G, 1, 1, G)
    for grouped, plain, scalar, p in (
            (ops.dither_bits_grouped, ref.dither_bits_grouped_ref,
             ops.dither_bits, s),
            (ops.topk_bits_grouped, ref.topk_bits_grouped_ref,
             ops.topk_bits, frac)):
        got = grouped(p.to(cuda), d)
        _same(got, plain(p, d))
        _same(got, torch.stack([scalar(float(v), d, cuda) for v in p]))


def test_grouped_topk_at_60_by_25e6_rows(cuda):
    """FedNL's d² rows at gisette width, three points of 20 rows: 1.5 G
    elements, 6 GB — row offsets past 2^32 bytes.  Each point's rows
    against the scalar entry and the plain version, on the card."""
    L = 25_000_000
    x = torch.randn((60, L), generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    frac = (0.25, 0.1, 0.25)
    out, bits = ops.fused_topk_grouped(
        x, torch.tensor(frac, dtype=torch.float32, device=cuda))
    for g, f in enumerate(frac):
        rows = slice(20 * g, 20 * (g + 1))
        _same(out[rows], ops.fused_topk(x[rows], f)[0])
        want, want_bits = ref.fused_topk_ref(x[rows], f)
        _same(out[rows], want)
        _same(bits[rows], want_bits)
        del want
    del x, out
    torch.cuda.empty_cache()


#: The budget-fair plan's sizes on the card: the small size of the CPU
#: tests and the quickstart's.
PLAN_SIZES = [dict(d=24, n_workers=4, r=24), dict(d=123, n_workers=20, r=64)]


@pytest.mark.parametrize("size", PLAN_SIZES,
                         ids=lambda kw: f"d{kw['d']}")
def test_budget_fair_plan_on_the_card_matches_the_cpu(cuda, size):
    """The budget-fair plan (five methods × 3 budgets, grouped entries on
    every [3] grid): ledgers, counts, scan lengths and budget rounds equal
    to the CPU's, final F within rtol 1e-4 (as chip_smoke.py's plans);
    every grouped entry launched."""
    from repro_torch import experiments
    from repro_torch.core import api
    from repro_torch.data.logreg import make_problem
    kw = dict(**size, mu=1e-3, seed=0)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        prob = make_problem(**kw, device=dev)
        ops.reset_launches()
        res[dev.type] = api.run_plan(experiments.budget_fair_plan(prob))
        if dev.type == "cuda":
            for name in ("fused_dither_keyed_grouped", "fused_topk_grouped",
                         "dither_bits_grouped", "topk_bits_grouped"):
                assert ops.launches[name] > 0, name
    got, want = res["cuda"], res["cpu"]
    for lab in want.labels:
        for key in ("bits_per_node", "n_active"):
            assert torch.equal(got.traces[lab][key].cpu(),
                               want.traces[lab][key])
        torch.testing.assert_close(got.traces[lab]["F"][:, -1].cpu(),
                                   want.traces[lab]["F"][:, -1],
                                   rtol=1e-4, atol=0)
    budgets = experiments.budget_fair_budgets(prob)
    assert (experiments.budget_fair_rows(got, budgets)[0]["rounds"]
            == experiments.budget_fair_rows(want, budgets)[0]["rounds"])


def test_budget_fair_card_drift_is_a_level_flip(cuda):
    """At d = 24 the card and the CPU part in the budget-fair plan: every
    point whose final F differs by more than 1e-6 has a first differing
    message, and a rounding decision explains it (a dither level whose
    uniform u lies between the two sides' fractional parts p, or a top-k
    selection within the row's input gap of its threshold); F agreed
    within 1e-6 up to that round (``plan_drift``)."""
    from repro_torch import plan_drift
    from repro_torch.data.logreg import make_problem
    sides = [make_problem(d=24, n_workers=4, r=24, mu=1e-3, seed=0,
                          device=dev) for dev in (cuda, "cpu")]
    out = plan_drift.compare(*(plan_drift.PLANS["budget_fair"](p)
                               for p in sides))
    for lab, reports in out.items():
        for r in reports:
            if r["final_rel_gap"] <= 1e-6:
                continue
            diff = r.get("first_difference")
            assert diff is not None, (lab, r)
            assert diff["rel_gap_before"] <= 1e-6, (lab, r)
            assert diff["explained"], (lab, r)


# ---------------------------------------------------------------------------
# The stochastic setting: key streams, sampling, the three families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 12345])
def test_key_streams_on_the_card_equal_the_cpu(cuda, seed):
    """randint (maxval 300 and 2**31 - 1), permutation (one and two sort
    rounds), choice and the exact-k masks: bit for bit the CPU's."""
    from repro_torch.core import driver
    cases = (
        lambda k: random.randint(driver.worker_keys(k.unsqueeze(0), 20),
                                 (32,), 0, 300),
        lambda k: random.randint(k, (7, 5000), 0, 2**31 - 1),
        lambda k: random.permutation(k, 20),
        lambda k: random.permutation(k, 1626),
        lambda k: random.permutation(k, 5000),
        lambda k: random.choice(k, 5000, (4,), replace=False),
        lambda k: driver.participation_mask(random.split(k, 50), 20, 0.5,
                                            "choice"))
    for fn in cases:
        assert torch.equal(fn(random.key(seed, cuda)).cpu(),
                           fn(random.key(seed, "cpu")))


def _family_rows(seed=0, n=20, L=5000):
    x = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(n, L)).astype(np.float32))
    return x, random.split(random.key(seed + 5, "cpu"), n)


def test_natural_on_the_card_equals_the_cpu(cuda):
    """natural: sign, abs, log2, floor, a power of two and a compare; on
    normal rows the card's ``log2`` floors as the CPU's does."""
    from repro_torch.core import compressors as tc
    x, keys = _family_rows()
    spec = tc.make_spec("natural")
    _same(tc.compress(spec, keys.to(cuda), x.to(cuda)),
          tc.compress(spec, keys, x))


def test_count_sketch_on_the_card_within_its_contract(cuda):
    """The table's scatter-add runs on float64 atomics and is rounded once:
    the CPU's table and the same over two runs, bit for bit or a double
    rounding apart (``_same_sum``); decoding one table (gather, sort,
    median, the heavy hitters through fused_topk_grouped) is
    bit-identical."""
    from repro_torch.core import compressors as tc
    x, keys = _family_rows(1)
    width = torch.full((20,), 64.0)
    tabs = [tc.count_sketch_encode(keys.to(cuda), x.to(cuda),
                                   width.to(cuda)) for _ in range(2)]
    want = tc.count_sketch_encode(keys, x, width)
    _same_sum(tabs[0], want)
    _same_sum(tabs[1], tabs[0])
    depth = torch.full((20,), 3.0)
    for hh in (1.0, 0.25):
        frac = torch.full((1,), hh)
        ops.reset_launches()
        got = tc.count_sketch_decode(keys.to(cuda), want.to(cuda),
                                     width.to(cuda), depth.to(cuda),
                                     frac.to(cuda))
        assert ops.launches["fused_topk_grouped"] == 1
        _same(got, tc.count_sketch_decode(keys, want, width, depth, frac))


def test_minmax_on_the_card_equals_the_cpu(cuda):
    """min-max: the ℓ1 norm is summed in float64 and rounded once, the
    CPU's bit for bit or a double rounding apart (``_same_sum``); in every
    row whose norm agrees, the card's p, decisions and x/p are the CPU's
    bit for bit."""
    from repro_torch.core import compressors as tc
    x, keys = _family_rows(2)
    l1 = tc._l1(x.to(cuda).abs()).cpu()
    want_l1 = tc._l1(x.abs())
    _same_sum(l1, want_l1)
    agree = (l1 == want_l1)[:, 0]
    spec = tc.make_spec("minmax0.5")
    _same(tc.compress(spec, keys.to(cuda), x.to(cuda)).cpu()[agree],
          tc.compress(spec, keys, x)[agree])


def test_mixed_family_grid_one_grouped_launch_per_family(cuda):
    """compress_split over a grid of all six families: one
    fused_dither_keyed_grouped (dither), one fused_topk_grouped each for
    top-k and the count sketch's heavy hitters, no scalar entry; the
    whole grid bit-identical to the CPU."""
    from repro_torch.core import compressors as tc
    names = ("dither64", "topk0.25", "count_sketch64", "minmax0.5",
             "natural", "identity")
    spec = tc.stack_specs(*names)
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(6, 20, 492)).astype(np.float32))
    keys = random.split(random.key(4, "cpu"), 6)
    ops.reset_launches()
    got = tc.compress_split(tc.spec_to(spec, cuda), keys.to(cuda),
                            x.to(cuda)).cpu()
    bits = tc.spec_bits_many(tc.spec_to(spec, cuda), 492).cpu()
    assert {k: v for k, v in ops.launches.items() if v} == {
        "fused_dither_keyed_grouped": 1, "fused_topk_grouped": 2,
        "dither_bits_grouped": 1, "topk_bits_grouped": 2}
    _same(got, tc.compress_split(spec, keys, x))
    _same(bits, tc.spec_bits_many(spec, 492))


def test_stochastic_round_launches_the_full_batch_kernels(cuda):
    """A stochastic FLECS-CGD round (minibatch oracles, exact-k sampling)
    launches the compressor kernels of the full-batch round: the keyed
    dither and its ledger twice, nothing else."""
    from repro_torch import quickstart
    from repro_torch.core.driver import run_experiment
    launched = []
    for kw in ({}, dict(batch=32, participation=0.5, sampling="choice")):
        _, step, state, key = quickstart.setup(device=cuda, **kw)
        ops.reset_launches()
        run_experiment(step, state, key, 3)
        torch.cuda.synchronize()
        launched.append(dict(ops.launches))
    assert launched[0] == launched[1]
    assert launched[0]["fused_dither_keyed_grouped"] == 6
    assert launched[0]["dither_bits_grouped"] == 6


def test_stochastic_card_drift_is_a_level_flip(cuda):
    """Stochastic FLECS-CGD at quickstart size (batch 32, exact-k p = 0.5,
    alpha 0.2, 50 rounds) on the card against the CPU, every compressor
    call recorded (``plan_drift``): every card message is the plain
    compressor's on its recorded input and key; the first differing
    message is a dither level whose uniform lies between the two sides'
    fractional parts, after rounds that agreed within 1e-6; and F stays
    within rtol 1e-4 of the CPU's at every round or within 3x the largest
    gap one ulp of noise in A opens between two CPU runs (five seeds;
    ``plan_drift.verdict``)."""
    from repro_torch import plan_drift
    cpu = plan_drift.record_run(plan_drift.stochastic_run("cpu"))
    rep = plan_drift.compare_recorded_runs(
        plan_drift.record_run(plan_drift.stochastic_run("cuda")), cpu)
    (env,), _ = plan_drift.envelope("stochastic", 50,
                                    runs={(0, None): cpu[1]["F"]})
    assert not plan_drift.verdict(rep, env), rep
    if "first_difference" in rep:
        assert rep["first_difference"]["family"] == 1, rep


# ---------------------------------------------------------------------------
# The async engine and its traffic model on the card
# ---------------------------------------------------------------------------

ASYNC_SMALL = dict(d=24, n_workers=8, r=24)


@pytest.mark.parametrize("method", ["FLECS-CGD", "DIANA", "FedNL", "GD"])
def test_async_tau0_is_the_sync_step_on_the_card(cuda, method):
    """tau = 0 with buffer_k the cohort: the async step is the sync step on
    the card bit for bit (state, ledgers, every shared aux entry); the
    steps are ``experiments.legacy_steps``' (exact-k p = 0.5)."""
    from repro_torch import experiments
    from repro_torch.core.driver import run_experiment
    from repro_torch.data.logreg import make_problem
    prob = make_problem(**ASYNC_SMALL, mu=1e-3, seed=0, device=cuda)
    (astep, a0), (sstep, s0) = experiments.legacy_steps(
        method, prob, "fixed", 0, 4)
    rec = lambda st: prob.metrics(st.w)                    # noqa: E731
    sa, ta = run_experiment(astep, a0, random.key(1, cuda), 30, record=rec)
    ss, ts = run_experiment(sstep, s0, random.key(1, cuda), 30, record=rec)
    for field in type(ss)._fields:
        if isinstance(getattr(ss, field), torch.Tensor):
            assert torch.equal(getattr(ss, field), getattr(sa, field)), field
    for key, v in ts.items():
        assert torch.equal(v, ta[key]), key


def test_async_grid_on_the_card_under_the_verdict(cuda):
    """``experiments.async_grid`` at d = 24 (G = 9, 60 rounds), card against
    CPU, every compressor call and routing recorded: ledgers, sends and
    arrivals equal, every point held by ``plan_drift.verdict`` (the CPU's
    ulp envelope taken where F parts past rtol 1e-4)."""
    from repro_torch import plan_drift
    cpu = plan_drift.record_run(plan_drift.async_grid_run("cpu", 60,
                                                          **ASYNC_SMALL))
    card = plan_drift.record_run(plan_drift.async_grid_run(cuda.type, 60,
                                                           **ASYNC_SMALL))
    for key in ("bits_per_node", "n_active", "n_arrived", "flushed"):
        assert torch.equal(card[1][key].cpu(), cpu[1][key]), key
    reports = plan_drift.compare_recorded_grid(card, cpu)
    env = None
    for g, rep in enumerate(reports):
        if rep["max_rel_gap"] > plan_drift.STRICT and env is None:
            env = plan_drift.envelope("async", 60, ASYNC_SMALL)[0]
        faults = plan_drift.verdict(rep, 0.0 if env is None else env[g])
        assert not faults, (g, rep)


def test_geometric_delays_at_powers_of_two_on_the_card(cuda):
    """Geometric delays from u = 2^-j and its neighbours, and from
    200,000 real draws: every delay the card floors differently from the
    CPU has log(u) / log(q) within 4 ulps of an integer."""
    from repro_torch.core import driver
    u = np.array([2.0 ** -j for j in range(1, 24)]
                 + [np.nextafter(np.float32(2.0 ** -j), np.float32(s))
                    for j in range(1, 24) for s in (0, 1)], np.float32)
    keys = random.split(random.key(3, "cpu"), 100)
    draws = random.uniform(keys, (2000,),
                           minval=float(np.finfo(np.float32).tiny))
    for q in (0.5, 0.3):
        for x in (torch.as_tensor(u), draws.reshape(-1)):
            card = driver.geometric_delays(x.to(cuda), q, 60).cpu()
            host = driver.geometric_delays(x, q, 60)
            for i in torch.nonzero(card != host).reshape(-1).tolist():
                quo = np.log(np.float64(x[i])) / np.log(np.float64(
                    np.float32(q)))
                ulps = abs(quo - round(quo)) / np.spacing(np.float32(
                    abs(quo)))
                warnings.warn(f"geometric delay at u = {float(x[i])!r}, q "
                              f"{q}: card {int(card[i])}, CPU "
                              f"{int(host[i])}, {ulps:.2f} ulps from "
                              f"{round(quo)}")
                assert ulps <= 4 and abs(int(card[i]) - int(host[i])) == 1
    for kind in ("fixed", "uniform"):
        taus = torch.tensor([0, 1, 2, 4, 7])
        k5 = random.split(random.key(4, "cpu"), 5)
        assert torch.equal(driver.sample_delays(kind, k5.to(cuda), 500,
                                                taus.to(cuda)).cpu(),
                           driver.sample_delays(kind, k5, 500, taus))


def test_traffic_plan_chain_on_the_card_matches_the_cpu(cuda):
    """The five-method diurnal traffic plan (availability chain, admission
    cutoff 3, 6 in flight; tau 2) at d = 24, 40 rounds: every round's
    availability states, sends, delays and admitted arrivals, and the
    ledgers, bit for bit the CPU's."""
    from repro_torch import experiments, plan_drift
    from repro_torch.data.logreg import make_problem
    recs = [plan_drift.run_recorded(experiments.traffic_plan(
        make_problem(**ASYNC_SMALL, mu=1e-3, seed=0, device=dev),
        "diurnal", 40, 2)) for dev in (cuda, "cpu")]
    (res, calls), (cres, ccalls) = recs
    assert len(calls.routes) == len(ccalls.routes) == 5 * 40
    for a, b in zip(calls.routes, ccalls.routes):
        for key in ("avail", "send", "delays", "drained", "arrived"):
            assert torch.equal(a[key], b[key]), (a["label"], a["round"],
                                                 key)
    for lab in res.labels:
        for key in ("bits_per_node", "n_active", "n_arrived"):
            assert torch.equal(res.traces[lab][key].cpu(),
                               cres.traces[lab][key]), (lab, key)


# ---------------------------------------------------------------------------
# Hierarchy, cohort and sharding on the card
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("G", (1, 3))
def test_keyed_grouped_ids_match_plain(cuda, G):
    """The grouped keyed dither with global row ids bit for bit its plain
    version (a cohort's ids shared by the points, per-point ids, a
    federation's block), and ids 0..n-1 the kernel without ids."""
    from repro_torch.core import driver
    coh = driver.cohort_indices(random.split(random.key(31, "cpu"), G),
                                102_400, 64)
    gen = torch.Generator().manual_seed(G)
    for ids, L in ((coh[0], 123), (coh, 492), (torch.arange(10, 20), 5000)):
        n = ids.shape[-1]
        x = torch.randn((G * n, L), generator=gen) * 10
        keys = random.split(random.key(40 + G, "cpu"), G)
        s = torch.full((G,), 64.0)
        out, bits = ops.fused_dither_keyed_grouped(
            x.to(cuda), keys.to(cuda), s.to(cuda), ids.contiguous().to(cuda))
        want, want_bits = ref.fused_dither_keyed_grouped_ref(x, keys, s, ids)
        _same(out, want)
        _same(bits, want_bits)
        no_ids = ops.fused_dither_keyed_grouped(x.to(cuda), keys.to(cuda),
                                                s.to(cuda))[0]
        _same(ops.fused_dither_keyed_grouped(
            x.to(cuda), keys.to(cuda), s.to(cuda),
            torch.arange(n, device=cuda))[0], no_ids)


def test_hierarchy_grid_on_the_card_matches_the_cpu(cuda):
    """The hierarchy grid (identity, dither64, count_sketch64 edges; E = 4)
    at d = 24, 8 workers, 10 rounds, every compressor call recorded:
    edge_bits and bits_per_node the CPU's every round; every card message
    (the workers' and the edges') its replay on the CPU; where the runs
    part, the first differing message is a dither decision explained by
    the two devices' rounding, after rounds that agreed within 1e-6 (at
    this size one flipped level moves F by ~1e-4: F is held only up to
    that decision)."""
    from repro_torch import plan_drift
    cs = _chip_smoke()
    size = dict(d=24, n_workers=8, r=24)
    rec = plan_drift.record_run(cs.hierarchy_run(cuda, 10, **size))
    crec = plan_drift.record_run(cs.hierarchy_run("cpu", 10, **size))
    for key in ("edge_bits", "bits_per_node", "n_active"):
        assert torch.equal(rec[1][key].cpu(), crec[1][key]), key
    for rep in plan_drift.compare_recorded_grid(rec, crec):
        faults = [f for f in plan_drift.verdict(rep)
                  if not f.startswith("F parted")]
        assert not faults, faults
        if rep["max_rel_gap"] > plan_drift.STRICT:
            assert rep["first_difference"]["explained"], rep


@pytest.mark.parametrize("method", ("flecs", "diana", "gd"))
def test_cohort_on_the_card_matches_the_cpu(cuda, method):
    """A cohort run (K = 64 of N = 1,024, d = 24, 6 rounds): the ids and
    masks of every round and the ledgers the CPU's, F within rtol 1e-4."""
    cs = _chip_smoke()
    splits = {"flecs": 5, "diana": 3, "gd": 2}[method]
    a, b = (cs.cohort_draws(dev, 1024, 64, 6, splits)
            for dev in (cuda, "cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    st, tr = cs.cohort_run(method, cuda, 1024, 6, d=24)()
    cst, ctr = cs.cohort_run(method, "cpu", 1024, 6, d=24)()
    assert torch.equal(st.bits_per_node.cpu(), cst.bits_per_node)
    for key in ("cohort_bits", "n_active"):
        assert torch.equal(tr[key].cpu(), ctr[key]), key
    torch.testing.assert_close(tr["F"].cpu(), ctr["F"], rtol=1e-4, atol=0)


def test_cohort_round_memory_does_not_grow_with_n(cuda):
    """One cohort round's peak above the persistent state agrees within
    2 MiB at N = 1,024 and 102,400."""
    cs = _chip_smoke()
    counts = {name: 0 for name in ops.launches}
    peaks = [cs.cohort_memory("flecs", n, ops, counts)["round_peak_bytes"]
             for n in (1024, 102_400)]
    assert abs(peaks[0] - peaks[1]) <= 2 * 2**20, peaks
    assert counts["fused_dither_keyed_grouped"] > 0
    assert counts["fused_dither_keyed"] == 0


def test_sharded_world_size_one_equals_dense_on_the_card(cuda):
    """``run_sharded_sweep`` over one NCCL rank equals ``run_sweep`` on the
    card bit for bit (phase 3e's four runs, 50 rounds)."""
    cs = _chip_smoke()
    counts = {name: 0 for name in ops.launches}
    out = cs.phase_sharded(ops, counts)
    assert set(out) == {"FLECS fedsonia", "FLECS truncated_inverse",
                        "FLECS-CGD hierarchy", "DIANA"}


# ---------------------------------------------------------------------------
# Hessian-vector products: attention's tangent kernels and the m = 2 step
# ---------------------------------------------------------------------------

JVP_CASES = [(2, 8, 2, 200, 64, 0, 0.0, True), (1, 4, 4, 129, 32, 17, 0.0,
                                                False),
             (1, 2, 1, 96, 128, 0, 30.0, True), (1, 2, 2, 1, 64, 0, 0.0,
                                                  False),
             # one past and one short of a 64-row tile, the latter with a
             # window smaller than a tile and a cap
             (1, 4, 2, 65, 64, 0, 0.0, True), (1, 4, 1, 191, 32, 40, 20.0,
                                               False)]


@pytest.mark.parametrize("case", JVP_CASES)
def test_flash_tangent_kernels_match_plain_versions(cuda, case):
    cs = _chip_smoke()
    window, cap = case[5], case[6]
    q, k, v, tq, tk, tv, do, tdo = cs.jvp_inputs(case, cuda, seed=8)
    out, tout, lse, tlse = fa_ref.attention_jvp_ref(q, k, v, tq, tk, tv,
                                                    window, cap)
    want_b = fa_ref.attention_backward_jvp_ref(
        q, k, v, out, do, lse, tq, tk, tv, tout, tdo, tlse, window, cap)
    args = (q, k, v, tq, tk, tv, do, tdo, out, lse, tout, tlse, window, cap)
    fa_ops.reset_launches()
    got_f, got_b = cs.launch_jvp_pair(fa_ops, *args)
    again_f, again_b = cs.launch_jvp_pair(fa_ops, *args)
    assert fa_ops.launches["flash_attention_jvp"] == 2
    assert fa_ops.launches["flash_attention_backward_jvp"] == 2
    for a, b in zip(got_f + got_b, again_f + again_b):
        _same(a, b)
    for got, want in ((got_f, (tout, tlse)), (got_b, want_b)):
        scale = max(float(w.abs().max()) for w in want)
        for a, w in zip(got, want):
            assert float((a - w).abs().max()) <= 1e-5 * scale


def test_flash_tangent_kernels_unaligned_rows(cuda):
    """Operands and tangents whose rows do not start on 16 bytes (views of
    every 65th float) are copied before the tangent kernels stage them."""
    g = np.random.default_rng(12)
    B, H, KV, S, D = 1, 4, 2, 100, 64

    def one(h):
        return torch.as_tensor(g.normal(size=(B, h, S, D + 1)).astype(
            np.float32)).to(cuda)[..., :D]

    q, k, v, tq, tk, tv, do, tdo = (one(h) for h in (H, KV, KV, H, KV, KV,
                                                     H, H))
    out, tout, lse, tlse = fa_ref.attention_jvp_ref(q, k, v, tq, tk, tv)
    want_b = fa_ref.attention_backward_jvp_ref(
        q, k, v, out, do, lse, tq, tk, tv, tout, tdo, tlse)
    got_f, got_b = _chip_smoke().launch_jvp_pair(
        fa_ops, q, k, v, tq, tk, tv, do, tdo, out, lse, tout, tlse, 0, 0.0)
    for got, want in ((got_f, (tout, tlse)), (got_b, want_b)):
        scale = max(float(w.abs().max()) for w in want)
        for a, w in zip(got, want):
            assert float((a - w).abs().max()) <= 1e-5 * scale


def test_tangent_kernels_run_on_the_tensor_cores(cuda):
    """The forward-, dK/dV- and dQ-tangent kernels at D = 32, 64 and 128
    each hold HMMA in their SASS (3xTF32 on mma.sync)."""
    counts = _chip_smoke().jvp_mma_sass(fa_ops)
    assert len(counts) == 9 and all(counts.values())


def test_dual_reaching_a_raw_launch_raises(cuda):
    import torch.autograd.forward_ad as fwAD
    q = torch.randn(1, 2, 64, 32, device=cuda)
    key = random.key(0, cuda)
    with fwAD.dual_level():
        qd = fwAD.make_dual(q, torch.ones_like(q))
        x = fwAD.make_dual(torch.randn(4, 64, device=cuda),
                           torch.ones(4, 64, device=cuda))
        for call in (lambda: fa_ops._launch(qd, q, q, torch.empty_like(q), 0,
                                            0.0),
                     lambda: d_ops.dither_encode_keyed(x, key, block_rows=4),
                     lambda: ops.fused_dither_keyed(x, key, 8.0),
                     lambda: ops.fused_topk(x, 0.25)):
            with pytest.raises(RuntimeError, match="dual tensor"):
                call()
        # through the Function the tangent reaches its own kernel
        fa_ops.reset_launches()
        out = fa_ops.flash_attention(qd, q, q)
        assert fwAD.unpack_dual(out).tangent is not None
        assert fa_ops.launches["flash_attention_jvp"] == 1


def _card_hvp(cuda, head):
    """The HVP of ``head(o, q)`` (o attention's output, window and cap)
    through ``fa_ops.attention`` and through the plain path, both on the
    card; asserts the kernel run's launches."""
    from repro_torch.core import hessian
    g = torch.Generator(device="cpu").manual_seed(9)
    B, S, H, KV, D, E = 2, 70, 4, 2, 32, 16
    W = [(torch.randn(E, n * D, generator=g) * 0.3).to(cuda)
         for n in (H, KV, KV)]
    T = [torch.randn(w.shape, generator=g).to(cuda) for w in W]
    x = torch.randn(B, S, E, generator=g).to(cuda)

    def loss(ws, kernel):
        q, k, v = ((x @ w).view(B, S, -1, D) for w in ws)
        if kernel:
            o = fa_ops.attention(q, k, v, window=9, cap=20.0)
        else:
            o = fa_ref.attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                     9, 20.0).transpose(1, 2)
        return head(o, q)

    fa_ops.reset_launches()
    got = hessian.hvp_pytree(lambda ws: loss(ws, True), W, T)
    assert fa_ops.launches == {"flash_attention": 1,
                               "flash_attention_backward": 1,
                               "flash_attention_jvp": 1,
                               "flash_attention_backward_jvp": 1}
    want = hessian.hvp_pytree(lambda ws: loss(ws, False), W, T)
    return got, want


def test_hvp_through_attention_on_the_card(cuda):
    got, want = _card_hvp(cuda, lambda o, q: (o ** 2).sum() + (o * q).sum())
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_hvp_of_a_loss_linear_in_the_output_on_the_card(cuda):
    """(o · c) summed: the backward's grad_out carries no tangent, q, k and
    v do; the backward-tangent kernel must still get tO and t_lse."""
    c = torch.randn(2, 70, 4, 32,
                    generator=torch.Generator(device="cpu").manual_seed(10))
    c = c.to(cuda)
    got, want = _card_hvp(cuda, lambda o, q: (o * c).sum())
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_flecs_m2_step_on_the_card_matches_the_cpu(cuda):
    """One m = 2 FLECS-CGD step (smoke tinyllama widths at depth 2, remat)
    on the card and on the CPU from the same weights, then the new
    weights' loss."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import uniform_plan
    from repro_torch.core.dl_flecs import (FlecsDLConfig, init_shifts,
                                           make_flecs_train_step)
    from repro_torch.models.model import init_params
    from repro_torch.train.step import _loss_fn
    cfg = get_config("tinyllama-1.1b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=2,
                              layer_plan=uniform_plan(2, *cfg.layer_plan[0]))
    params = init_params(cfg, random.key(0, cuda), torch.float32)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        stream = train_launch.token_batches(cfg, 4, 32, dev)
        b0, b1 = next(stream), next(stream)
        fa_ops.reset_launches()
        step = make_flecs_train_step(cfg, FlecsDLConfig(alpha=0.09, m=2),
                                     remat=True)
        new, _, m = step(p, init_shifts(p), b0, 0)
        if dev.type == "cuda":
            L = cfg.n_layers
            assert fa_ops.launches == {"flash_attention": 6 * L,
                                       "flash_attention_backward": 3 * L,
                                       "flash_attention_jvp": 4 * L,
                                       "flash_attention_backward_jvp": 2 * L}
        with torch.no_grad():
            nxt = _loss_fn(new, b1, cfg)
        res[dev.type] = (float(m["loss"]), float(nxt),
                         float(m["uplink_mbits"]))
    (l0, l1, up), (c0, c1, cup) = res["cuda"], res["cpu"]
    assert up == cup
    assert abs(l0 - c0) <= 1e-5 * abs(c0) and abs(l1 - c1) <= 1e-5 * abs(c1)


def test_flecs_workers_step_on_the_card_matches_the_cpu(cuda):
    """Two FLECS-CGD steps of 4 workers (m = 0; smoke tinyllama widths at
    depth 2, remat, batch 8 x 32) on the card and on the CPU from the same
    weights: losses rtol 1e-5, uplink equal; on the card the split encode
    entries launch once a leaf and worker, the fused one never."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import uniform_plan
    from repro_torch.models.model import init_params
    cfg = get_config("tinyllama-1.1b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=2,
                              layer_plan=uniform_plan(2, *cfg.layer_plan[0]))
    params = init_params(cfg, random.key(0, cuda), torch.float32)
    n_leaves = len(tree_leaves(params))
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        p = tree_map(lambda t: t.to(dev), params)
        d_ops.reset_launches()
        runs[dev.type] = train_launch.train(
            cfg, p, train_launch.token_batches(cfg, 8, 32, dev), 2,
            flecs=True, workers=4)
        if dev.type == "cuda":
            n = 2 * 4 * n_leaves
            assert d_ops.launches == {"dither_encode": 0,
                                      "dither_encode_keyed": 0,
                                      "dither_absmax": n,
                                      "dither_levels_keyed": n,
                                      "dither_decode": n}
    for a, b in zip(runs["cuda"]["metrics"], runs["cpu"]["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert a["uplink_mbits"] == b["uplink_mbits"]


def test_dual_remat_gives_torch_checkpoints_bits_on_the_card(cuda,
                                                             monkeypatch):
    """On inputs without tangents ``_dual_remat`` gives the card's loss and
    gradients that ``torch.utils.checkpoint`` gives, bit for bit (smoke
    tinyllama widths at depth 2, float32)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import uniform_plan
    from repro_torch.models import model
    from repro_torch.tree import tree_flatten, tree_unflatten
    cfg = get_config("tinyllama-1.1b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=2,
                              layer_plan=uniform_plan(2, *cfg.layer_plan[0]))
    params = model.init_params(cfg, random.key(0, cuda), torch.float32)
    batch = next(train_launch.token_batches(cfg, 4, 32, cuda))
    fa_ops.reset_launches()
    want = value_and_grad(params, batch, cfg, remat=True)
    assert fa_ops.launches["flash_attention_backward"] == cfg.n_layers

    def dual_remat(fn, sp, x, m, cfg, positions, **kwargs):
        leaves, treedef = tree_flatten(sp)
        return model._dual_remat(
            lambda *ts: fn(tree_unflatten(treedef, list(ts[:-1])), ts[-1],
                           m, cfg, positions)[0],
            *leaves, x), torch.zeros((), device=x.device)

    monkeypatch.setattr(model, "checkpoint", dual_remat)
    got = value_and_grad(params, batch, cfg, remat=True)
    assert torch.equal(got[0], want[0])
    for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The families' training: the float32 backward at (256, 256) and (192, 128)
# ---------------------------------------------------------------------------

#: B, H, KV, S, Dk, Dv, window, cap: gemma2's window and cap, MQA past a
#: window over 16 heads (recurrentgemma's group), MLA's pair with H = KV
#: (deepseek) and GQA, one row, and ragged lengths.
FAMILY_BWD_SHAPES = [(2, 4, 2, 200, 256, 256, 100, 50.0),
                     (1, 16, 1, 300, 256, 256, 70, 0.0),
                     (1, 2, 1, 1, 256, 256, 0, 0.0),
                     (2, 4, 4, 200, 192, 128, 0, 0.0),
                     (1, 8, 2, 130, 192, 128, 40, 30.0),
                     (1, 128, 128, 64, 192, 128, 0, 0.0)]


def _pair_inputs(shape, model_layout, seed):
    B, H, KV, S, Dk, Dv = shape[:6]
    g = np.random.default_rng(seed)
    dims = ((B, H, S, Dk), (B, KV, S, Dk), (B, KV, S, Dv), (B, H, S, Dv))
    ts = [torch.as_tensor(g.normal(size=s).astype(np.float32)) for s in dims]
    if model_layout:
        ts = [t.transpose(1, 2).contiguous() for t in ts]
    return ts


@pytest.mark.parametrize("shape", FAMILY_BWD_SHAPES)
@pytest.mark.parametrize("model_layout", [False, True])
def test_flash_backward_family_pairs_match_plain_version(cuda, shape,
                                                         model_layout):
    """The float32 backward at (256, 256) and (192, 128) against the plain
    version under autograd on the same card: max |Δ| <= 1e-5 · max |grad|
    over dq, dk and dv, in the kernel layout and through ``ops.attention``
    on model-layout tensors (strided views); one backward launch at the
    pair, the same bits over two runs."""
    window, cap = shape[6], shape[7]
    q, k, v, do = (t.to(cuda) for t in _pair_inputs(shape, model_layout,
                                                    sum(shape[:6])))
    if model_layout:
        card = lambda a, b, c: fa_ops.attention(a, b, c, window, cap)  # noqa: E731
        plain = lambda a, b, c: fa_ref.attention_ref(                # noqa: E731
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), window,
            cap).transpose(1, 2)
    else:
        card = lambda a, b, c: fa_ops.flash_attention(a, b, c, window, cap)  # noqa: E731
        plain = lambda a, b, c: fa_ref.attention_ref(a, b, c, window, cap)  # noqa: E731

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves), leaves, do)

    fa_ops.reset_launches()
    got = grads(card)
    assert fa_ops.backward_launches_by_pair == {shape[4:6]: 1}
    again = grads(card)
    want = grads(plain)
    bound = 1e-5 * max(float(w.abs().max()) for w in want)
    for a, b, c in zip(got, again, want):
        assert a.shape == c.shape and a.dtype == torch.float32
        _same_exact(a, b)
        assert float((a - c).abs().max()) <= bound


@pytest.mark.parametrize("dk,dv", [(256, 256), (192, 128)])
def test_flash_forward_writes_the_lse_at_family_pairs(cuda, dk, dv):
    """The forward's log-sum-exp output, which the backward reads, at the
    new pairs: within 2e-5 (rtol and atol) of the plain scores'
    logsumexp, window and cap applied."""
    B, H, KV, S, window, cap = 1, 4, 2, 150, 60, 50.0
    q, k, v, _ = (t.to(cuda) for t in _pair_inputs(
        (B, H, KV, S, dk, dv), False, dk))
    out = torch.empty((B, H, S, dv), device=cuda)
    lse = torch.empty((B, H, S), device=cuda)
    fa_ops._launch(q, k, v, out, window, cap, lse)
    kk = k.repeat_interleave(H // KV, dim=1)
    s = (q @ kk.transpose(-1, -2)) / dk ** 0.5
    s = cap * torch.tanh(s / cap)
    i = torch.arange(S, device=cuda)
    keep = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dk,dv", [(256, 256), (192, 128)])
def test_flash_backward_bf16_family_pairs_raise(cuda, dk, dv):
    """bfloat16 training at the new pairs is on no path: the call raises
    before its forward, naming the queue item; float32 goes through."""
    q, k, v, _ = (t.to(cuda, torch.bfloat16).requires_grad_(True)
                  for t in _pair_inputs((1, 2, 1, 32, dk, dv), False, 1))
    with pytest.raises(ValueError, match="'bf16 family backward'"):
        fa_ops.flash_attention(q, k, v)


#: sha256 of the forward output and the backward's dq, dk, dv at D <= 128
#: (B 2, H 8, KV 2, S 333; D 32 with a cap of 30, D 64 with a window of
#: 100), as the kernels gave them before they were templated on (Dk, Dv),
#: on an NVIDIA H100 80GB HBM3: the templated instances keep the bits.
BWD_DIGESTS = {
    "32-float32":
        "05bb76c7eec6b44dbf37ed3f326791aaea43a54f1d9ae96d08b3b477e0bd76b9",
    "64-float32":
        "2d87e42a69670ad9119257f8fa5ef2de7c31ccc03ff6e398b29fe1fd112aa97f",
    "128-float32":
        "46eba7ed2965d39955f03061b0153a4701b58ecc60a262209de0f896c3713cd5",
    "64-bfloat16":
        "dd116ef6c9d98fc01a4612c1a667e3e1d2d3250ef2ae102ffe8dc9db5790472c",
    "128-bfloat16":
        "6a67cba3f720060ca7274a02981ebcd60f132398d7a515e8527b33237abfb9f0"}


@pytest.mark.parametrize("case", ["32-float32", "64-float32", "128-float32",
                                  "64-bfloat16", "128-bfloat16"])
def test_flash_backward_keeps_its_bits_at_square_dims(cuda, case):
    import hashlib
    D, name = case.split("-")
    D, dt = int(D), getattr(torch, name)
    B, H, KV, S = 2, 8, 2, 333
    g = np.random.default_rng(D)
    q, k, v, do = (torch.as_tensor(g.normal(size=s).astype(np.float32)).to(
        cuda, dt) for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D),
                            (B, H, S, D)))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    o = fa_ops.flash_attention(*leaves, window=100 if D == 64 else 0,
                               cap=30.0 if D == 32 else 0.0)
    grads = torch.autograd.grad(o, leaves, do)
    h = hashlib.sha256()
    for t in (o, *grads):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    assert h.hexdigest() == BWD_DIGESTS[case]


# ---------------------------------------------------------------------------
# The bf16 forward on wgmma at (192, 128) and the wide backward's one dK/dV
# launch
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py as a module (its SASS, profile and digest helpers)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: B, H, KV, S, window, cap at MLA's (192, 128): deepseek-v3's prefill, a
#: ragged last tile, window and cap under MQA, one tile.
WGMMA_FWD_SHAPES = [(8, 128, 128, 1024, 0, 0.0), (2, 4, 4, 200, 0, 0.0),
                    (1, 4, 1, 130, 40, 20.0), (1, 2, 2, 64, 0, 0.0)]


@pytest.mark.parametrize("B,H,KV,S,window,cap", WGMMA_FWD_SHAPES)
@pytest.mark.parametrize("model_layout", [False, True])
def test_flash_forward_bf16_mla_runs_on_wgmma_and_matches(cuda, B, H, KV, S,
                                                          window, cap,
                                                          model_layout):
    """bf16 at (192, 128) launches the wgmma forward (``forward_plan``),
    within rtol = atol = 2e-2 of the plain version, the same bits over two
    runs, in the kernel and the model layout."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, H, S, 192), (B, KV, S, 192), (B, KV, S, 128)))
    if model_layout:
        run = lambda: fa_ops.attention(                      # noqa: E731
            *(t.transpose(1, 2) for t in (q, k, v)), window,
            cap).transpose(1, 2)
    else:
        run = lambda: fa_ops.flash_attention(q, k, v, window, cap)  # noqa: E731
    fa_ops.reset_launches()
    got, again = run(), run()
    assert fa_ops.forward_launches_by_kernel == {"mma_sync": 0, "wgmma": 2}
    _same(got.float(), again.float())
    want = fa_ref.attention_ref(q, k, v, window, cap)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S, 128)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_flash_forward_wgmma_lse_matches_the_mma_sync_kernel(cuda):
    """The wgmma forward's log-sum-exp (base 2 inside) agrees with the
    mma.sync kernel's within 1e-4."""
    B, H, KV, S = 2, 4, 2, 150
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, H, S, 192), (B, KV, S, 192), (B, KV, S, 128)))
    lse = {}
    for kernel in ("wgmma", "mma_sync"):
        out = torch.empty((B, H, S, 128), dtype=torch.bfloat16, device=cuda)
        lse[kernel] = torch.empty((B, H, S), device=cuda)
        fa_ops._launch(q, k, v, out, 30, 0.0, lse[kernel], kernel=kernel)
    torch.testing.assert_close(lse["wgmma"], lse["mma_sync"], rtol=1e-4,
                               atol=1e-4)


def test_flash_forward_bf16_mla_runs_on_wgmma(cuda):
    """Each instance of the bf16 forward on wgmma holds HGMMA in the SASS of
    the library built (cuobjdump), as the bf16 backward's do."""
    counts = _chip_smoke().fwd_wgmma_sass(fa_ops)
    assert len(counts) == 4 and all(counts.values()), counts


@pytest.mark.parametrize("dk,dv", [(256, 256), (192, 128)])
def test_flash_backward_wide_pairs_launch_one_dkdv_kernel(cuda, dk, dv):
    """The float32 backward at the wide pairs launches one dK/dV kernel and
    one dQ kernel (eight warps a CTA) beside the Delta kernel."""
    shape = (1, 4, 2, 130, dk, dv, 0, 0.0)
    q, k, v, dout = (t.to(cuda) for t in _pair_inputs(shape, False, 3))
    out = torch.empty_like(dout)
    lse = torch.empty((1, 4, 130), device=cuda)
    fa_ops._launch(q, k, v, out, 0, 0.0, lse)
    dq, dk_, dv_ = (torch.empty_like(t) for t in (q, k, v))
    split = _chip_smoke().kernel_split(lambda: fa_ops._launch_backward(
        q, k, v, out, dout, lse, dq, dk_, dv_, 0, 0.0))
    names = sorted(n for n in split if "flash_bwd" in n)
    assert [n.split("<")[0] for n in names] == [
        "flash_bwd_delta_kernel", "flash_bwd_dkdv_wide_kernel",
        "flash_bwd_dq_wide_kernel"], split
    assert all(split[n]["launches"] == 1 for n in names), split


#: sha256 of the forward's output and log-sum-exp at each
#: ``chip_smoke.FWD_DIGEST_CASES`` case (``chip_smoke.flash_digest``), as
#: the parent of the wgmma forward and the wide backward gave them on an
#: NVIDIA H100 80GB HBM3 (``kernel_timing.py flash-families``): the
#: instances those kernels leave alone keep their bits.
FWD_DIGESTS = {
    "float32 32 32 0 30.0":
        "e4d9929a1af2f765889e2fbccc6d3ac95ffcccd759c5c43653033aff1801167b",
    "float32 64 64 100 0.0":
        "568ba70b6072bade8ef9faab286a0976254102b6958193b8a6a1d20699b3fada",
    "float32 128 128 0 0.0":
        "01407391081fc1070f117e5a2d20b8434cc9897bca35105f476fb1ff9386d19b",
    "float32 256 256 70 50.0":
        "c9cca2c3418796f76cb3aae5b24a4254098d325f2531e9b9d5b811865311445f",
    "float32 192 128 0 0.0":
        "30ce8c7698e2f6f990e5862f262c2b295c41aa73842ce0c56ec6ac79306ae2e8",
    "bfloat16 32 32 0 30.0":
        "b3757bd1080ac9b9ebf643b2cea224149a4fb3f60d4b022ed9f7c37e645545e1",
    "bfloat16 64 64 100 0.0":
        "d105d4d42b2233b38100cb9679666477a7ab4467c941bb4d919e60d76913dafb",
    "bfloat16 128 128 0 0.0":
        "f9219a89e323e971f59ecb67d3b79c752369496469af585c4994489215e27210",
    "bfloat16 256 256 70 50.0":
        "a0260ed0be8d54386b97db5f2e6c5f0de60a3f16ba8fdf24ad0c7d41a55c7666"}


@pytest.mark.parametrize("case", list(range(9)))
def test_flash_forward_keeps_its_bits_where_untouched(cuda, case):
    chip_smoke = _chip_smoke()
    key = " ".join(map(str, chip_smoke.FWD_DIGEST_CASES[case]))
    assert chip_smoke.flash_digest(fa_ops, chip_smoke.FWD_DIGEST_CASES[
        case]) == FWD_DIGESTS[key]


#: Each family's depth-2 plan at smoke width (indices into its smoke
#: plan), as ``test_torch_family_training.py`` takes it.
FAMILY_DEPTH2 = {"mamba2-1.3b": (0, 0), "recurrentgemma-9b": (0, 2),
                 "gemma2-9b": (0, 1), "deepseek-v3-671b": (0, 1),
                 "qwen3-moe-235b-a22b": (0, 0),
                 "llava-next-mistral-7b": (0, 0), "musicgen-large": (0, 0)}


@pytest.mark.parametrize("arch", list(FAMILY_DEPTH2))
@pytest.mark.parametrize("flecs,workers", [(False, 1), (True, 1), (True, 2)])
def test_family_training_on_the_card_matches_the_cpu(cuda, arch, flecs,
                                                     workers):
    """One adam or FLECS-CGD (m = 0; one worker, or two on a row each)
    step of each family at smoke width
    and depth 2 (gemma2 at head dim 256), card against CPU from the same
    weights and ``token_batches`` batch: loss within 1e-5 relative,
    ``uplink_mbits`` equal, the params as ``test_torch_family_training``
    holds them against the reference; the card's backward launched once
    an attention layer at the layer's pair."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=2, layer_plan=tuple(
        cfg.layer_plan[i] for i in FAMILY_DEPTH2[arch]))
    if arch == "gemma2-9b":
        cfg = dataclasses.replace(cfg, head_dim=256)
    params = init_params(cfg, random.key(0, cuda), torch.float32)
    batch = next(train_launch.token_batches(cfg, 2, 80, cuda))
    n_attn = sum(m in ("attn_global", "attn_local", "attn_mla")
                 for m, _ in cfg.layer_plan)
    pair = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
            if cfg.is_mla else (cfg.head_dim, cfg.head_dim))
    fa_ops.reset_launches()
    card = train_launch.train(cfg, params, iter([batch]), 1, flecs=flecs,
                              workers=workers)
    assert fa_ops.backward_launches_by_pair == (
        {pair: n_attn * workers} if n_attn else {})
    cpu = train_launch.train(cfg, tree_map(lambda t: t.cpu(), params),
                             iter([tree_map(lambda t: t.cpu(), batch)]), 1,
                             flecs=flecs, workers=workers)
    a, b = card["metrics"][0], cpu["metrics"][0]
    assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
    diff = torch.cat([(x.cpu() - y).abs().float().reshape(-1) for x, y in
                      zip(tree_leaves(card["params"]),
                          tree_leaves(cpu["params"]))])
    if flecs:
        assert a["uplink_mbits"] == b["uplink_mbits"]
        h = max(float(t.float().abs().max())
                for t in tree_leaves(cpu["state"]["mean"]))
        assert float(diff.max()) <= 3e-3 * 30 * 2 * h / 127 + 1e-6
    else:
        assert float((diff > 1e-6).float().mean()) <= 1e-3
        assert float(diff.max()) <= 2 * 3e-3
