"""fused_topk's grid-wide instance, modelled in numpy, against the JAX
reference ``compressors._topk`` and the plain version ``fused_topk_ref``;
and the rule (``topk_plan``) that picks the instance.

The CUDA kernel (``repro_fused_topk_grid`` in ``compressor.cu``) runs only
on the card, where ``tests/test_torch_gpu.py`` holds it to the plain version
bit for bit.  Here ``grid_topk_model`` walks the same steps on the CPU: the
chunk boundaries (a row's head before its first 16-byte aligned element
goes to chunk 0, its tail to the last chunk), the three digits of 11, 11
and 10 bits, histograms summed chunk by chunk in any order, the candidate
buffer and its overflow back to x, the threshold's float compares, and the
per-chunk tie counts that rank the ties of the one chunk where the budget
runs out.  Tolerance: none; a selection is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jc
from repro_torch.kernels.compressor import ops as tops
from repro_torch.kernels.compressor import ref as tref

_topk_ref = jax.jit(lambda r, f: jc._topk(None, r, f))

#: (digit's lowest bit, bins, bits fixed before the pass) of each pass
DIGITS = ((21, 2048, 0x00000000), (10, 2048, 0xFFE00000),
          (0, 1024, 0xFFFFFC00))


def chunk_parts(L, chunk, head):
    """The kernel's ``chunk_tiles``: for each chunk, its element ranges in
    row order.  ``head`` is the number of elements before the row's first
    16-byte aligned one (0..3)."""
    head = min(head, L)
    vend = head + ((L - head) & ~3)
    nc = -(-L // chunk)
    parts = []
    for c in range(nc):
        mine = []
        if c == 0 and head:
            mine.append((0, head))
        lo = min(head + c * chunk, vend)
        hi = min(lo + chunk, vend)
        if hi > lo:
            mine.append((lo, hi))
        if c == nc - 1 and vend < L:
            mine.append((vend, L))
        parts.append(mine)
    return parts


def _pick(hist, want):
    """The digit where the count from the top reaches want: (digit, count
    above it, count in it)."""
    above = 0
    for d in range(len(hist) - 1, -1, -1):
        if above + hist[d] >= want:
            return d, above, int(hist[d])
        above += int(hist[d])
    raise AssertionError("want beyond the histogram")


def grid_topk_model(x, frac, chunk, cap, head=0, seed=0):
    """One row through the grid-wide select.  Returns (out, route), route
    saying whether the candidates fit and whether the ties were ranked."""
    x = np.asarray(x, np.float32)
    L = x.size
    k = tref.topk_keep_count(frac, L)
    p = x.view(np.uint32) & np.uint32(0x7FFFFFFF)
    idx = [np.concatenate([np.arange(a, b) for a, b in part]
                          + [np.zeros(0, np.int64)])
           for part in chunk_parts(L, chunk, head)]
    nc = len(idx)
    order = np.random.default_rng(seed).permutation(nc)   # CTAs in any order
    nan = int(np.sum(p > 0x7F800000))
    want, prefix, above_all, match, fits, cand = k, 0, 0, 0, False, []
    for pass_, (shift, bins, fixed) in enumerate(DIGITS):
        hist = np.zeros(bins, np.int64)
        if pass_ == 2 and fits:
            src = [np.concatenate(cand)]
            assert src[0].size == match
        else:
            src = [p[idx[c]] for c in order]
        for part in src:
            sel = part[(part & np.uint32(fixed)) == prefix]
            hist += np.bincount((sel >> shift) & (bins - 1), minlength=bins)
            if pass_ == 1 and fits:
                cand.append(sel)
        d, above, count = _pick(hist, want)
        prefix |= d << shift
        above_all += above
        want -= above
        if pass_ == 0:
            match = count
            fits = match <= cap
    nan_th = prefix > 0x7F800000
    n_above = 0 if nan_th else above_all - nan
    n_ties = 0 if nan_th else count
    budget = k - n_above
    rank_mode = n_ties > budget
    th = np.uint32(prefix).view(np.float32)
    ax = np.abs(x)
    ties = [int(np.sum(ax[i] == th)) for i in idx] if rank_mode else [0] * nc
    out = np.zeros_like(x)
    for c in range(nc):
        seen = sum(ties[:c])
        keep_ties = not rank_mode or seen + ties[c] <= budget
        rank = rank_mode and seen < budget and not keep_ties
        for i in idx[c]:
            tie = ax[i] == th
            keep = ax[i] > th or (keep_ties and tie)
            if rank and tie:
                seen += 1
                keep = seen <= budget
            if keep:
                out[i] = x[i]
    return out, {"fits": fits, "ranked": rank_mode}


def _same(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _rows(rng):
    """The test rows: (name, row)."""
    L = 4099                                      # not a multiple of 4
    straddle = (rng.normal(size=L) * 1e-3).astype(np.float32)
    for c in range(1, 16):                        # ties across chunk edges
        straddle[c * 256 - 30:c * 256 + 30] = 5.0
    straddle[rng.integers(0, L, 25)] = 9.0
    special = rng.normal(size=L).astype(np.float32)
    special[::97] = np.nan
    special[5::89] = np.inf
    special[7::83] = -np.inf
    special[::13] = -0.0
    special[1::17] = 0.0
    subnormal = (rng.normal(size=L) * 1e-41).astype(np.float32)
    subnormal[::7] = 0.0
    subnormal[::11] = -0.0
    return [("gaussian", rng.normal(size=L).astype(np.float32)),
            ("straddling ties", straddle),
            ("all-equal", np.full(L, -2.5, np.float32)),
            ("integer ties", rng.integers(-3, 4, L).astype(np.float32)),
            ("nan inf -0", special),
            ("subnormals", subnormal),
            ("short", rng.normal(size=7).astype(np.float32))]


ROW_NAMES = [name for name, _ in _rows(np.random.default_rng(0))]


@pytest.mark.parametrize("name", ROW_NAMES)
@pytest.mark.parametrize("frac", [1e-4, 0.01, 0.25, 1.0])
@pytest.mark.parametrize("head", [0, 3])
def test_grid_model_matches_reference(name, frac, head):
    """The model's selection equals the reference's ``_topk`` and the plain
    version, bit for bit, with chunks of 256 and the candidate buffer of
    the wrapper's size (L // TOPK_CAND_DIV).  Subnormal rows are held to
    the IEEE order instead of the reference: XLA on the CPU compares
    subnormals as zero (ROADMAP.md, section 3), the port does not."""
    x = dict(_rows(np.random.default_rng(0)))[name]
    got, _ = grid_topk_model(x, frac, 256, max(x.size // tops.TOPK_CAND_DIV,
                                               1), head)
    if name == "subnormals":
        k = tref.topk_keep_count(frac, x.size)
        order = np.lexsort((np.arange(x.size), -np.abs(x)))
        want = np.zeros_like(x)
        want[order[:k]] = x[order[:k]]
    else:
        want = np.asarray(_topk_ref(jnp.asarray(x), jnp.float32(frac)))
    _same(got, want)
    plain, _ = tref.fused_topk_ref(torch.as_tensor(x[None]), frac)
    _same(got, plain[0].numpy())


@pytest.mark.parametrize("name", ROW_NAMES)
@pytest.mark.parametrize("chunk", [4, 64, 1024, 8192])
def test_grid_model_chunking_and_overflow(name, chunk):
    """Chunk sizes from one tile to more than the row, each head (row
    alignment), and the candidate buffer from too small (the third pass
    reads x again) to large: one selection."""
    x = dict(_rows(np.random.default_rng(1)))[name]
    want, _ = tref.fused_topk_ref(torch.as_tensor(x[None]), 0.1)
    for head in range(4):
        for cap in (1, x.size // 64, x.size):
            got, _ = grid_topk_model(x, 0.1, chunk, cap, head, seed=chunk)
            _same(got, want[0].numpy())


def test_grid_model_routes():
    """The rows take the routes they are meant to test: the all-equal row
    overflows the candidate buffer and ranks its ties, the straddling ties
    are ranked across chunks, a Gaussian row at frac 0.25 fits the buffer
    (its first-digit bin holds ~10.6% of the row, the buffer 12.5%) and
    keeps its one tie unranked."""
    rows = dict(_rows(np.random.default_rng(0)))
    L = 4099
    cap = L // tops.TOPK_CAND_DIV
    assert grid_topk_model(rows["all-equal"], 0.1, 256, cap)[1] == {
        "fits": False, "ranked": True}
    assert grid_topk_model(rows["straddling ties"], 0.01, 256, cap)[1][
        "ranked"]
    g = np.random.default_rng(2).normal(size=1 << 16).astype(np.float32)
    assert grid_topk_model(g, 0.25, 4096, g.size // 8)[1] == {
        "fits": True, "ranked": False}


@pytest.mark.parametrize("L,chunk,head", [(1, 4, 0), (1, 4, 3), (3, 4, 1),
                                          (4099, 256, 0), (4099, 256, 3),
                                          (8192, 4096, 2), (100, 8, 1)])
def test_chunk_parts_cover_the_row_in_order(L, chunk, head):
    """Every element in exactly one chunk, chunks in row order, each chunk's
    vector range 16-byte aligned and at most ``chunk`` long."""
    parts = chunk_parts(L, chunk, head)
    assert len(parts) == -(-L // chunk)
    flat = [i for part in parts for a, b in part for i in range(a, b)]
    assert flat == list(range(L))
    for c, part in enumerate(parts):
        for a, b in part:
            if a >= min(head, L) and b - a >= 4 and (a, b) != (0, head):
                assert (a - head) % 4 == 0 and b - a <= chunk


@pytest.mark.parametrize("rows,L,plan", [
    (20, 492, "cluster"), (20, 20000, "cluster"), (60, 15129, "cluster"),
    (1, 300_000, "grid"), (1, 3_000_000, "grid"),
    (20, 25_000_000, "grid"), (60, 25_000_000, "grid")])
def test_topk_plan_at_the_timed_shapes(rows, L, plan):
    """The quickstart and plan shapes keep the cluster instance; the long
    rows (phase 2's single rows, FedNL at gisette width) take the grid."""
    kind, size = tops.topk_plan(rows, L, 132)
    assert kind == plan
    if kind == "cluster":
        assert size == tops.topk_cluster(rows, L, 132)
    else:
        assert size == tops.topk_chunk(rows, L, 132)


@pytest.mark.parametrize("rows,L,chunk", [
    (1, 131_072, 4096), (1, 300_000, 4096), (1, 3_000_000, 4096),
    (1, 5_000_000, 8192), (20, 25_000_000, 32768),
    (60, 25_000_000, 32768)])
def test_topk_chunk_rule(rows, L, chunk):
    """The grid instance's chunk: the smallest power of two from
    TOPK_CHUNK_MIN that keeps the grid within TOPK_GRID_CTAS_PER_SM CTAs an
    SM (132 SMs), at most TOPK_CHUNK_MAX."""
    assert tops.topk_chunk(rows, L, 132) == chunk
    assert chunk % 4 == 0


def test_topk_plan_crossover_edges():
    """The grid takes rows of TOPK_GRID_MIN_L and longer, up to 65,535 rows
    (the grid's y extent); below, the cluster rule."""
    edge = tops.TOPK_GRID_MIN_L
    assert tops.topk_plan(1, edge, 132)[0] == "grid"
    assert tops.topk_plan(1, edge - 1, 132) == ("cluster", 8)
    assert tops.topk_plan(65_535, edge, 132)[0] == "grid"
    assert tops.topk_plan(65_536, edge, 132)[0] == "cluster"


def test_grid_workspace_size():
    """The grid instance's workspace at [60, 25e6]: the histograms, state
    and chunk tie counts, and the candidate buffer, 12.5% of x's bytes and
    a little more."""
    rows, L = 60, 25_000_000
    nc = -(-L // tops.topk_chunk(rows, L, 132))
    words = rows * (tops.TOPK_GRID_WS_WORDS + nc) + rows * (
        L // tops.TOPK_CAND_DIV)
    assert words / (rows * L) < 0.126


def test_topk_instances_counted_only_on_the_card():
    """The plain version (a CPU tensor) counts no instance launch."""
    tops.reset_launches()
    tops.fused_topk(torch.ones((2, 8)), 0.5)
    tops.fused_topk_grouped(torch.ones((2, 8)), torch.tensor([0.5]))
    assert tops.topk_instances == {
        "fused_topk": {"cluster": 0, "grid": 0},
        "fused_topk_grouped": {"cluster": 0, "grid": 0}}
