"""The port's compressors and their kernels' plain versions against the JAX
reference: ``compressors._dither`` / ``_topk`` / ``spec_bits`` and the
Pallas kernels of ``repro.kernels.compressor`` run in interpret mode.

Tolerance: none.  Dithering is abs/max/div/floor/compare in the reference's
expression order and top-k is a selection, so on identical inputs (the
same x, and uniforms from the same keys) the outputs are bit-identical.
The edge cases are those of tests/test_kernels.py.  The reference runs
under ``jax.jit`` (one compile per shape instead of one per primitive); on
the CPU backend that gives the bits of the eager reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jc
from repro.kernels.compressor import ops as jops
from repro_torch import random as tr
from repro_torch.convert import key_from_reference
from repro_torch.core import compressors as tc
from repro_torch.kernels.compressor import ops as tops
from repro_torch.kernels.compressor import ref as tref

EDGE_SHAPES = [(1,), (5,), (128,), (129,), (1000,), (33, 7), (4, 5, 6)]
N_ROWS = 3
#: shapes also held against the Pallas kernels in interpret mode
KERNEL_SHAPES = [(1,), (129,), (33, 7)]


_dither_ref = jax.jit(jax.vmap(lambda k, r, s: jc._dither(k, r, s),
                               in_axes=(0, 0, None)))
_topk_ref = jax.jit(jax.vmap(lambda r, f: jc._topk(None, r, f),
                             in_axes=(0, None)))
_spec_bits_ref = jax.jit(jc.spec_bits)
_dither_pallas = jax.jit(jax.vmap(
    lambda k, r, s: jops.fused_dither(k, r, s, interpret=True),
    in_axes=(0, 0, None)))
_topk_pallas = jax.jit(jax.vmap(
    lambda r, f: jops.fused_topk(None, r, f, interpret=True),
    in_axes=(0, None)))


def _keys(seed, n=N_ROWS):
    ks = jax.random.split(jax.random.key(seed), n)
    return ks, key_from_reference(jax.random.key_data(ks), device="cpu")


def _rows_equal(got, want):
    """Bitwise equality, NaN matching NaN (the payload may differ)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _check_dither(x, s, seed, kernel=True):
    """The port's compress (one row per message, one key per row) against
    the eager reference ``_dither`` and, with ``kernel``, the Pallas kernel
    in interpret mode (slow on the CPU, so kept to a few shapes)."""
    jkeys, tkeys = _keys(seed, x.shape[0])
    got = tc.compress(tc.dither_spec(s), tkeys, torch.as_tensor(x))
    jx = jnp.asarray(x)
    _rows_equal(got.numpy(), _dither_ref(jkeys, jx, jnp.float32(s)))
    rows = torch.as_tensor(x.reshape(x.shape[0], -1))
    _, bits = tops.fused_dither(rows, torch.zeros_like(rows), s)
    assert bits.tolist() == [float(_spec_bits_ref(jc.dither_spec(s),
                                                    rows.shape[1]))] * len(x)
    if kernel:
        kern, kbits = _dither_pallas(jkeys, jx, jnp.float32(s))
        _rows_equal(got.numpy(), kern)
        assert bits.tolist() == np.asarray(kbits).tolist()


def _check_topk(x, frac, kernel=True):
    """As :func:`_check_dither`, for top-k."""
    _, tkeys = _keys(0, x.shape[0])
    got = tc.compress(tc.topk_spec(frac), tkeys, torch.as_tensor(x))
    jx = jnp.asarray(x)
    _rows_equal(got.numpy(), _topk_ref(jx, jnp.float32(frac)))
    rows = torch.as_tensor(x.reshape(x.shape[0], -1))
    _, bits = tops.fused_topk(rows, frac)
    assert bits.tolist() == [float(_spec_bits_ref(jc.topk_spec(frac),
                                                    rows.shape[1]))] * len(x)
    if kernel:
        kern, kbits = _topk_pallas(jx, jnp.float32(frac))
        _rows_equal(got.numpy(), kern)
        assert bits.tolist() == np.asarray(kbits).tolist()


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("s", [1.0, 64.0, 127.0])
def test_dither_matches_reference(rng, shape, s):
    x = (rng.normal(size=(N_ROWS,) + shape) * 10).astype(np.float32)
    _check_dither(x, s, seed=int(np.prod(shape)),
                  kernel=s == 64.0 and shape in KERNEL_SHAPES)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_topk_matches_reference(rng, shape, frac):
    x = (rng.normal(size=(N_ROWS,) + shape) * 10).astype(np.float32)
    _check_topk(x, frac, kernel=frac == 0.1 and shape in KERNEL_SHAPES)


@pytest.mark.parametrize("d,frac", [(7, 1 / 7), (7, 2 / 7 - 1e-7), (12, 0.25),
                                    (12, 0.2500001), (128, 1.0), (129, 0.5),
                                    (200, 0.015)])
def test_topk_ties_and_rounding_edges(rng, d, frac):
    """Integer-valued rows make mass ties; frac·d sits at and around the
    ceil() boundaries: lowest-index ties and k = ⌈frac·d⌉ in float32."""
    x = rng.integers(-3, 4, size=(N_ROWS, d)).astype(np.float32)
    _check_topk(x, frac)


def test_zero_rows():
    z = np.zeros((N_ROWS, 257), np.float32)
    _check_dither(z, 63.0, seed=3)
    _check_topk(z, 0.25)


def test_nonfinite_policy():
    """Dither: one non-finite value makes the whole row NaN.  Top-k: |NaN|
    outranks inf in the search but is never emitted."""
    xi = np.asarray([[1.0, np.inf, 3.0, -2.0, 0.5, 0.0, 7.0, -np.inf]],
                    np.float32)
    xn = np.asarray([[1.0, np.nan, 3.0, -2.0]], np.float32)
    for x in (xi, xn):
        _check_dither(x, 15.0, seed=7)
        _check_topk(x, 0.5)
        out, _ = tops.fused_dither(torch.as_tensor(x),
                                   torch.full(x.shape, 0.5), 15.0)
        assert bool(torch.isnan(out).all())
    kept, _ = tops.fused_topk(torch.as_tensor(xn), 0.5)
    np.testing.assert_array_equal(kept.numpy(), [[0.0, 0.0, 3.0, 0.0]])


def test_signed_zero_kept():
    """The port's sign is jnp.sign (torch.sign maps -0 to +0)."""
    x = np.asarray([[-0.0, 0.0, -1.0, 2.0]], np.float32)
    _check_dither(x, 64.0, seed=1)
    out, _ = tops.fused_dither(torch.as_tensor(x), torch.zeros(1, 4), 64.0)
    assert np.signbit(out.numpy()[0, 0]) and not np.signbit(out.numpy()[0, 1])


@pytest.mark.parametrize("d", [1, 2, 123, 128, 129, 492, 4096, 10_000,
                               20_000])
def test_ledger_matches_spec_bits(d):
    for s in (1.0, 64.0, 1000.0):
        want = float(_spec_bits_ref(jc.make_spec(f"dither{int(s)}"), d))
        assert float(tc.spec_bits(tc.dither_spec(s), d, "cpu")) == want
        assert float(tref.dither_bits_ref(s, d, "cpu")) == want
    for frac in (0.01, 0.1, 0.37, 1.0):
        want = float(_spec_bits_ref(jc.topk_spec(frac), d))
        assert float(tc.spec_bits(tc.topk_spec(frac), d, "cpu")) == want
        assert float(tref.topk_bits_ref(frac, d, "cpu")) == want
    want = float(_spec_bits_ref(jc.make_spec("identity"), d))
    assert float(tc.spec_bits(tc.identity_spec(), d, "cpu")) == want


@pytest.mark.parametrize("name", ["identity", "dither", "dither64", "dither7",
                                  "topk", "topk0.1", "topk0.25"])
def test_make_spec_matches_reference(name):
    j, t = jc.make_spec(name), tc.make_spec(name)
    assert int(j.family) == t.family
    assert np.float32(j.s) == np.float32(t.s)
    assert np.float32(j.frac) == np.float32(t.frac)
    assert tc.make_spec(t) is t


@pytest.mark.parametrize("args,kwargs", [
    (("bogus",), {}), (("dither6.5",), {}), (("topkx",), {}),
    (("dither64",), {"s": 3}), (("topk0.1",), {"frac": 0.2}),
    (("identity",), {"s": 3}), (("dither",), {"frac": 0.5}),
    ((3,), {})])
def test_make_spec_errors_match_reference(args, kwargs):
    with pytest.raises((ValueError, TypeError)) as want:
        jc.make_spec(*args, **kwargs)
    with pytest.raises(want.type) as got:
        tc.make_spec(*args, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["natural", "count_sketch64", "minmax0.5"])
def test_families_not_ported_raise(name):
    """The three families once raised here; since they are ported the name
    builds the reference's spec: family, levels, fraction and sketch
    parameters (tests/test_torch_families.py holds what they compute)."""
    want = jc.make_spec(name)
    got = tc.make_spec(name)
    assert got.family == int(want.family)
    assert (got.s, got.frac) == (float(want.s), float(want.frac))
    assert tuple(got.params) == tuple(float(v) for v in want.params)


def test_wrappers_dispatch_on_device_only():
    """A CPU tensor takes the plain version; a tensor elsewhere is refused
    (a CUDA tensor launches the kernel: tests/test_torch_gpu.py)."""
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.fused_topk(x, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.dither_bits(64.0, 8, torch.device("meta"))
    with pytest.raises(TypeError):
        tops.fused_topk(torch.zeros((2, 8), dtype=torch.float64), 0.5)
    with pytest.raises(ValueError):
        tops.fused_dither(torch.zeros((2, 8)), torch.zeros((2, 7)), 64.0)
    with pytest.raises(ValueError):
        tops.fused_topk(torch.zeros((8, 2)).T, 0.5)
    before = dict(tops.launches)
    tops.fused_topk(torch.ones((2, 8)), 0.5)
    assert tops.launches == before          # the plain version launches none


@pytest.mark.parametrize("n,L,C", [(1, 20000, 8), (20, 20000, 4),
                                   (40, 20000, 2), (200, 20000, 1),
                                   (20, 5000, 4), (20, 492, 1),
                                   (1, 3000, 2)])
def test_topk_cluster_size_rule(n, L, C):
    """fused_topk's CTAs per row on 132 SMs: n·C <= 132 and at least
    TOPK_MIN_SHARE elements a CTA."""
    assert tops.topk_cluster(n, L, 132) == C


@pytest.mark.parametrize("frac", [0.001, 0.01, 0.5])
def test_topk_rows_the_cluster_splits(rng, frac):
    """The card's kernel splits a long row over a cluster; the plain version
    it is held to matches the reference on the rows that split hardest:
    ties straddling the share boundaries, an all-equal row, and signed
    zeros among small values."""
    L = 4096
    straddle = (rng.normal(size=L) * 1e-3).astype(np.float32)
    for c in range(1, 8):
        straddle[c * 512 - 20:c * 512 + 20] = 5.0
    straddle[rng.integers(0, L, 10)] = 9.0
    equal = np.full(L, -2.5, np.float32)
    zeros = (rng.normal(size=L) * 1e-30).astype(np.float32)
    zeros[::7] = 0.0
    zeros[::11] = -0.0
    _check_topk(np.stack([straddle, equal, zeros]), frac, kernel=False)


@pytest.mark.parametrize("frac", [0.001, 0.01, 0.5])
def test_topk_subnormal_rows_keep_ieee_order(rng, frac):
    """Subnormal magnitudes: the plain version (and the card's kernel, held
    to it bit for bit) orders them as IEEE floats and keeps exactly the k
    largest, lowest index first among ties.  The reference under XLA on
    the CPU treats subnormals as zero in its comparisons, so it keeps
    fewer of such a row (recorded in ROADMAP.md, section 3)."""
    L = 4096
    x = (rng.normal(size=(1, L)) * 1e-41).astype(np.float32)
    x[0, ::7] = 0.0
    x[0, ::11] = -0.0
    out, _ = tops.fused_topk(torch.as_tensor(x), frac)
    k = tref.topk_keep_count(frac, L)
    mag = np.abs(x[0])
    order = np.lexsort((np.arange(L), -mag))      # largest first, then index
    want = np.zeros_like(x[0])
    want[order[:k]] = x[0, order[:k]]
    _rows_equal(out.numpy()[0], want)


# ---------------------------------------------------------------------------
# The keyed dither and compress_split: a parent key, split per worker
# ---------------------------------------------------------------------------

_messages_ref = jax.jit(
    lambda spec, k, x: jax.vmap(lambda kk, r: jc.compress(spec, kk, r))(
        jax.random.split(k, x.shape[0]), x))


def _keyed_rows(rng, n, L, kind):
    """n rows of L: normal values, rows of zeros and signed zeros, or rows
    with a NaN (the whole row's output is NaN)."""
    x = (rng.normal(size=(n, L)) * 10).astype(np.float32)
    if kind == "zeros":
        x[::2] = 0.0
        x[1::2] = -0.0
        x[-1, ::3] = 5.0 if n > 1 else -0.0
    elif kind == "nan":
        x[0, L // 2] = np.nan
        x[-1, ::4] = -0.0
    return x


@pytest.mark.parametrize("n", [1, 4, 20])
@pytest.mark.parametrize("L", [1, 123, 492])
@pytest.mark.parametrize("kind", ["normal", "zeros", "nan"])
def test_keyed_dither_matches_reference_worker_messages(rng, n, L, kind):
    """The keyed dither's plain version (and the wrapper and compress_split
    on the CPU) against the reference's per-worker messages: the rows of x
    compressed with ``jax.random.split(k, n)``, bit for bit."""
    x = _keyed_rows(rng, n, L, kind)
    jkey = jax.random.key(n * 1000 + L)
    key = key_from_reference(jax.random.key_data(jkey), device="cpu")
    spec = jc.make_spec("dither64")
    want = _messages_ref(spec, jkey, jnp.asarray(x))
    got, bits = tref.fused_dither_keyed_ref(torch.as_tensor(x), key, 64.0)
    _rows_equal(got.numpy(), want)
    assert bits.tolist() == [float(_spec_bits_ref(spec, L))] * n
    _rows_equal(tops.fused_dither_keyed(torch.as_tensor(x), key, 64.0)[0]
                .numpy(), want)
    _rows_equal(tc.compress_split(tc.dither_spec(64), key,
                                  torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("name", ["dither64", "dither1", "topk0.1",
                                  "identity"])
@pytest.mark.parametrize("shape", [(1, 7), (4, 123), (20, 123, 4)])
def test_compress_split_equals_compress_with_split_keys(rng, name, shape):
    """compress_split(spec, key, x) is compress(spec, split(key, n), x)."""
    x = torch.as_tensor((rng.normal(size=shape) * 3).astype(np.float32))
    key = tr.fold_in(tr.key(17, "cpu"), shape[-1])
    spec = tc.make_spec(name)
    got = tc.compress_split(spec, key, x)
    want = tc.compress(spec, tr.split(key, shape[0]), x)
    assert got.shape == x.shape
    _rows_equal(got.numpy(), want.numpy())


def test_keyed_wrapper_checks_its_key():
    """The key must be an int64 [2] on x's device; a CPU tensor takes the
    plain version, which launches nothing."""
    x = torch.ones((3, 8))
    with pytest.raises(ValueError, match="key"):
        tops.fused_dither_keyed(x, torch.zeros(2, dtype=torch.int32), 8.0)
    with pytest.raises(ValueError, match="key"):
        tops.fused_dither_keyed(x, tr.split(tr.key(0, "cpu"), 3), 8.0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.fused_dither_keyed(x.to("meta"), tr.key(0, "cpu").to("meta"),
                                8.0)
    before = dict(tops.launches)
    tops.fused_dither_keyed(x, tr.key(0, "cpu"), 8.0)
    assert tops.launches == before


@pytest.mark.parametrize("n,L,C", [(1, 20000, 8), (20, 20000, 4),
                                   (40, 20000, 2), (200, 20000, 1),
                                   (20, 5000, 4), (20, 492, 1),
                                   (1, 492, 1), (1, 512, 2), (1, 1, 1)])
def test_dither_cluster_size_rule(n, L, C):
    """fused_dither_keyed's CTAs per row on 132 SMs: n·C <= 132 and at
    least DITHER_MIN_SHARE elements a CTA."""
    assert tops.dither_cluster(n, L, 132) == C


# ---------------------------------------------------------------------------
# The static Compressor veneer
# ---------------------------------------------------------------------------

def _veneers():
    return [(jc.identity(), tc.identity()),
            (jc.random_dithering(16), tc.random_dithering(16)),
            (jc.natural(), tc.natural()),
            (jc.top_k(0.25), tc.top_k(0.25)),
            (jc.count_sketch(8, 2, 0.5), tc.count_sketch(8, 2, 0.5)),
            (jc.min_max(0.3), tc.min_max(0.3))]


def test_static_compressors_match_reference():
    """Names, bias flags, prices (``bits``, the deprecated
    ``bits_per_value`` where it is defined), ω and the spec ``make_spec``
    takes from a Compressor, against the reference's veneer."""
    import warnings
    for jc_, tc_ in _veneers():
        assert (tc_.name, tc_.unbiased) == (jc_.name, jc_.unbiased)
        for d in (1, 24, 5000):
            assert tc_.bits(d) == jc_.bits(d)
            assert tc_.omega(d) == jc_.omega(d)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                want = jc_.bits_per_value
            except ValueError:
                with pytest.raises(ValueError, match="dimension"):
                    tc_.bits_per_value
            else:
                assert tc_.bits_per_value == want
        spec = tc.make_spec(tc_)
        assert spec.family == tc_.spec.family and spec.params is not None
    with pytest.raises(ValueError, match="keyword"):
        tc.make_spec(tc.top_k(0.5), frac=0.2)


def test_static_compress_matches_reference():
    """``Compressor.compress(key, x)`` compresses one whole message as the
    reference's does: dither, natural and top-k bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(300).astype(np.float32)
    for jc_, tc_ in _veneers()[:4]:
        want = jc_.compress(jax.random.key(3), jnp.asarray(x))
        got = tc_.compress(tr.key(3, "cpu"), torch.as_tensor(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_deprecated_aliases_warn_as_the_reference():
    """``get_compressor``, ``as_spec`` and ``spec_from_name`` warn with
    the reference's messages and return its values."""
    for call in (lambda m: m.get_compressor("topk0.5"),
                 lambda m: m.as_spec("dither8"),
                 lambda m: m.spec_from_name("natural")):
        with pytest.warns(DeprecationWarning) as jw:
            want = call(jc)
        with pytest.warns(DeprecationWarning) as tw:
            got = call(tc)
        assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
        if isinstance(got, tc.Compressor):
            assert (got.name, got.unbiased) == (want.name, want.unbiased)
            got, want = got.spec, want.spec
        assert got.family == int(np.asarray(want.family))
