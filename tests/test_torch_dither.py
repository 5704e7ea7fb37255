"""repro_torch's int8 dither codec (kernels/dither) and the trainer's wire
format (core/compressors.shared_scale_levels) against the JAX package, on
the CPU.

Tolerance: none against the reference's plain versions.  Given the same
uniforms, the levels, the scales and the decoded values are bit-identical
to the reference's: the same IEEE operations in the same order, and the
float -> int8 conversion written out as XLA's (NaN -> 0, saturating), which
``torch``'s wrapping ``.to(torch.int8)`` is not.  Against the Pallas
kernels in interpret mode the levels are bit-identical too, but the scales
are held to rtol 1e-6, the reference's own kernel test's: compiled with
jit, XLA turns the kernel's ``norm / s`` into ``norm * (1 / s)``, one ulp
from the division now and then.  The
card's kernels are held to the same plain versions in tests/test_torch_gpu.py
and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as ref_compressors
from repro.kernels.dither.dither import dither_decode as pallas_decode
from repro.kernels.dither.dither import dither_encode as pallas_encode
from repro.kernels.dither.ops import dequantize as ref_dequantize
from repro.kernels.dither.ops import quantize as ref_quantize
from repro.kernels.dither.ref import dither_decode_ref, dither_encode_ref
from repro_torch import convert, random
from repro_torch.core import compressors
from repro_torch.kernels.dither import ops, ref

# the shapes of tests/test_kernels.py's dither test: R, C, block_rows, s
SHAPES = [(16, 128, 8, 127), (32, 256, 8, 63), (8, 512, 4, 15),
          (64, 128, 16, 127)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _same(got, want):
    """Equal element for element (NaN matching NaN), dtype and shape too."""
    want = np.asarray(want)
    got = got.numpy() if got.dtype != torch.bfloat16 else got.float().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _inputs(R, C, seed):
    g = np.random.default_rng(seed)
    return ((g.normal(size=(R, C)) * 10).astype(np.float32),
            g.random((R, C), dtype=np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R,C,br,s", SHAPES)
def test_encode_decode_bit_identical(R, C, br, s, dtype):
    jdtype, tdtype = DTYPES[dtype]
    x, u = _inputs(R, C, R + C)
    lv, sc = ops.dither_encode(torch.as_tensor(x).to(tdtype),
                               torch.as_tensor(u), s=s, block_rows=br)
    want_lv, want_sc = dither_encode_ref(jnp.asarray(x, jdtype),
                                         jnp.asarray(u), s, br)
    _same(lv, want_lv)
    _same(sc, want_sc)
    k_lv, k_sc = pallas_encode(jnp.asarray(x, jdtype), jnp.asarray(u), s=s,
                               block_rows=br, interpret=True)
    _same(lv, k_lv)
    np.testing.assert_allclose(sc.numpy(), np.asarray(k_sc), rtol=1e-6)
    out = ops.dither_decode(lv, sc, block_rows=br)
    _same(out, dither_decode_ref(want_lv, want_sc, br))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(pallas_decode(k_lv, k_sc, block_rows=br,
                                              interpret=True)), rtol=1e-6)


def test_int8_conversion_is_xlas():
    v = np.array([np.nan, 300.0, -300.0, 127.0, -128.0, np.inf, -np.inf,
                  3.0, -0.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int8))
    np.testing.assert_array_equal(ref.to_int8(torch.as_tensor(v)).numpy(),
                                  want)
    assert want[1] == 127 and want[2] == -128 and want[0] == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [15, 127, 255])
def test_edge_blocks_bit_identical(s, dtype):
    """Zero, -0, ±inf and NaN blocks, and s = 255: levels past 127
    saturate as XLA's conversion saturates."""
    jdtype, tdtype = DTYPES[dtype]
    inf, nan = np.inf, np.nan
    x = np.array([[0.0] * 4, [-0.0] * 4,
                  [1.0, inf, 3.0, -2.0], [0.5, -inf, 0.0, 7.0],
                  [1.0, nan, 3.0, -2.0], [-0.0, 0.5, 2.0, 1.0],
                  [4.0, -4.0, 3.9, -3.9], [1e-3, 2e-3, -4.0, 0.25]],
                 np.float32)
    u = np.random.default_rng(3).random(x.shape, dtype=np.float32)
    lv, sc = ops.dither_encode(torch.as_tensor(x).to(tdtype),
                               torch.as_tensor(u), s=s, block_rows=2)
    want_lv, want_sc = dither_encode_ref(jnp.asarray(x, jdtype),
                                         jnp.asarray(u), s, 2)
    _same(lv, want_lv)
    _same(sc, want_sc)
    _same(ops.dither_decode(lv, sc, block_rows=2),
          dither_decode_ref(want_lv, want_sc, 2))
    if s == 255:
        assert int(lv.max()) == 127 and int(lv.min()) == -128


# keyed encode: R, C, block_rows, s (C not a multiple of 4 takes the
# kernel's scalar path on the card; the Pallas kernel needs C % 128 == 0)
KEYED_SHAPES = SHAPES + [(300, 1000, 300, 127), (24, 77, 3, 255),
                         (6, 5, 6, 2047)]


def _port_key(key):
    return convert.key_from_reference(jax.random.key_data(key), "cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("R,C,br,s", KEYED_SHAPES)
def test_encode_keyed_bit_identical(R, C, br, s, dtype):
    """dither_encode_keyed draws uniform(key, x.shape) itself: the
    reference's plain encode on jax.random.uniform(key, shape), bit for
    bit; the Pallas kernel (interpret mode) on the same uniforms: levels
    bit for bit, scales within its rtol 1e-6."""
    jdtype, tdtype = DTYPES[dtype]
    x = _inputs(R, C, R * C)[0]
    key = jax.random.fold_in(jax.random.key(R + C), s)
    lv, sc = ops.dither_encode_keyed(torch.as_tensor(x).to(tdtype),
                                     _port_key(key), s=s, block_rows=br)
    u = jax.random.uniform(key, (R, C), jnp.float32)
    want_lv, want_sc = dither_encode_ref(jnp.asarray(x, jdtype), u, s, br)
    _same(lv, want_lv)
    _same(sc, want_sc)
    if C % 128 == 0:
        k_lv, k_sc = pallas_encode(jnp.asarray(x, jdtype), u, s=s,
                                   block_rows=br, interpret=True)
        _same(lv, k_lv)
        np.testing.assert_allclose(sc.numpy(), np.asarray(k_sc), rtol=1e-6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [15, 127, 255])
def test_encode_keyed_edge_blocks_bit_identical(s, dtype):
    """Zero, -0, ±inf and NaN blocks, and s > 127, through the keyed
    entry, against the reference's plain encode on jax's uniforms."""
    jdtype, tdtype = DTYPES[dtype]
    inf, nan = np.inf, np.nan
    x = np.array([[0.0] * 4, [-0.0] * 4,
                  [1.0, inf, 3.0, -2.0], [0.5, -inf, 0.0, 7.0],
                  [1.0, nan, 3.0, -2.0], [-0.0, 0.5, 2.0, 1.0],
                  [4.0, -4.0, 3.9, -3.9], [1e-3, 2e-3, -4.0, 0.25]],
                 np.float32)
    key = jax.random.key(s)
    lv, sc = ops.dither_encode_keyed(torch.as_tensor(x).to(tdtype),
                                     _port_key(key), s=s, block_rows=2)
    want_lv, want_sc = dither_encode_ref(
        jnp.asarray(x, jdtype), jax.random.uniform(key, x.shape), s, 2)
    _same(lv, want_lv)
    _same(sc, want_sc)
    if s == 255:
        assert int(lv.max()) == 127 and int(lv.min()) == -128


@pytest.mark.parametrize("shape", [(1000,), (33, 77), (4, 5, 6), (128, 512)])
def test_quantize_bit_identical(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    key = jax.random.key(1)
    lv, sc, meta = ops.quantize(
        convert.key_from_reference(jax.random.key_data(key), "cpu"),
        torch.as_tensor(x), s=63)
    want_lv, want_sc, want_meta = ref_quantize(key, jnp.asarray(x), s=63,
                                               interpret=True)
    _same(lv, want_lv)
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=1e-6)
    assert meta == (tuple(want_meta[0]), want_meta[1], want_meta[2])
    out = ops.dequantize(lv, sc, meta)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_dequantize(want_lv, want_sc, want_meta,
                                               interpret=True)), rtol=1e-6)
    assert out.shape == shape
    # the plain reference on quantize's own layout and draw: bit for bit
    rows, rb = lv.shape[0], meta[2]
    x2 = jnp.pad(jnp.asarray(x).reshape(-1),
                 (0, rows * 512 - x.size)).reshape(rows, 512)
    u = jax.random.uniform(key, x2.shape, jnp.float32)
    plain_lv, plain_sc = dither_encode_ref(x2, u, 63, rb)
    _same(lv, plain_lv)
    _same(sc, plain_sc)
    _same(out, dither_decode_ref(plain_lv, plain_sc, rb).reshape(-1)[
        :x.size].reshape(shape))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.ones((8, 16))
    with pytest.raises(ValueError, match="multiple"):
        ops.dither_encode(x, torch.zeros_like(x), block_rows=3)
    with pytest.raises(TypeError):
        ops.dither_encode(x.double(), torch.zeros_like(x), block_rows=8)
    with pytest.raises(TypeError):
        ops.dither_encode(x, torch.zeros_like(x).bfloat16(), block_rows=8)
    with pytest.raises(ValueError):
        ops.dither_encode(x.T, torch.zeros_like(x.T), block_rows=1)
    lv, sc = ops.dither_encode(x, torch.zeros_like(x), block_rows=8)
    with pytest.raises(ValueError, match="scale"):
        ops.dither_decode(lv, torch.ones(2), block_rows=8)
    key = random.key(0, "cpu")
    with pytest.raises(ValueError, match="key"):
        ops.dither_encode_keyed(x, key.int(), block_rows=8)
    with pytest.raises(ValueError, match="key"):
        ops.dither_encode_keyed(x, key[None], block_rows=8)
    with pytest.raises(TypeError):
        ops.dither_encode_keyed(x.double(), key, block_rows=8)
    with pytest.raises(ValueError, match="multiple"):
        ops.dither_encode_keyed(x, key, block_rows=3)
    ops.reset_launches()
    ops.dither_decode(lv, sc, block_rows=8)
    ops.dither_encode_keyed(x, key, block_rows=8)
    assert ops.launches == {"dither_encode": 0, "dither_encode_keyed": 0,
                            "dither_absmax": 0, "dither_levels_keyed": 0,
                            "dither_decode": 0}


@pytest.mark.parametrize("s", [1, 15, 127, 255, 4000])
@pytest.mark.parametrize("n", [1, 2, 8, 4096])
def test_psum_level_cap(s, n):
    want = float(ref_compressors.psum_level_cap(s, n))
    assert compressors.psum_level_cap(s, n) == want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,s", [((2, 64, 96), 127), ((512,), 127),
                                     ((16, 40), 15), ((3, 7, 11), 255),
                                     ((40, 8), 2047)])
def test_shared_scale_levels_bit_identical(shape, s, dtype):
    """One worker: the reference's pmax over a mapped axis of size 1 (under
    ``jax.vmap(..., axis_name="w")``) against the port's single block."""
    jdtype, tdtype = DTYPES[dtype]
    x = (np.random.default_rng(5).normal(size=shape) * 3).astype(np.float32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(29), 4), 7)
    s_cap = ref_compressors.psum_level_cap(s, 1)

    def one_worker(xw):
        return ref_compressors.shared_scale_levels(key, xw, s_cap, "w")

    want_lv, want_sc = jax.vmap(one_worker, axis_name="w")(
        jnp.asarray(x, jdtype)[None])
    lv, sc = compressors.shared_scale_levels(
        convert.key_from_reference(jax.random.key_data(key), "cpu"),
        torch.as_tensor(x).to(tdtype), compressors.psum_level_cap(s, 1))
    _same(lv, want_lv[0])
    _same(sc, want_sc[0])
    _same(compressors.decode_int8(lv, sc),
          ref_compressors.decode_int8(want_lv[0], want_sc[0]))
