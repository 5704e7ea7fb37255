"""repro_torch.random against jax.random: bit for bit (the key streams are
integer arithmetic, so no tolerance applies)."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import random as tr

SEEDS = [0, 5, 42, 2**31 - 1, 2**32 - 1]
SHAPES = [(), (5,), (3, 7), (123, 4)]


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k, t = jax.random.key(seed), tr.key(seed, device="cpu")
    np.testing.assert_array_equal(_data(k), t.numpy())
    np.testing.assert_array_equal(_data(jax.random.split(k, 7)),
                                  tr.split(t, 7).numpy())
    np.testing.assert_array_equal(_data(jax.random.split(k)),
                                  tr.split(t).numpy())
    for d in (0, 1, 17, 2**31 + 5):
        np.testing.assert_array_equal(_data(jax.random.fold_in(k, d)),
                                      tr.fold_in(t, d).numpy())


@pytest.mark.parametrize("seed", SEEDS[::2])
@pytest.mark.parametrize("shape", SHAPES)
def test_draws(seed, shape):
    k, t = jax.random.key(seed), tr.key(seed, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(k, shape)).astype(np.int64),
        tr.bits(t, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(k, shape)).view(np.int32),
        tr.uniform(t, shape).numpy().view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(k, 0.3, shape)),
        tr.bernoulli(t, 0.3, shape).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.rademacher(k, shape, np.float32)),
        tr.rademacher(t, shape).numpy())


def test_batched_keys_match_vmapped_draws():
    """One key per row, as the compressors draw their uniforms."""
    ks = jax.random.split(jax.random.key(3), 6)
    ref = jax.vmap(lambda kk: jax.random.uniform(kk, (9, 2)))(ks)
    got = tr.uniform(torch.as_tensor(_data(ks)), (9, 2))
    assert got.shape == (6, 9, 2)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    folded = jax.vmap(lambda kk: jax.random.fold_in(kk, 11))(ks)
    np.testing.assert_array_equal(
        _data(folded), tr.fold_in(torch.as_tensor(_data(ks)), 11).numpy())


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        tr.key(-1, device="cpu")
    with pytest.raises(ValueError):
        tr.key(2**32, device="cpu")


@pytest.mark.parametrize("seed", SEEDS[::2])
@pytest.mark.parametrize("shape", SHAPES + [(20000,)])
def test_normal(seed, shape):
    """``normal`` draws the reference's uniforms bit for bit; its erfinv is
    XLA's float32 polynomial with torch's log1p, so it is held to within a
    few ulps (rtol 1e-6, atol 1e-7), not bit for bit."""
    k, t = jax.random.key(seed), tr.key(seed, device="cpu")
    want = np.asarray(jax.random.normal(k, shape))
    got = tr.normal(t, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 4


def test_normal_batched_keys():
    ks = jax.random.split(jax.random.key(11), 5)
    want = jax.vmap(lambda kk: jax.random.normal(kk, (3, 4)))(ks)
    got = tr.normal(torch.as_tensor(_data(ks)), (3, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
