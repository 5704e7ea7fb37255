"""repro_torch.core sketch / directions / updates / driver against the JAX
reference on identical inputs.

Sketch and participation masks come from the key streams: exact.
Directions and updates go through QR, eigh and pinv (LAPACK on both sides,
but other call sequences and summation orders): rtol 1e-4, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import directions as jd
from repro.core import driver as jdr
from repro.core.sketch import sketch as jax_sketch
from repro.core import updates as ju
from repro_torch.convert import key_from_reference
from repro_torch.core import directions as td
from repro_torch.core import driver as tdr
from repro_torch.core import sketch as ts
from repro_torch.core import updates as tu

TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("d,m", [(24, 2), (123, 4)])
@pytest.mark.parametrize("k", [0, 1, 200])
def test_rademacher_sketch_exact(d, m, k):
    np.testing.assert_array_equal(
        np.asarray(jax_sketch("rademacher", d, m, jnp.int32(k))),
        ts.sketch("rademacher", d, m, k, torch.device("cpu")).numpy())


@pytest.mark.parametrize("kind", ["gaussian", "coordinate"])
def test_other_sketches_not_ported(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.sketch(kind, 8, 2, 0, torch.device("cpu"))


def _curvature(rng, d=16, m=3, n=None):
    """A sketched PSD Hessian: Y = H S and M = Sᵀ H S."""
    lead = () if n is None else (n,)
    A = rng.normal(size=lead + (d, d)).astype(np.float32)
    H = A @ np.swapaxes(A, -1, -2) / d + 0.1 * np.eye(d, dtype=np.float32)
    S = (rng.choice([-1.0, 1.0], size=(d, m)) / np.sqrt(m)).astype(
        np.float32)
    Y = (H @ S).astype(np.float32)
    M = (S.T @ Y).astype(np.float32)
    return H.astype(np.float32), S, Y, M


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_truncate_eigs_exact():
    lam = np.asarray([-3.0, -1e-6, 0.0, 1e-6, 2.0, 1e9], np.float32)
    np.testing.assert_array_equal(
        td.truncate_eigs(_t(lam), 1e-5, 1e8).numpy(),
        np.asarray(jd.truncate_eigs(jnp.asarray(lam), 1e-5, 1e8)))


def test_directions_match_reference(rng):
    H, S, Y, M = _curvature(rng)
    g = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        td.fedsonia_direction(_t(Y), _t(M), _t(g), 1e-5, 1e8, 1e-8).numpy(),
        np.asarray(jd.fedsonia_direction(Y, M, g, 1e-5, 1e8, 1e-8)), **TOL)
    np.testing.assert_allclose(
        td.truncated_inverse_direction(_t(H), _t(g), 1e-5, 1e8).numpy(),
        np.asarray(jd.truncated_inverse_direction(H, g, 1e-5, 1e8)), **TOL)
    np.testing.assert_allclose(
        td.truncated_inverse_direction_floored(
            _t(H), _t(g), 1e-5, 1e8, 0.2).numpy(),
        np.asarray(jd.truncated_inverse_direction_floored(
            H, g, 1e-5, 1e8, 0.2)), **TOL)


def test_updates_batched_match_reference(rng):
    n = 3
    H, S, Y, M = _curvature(rng, n=n)
    B = (0.5 * H + 0.1 * rng.normal(size=H.shape)).astype(np.float32)
    B = 0.5 * (B + np.swapaxes(B, -1, -2))
    for beta in (1.0, 0.3):
        want = jax.vmap(lambda b, y, m_: ju.direct_update(b, y, m_, beta))(
            B, Y, M)
        got = tu.direct_update(_t(B), _t(Y), _t(M), beta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_B, want_G = jax.vmap(lambda b, y, m_: ju.truncated_lsr1_update(
        b, y, m_, S, 1e-5))(B, Y, M)
    got_B, got_G = tu.truncated_lsr1_update(_t(B), _t(Y), _t(M), _t(S), 1e-5)
    np.testing.assert_allclose(got_G.numpy(), np.asarray(want_G), **TOL)
    np.testing.assert_allclose(got_B.numpy(), np.asarray(want_B), **TOL)


def test_linalg_propagates_nan_like_reference(rng):
    """jnp.linalg returns NaN for a non-finite matrix where torch.linalg
    raises; the port's wrappers return NaN for that batch element and the
    torch.linalg result for the others."""
    from repro_torch.core import linalg as tla
    M = rng.normal(size=(3, 4, 4)).astype(np.float32)
    M[1, 2, 0] = np.nan
    P = tla.pinv(_t(M), rtol=1e-10).numpy()
    assert np.isnan(P[1]).all() and np.isfinite(P[[0, 2]]).all()
    np.testing.assert_array_equal(
        P[[0, 2]], torch.linalg.pinv(_t(M[[0, 2]]), rtol=1e-10).numpy())
    assert np.isnan(np.asarray(jnp.linalg.pinv(M[1], rcond=1e-10))).all()
    A = M + np.swapaxes(M, -1, -2)
    lam, V = tla.eigh(_t(A))
    assert torch.isnan(lam[1]).all() and torch.isnan(V[1]).all()
    want_lam, _ = torch.linalg.eigh(_t(A[[0, 2]]))
    np.testing.assert_array_equal(lam[[0, 2]].numpy(), want_lam.numpy())
    assert np.isnan(np.asarray(jnp.linalg.eigh(A[1])[0])).all()


@pytest.mark.parametrize("p", [1.0, 0.5, 0.25])
def test_participation_mask_exact(p):
    key = jax.random.key(11)
    want = jdr.participation_mask(key, 20, p, "bernoulli")
    got = tdr.participation_mask(
        key_from_reference(jax.random.key_data(key), device="cpu"), 20, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_participation_guards():
    key = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="> 0"):
        tdr.participation_mask(key, 4, 0.0)
    with pytest.raises(ValueError, match="degenerate"):
        tdr.participation_mask(key, 4, 0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdr.participation_mask(key, 4, 0.5, "choice")


def test_masked_mean_matches_reference(rng):
    x = rng.normal(size=(5, 3, 2)).astype(np.float32)
    for mask in ([1, 0, 1, 1, 0], [0, 0, 0, 0, 0]):
        mk = np.asarray(mask, np.float32)
        np.testing.assert_array_equal(
            tdr.masked_mean(_t(x), _t(mk)).numpy(),
            np.asarray(jdr.masked_mean(jnp.asarray(x), jnp.asarray(mk))))


def test_run_experiment_key_stream_and_thinning():
    """Round t gets split(key, iters)[t]; traces keep rows E-1, 2E-1, ..."""
    seen = []

    def step(state, k):
        seen.append(k.clone())
        return state + 1, {"t": torch.tensor(float(state))}

    key = torch.as_tensor(np.asarray(jax.random.key_data(jax.random.key(4)),
                                     np.int64))
    state, tr = tdr.run_experiment(step, 0, key, 6, record_every=3,
                                   record=lambda st: {"st": torch.tensor(st)})
    assert state == 6
    np.testing.assert_array_equal(tr["t"].numpy(), [2.0, 5.0])
    np.testing.assert_array_equal(tr["st"].numpy(), [3, 6])
    np.testing.assert_array_equal(
        torch.stack(seen).numpy(),
        np.asarray(jax.random.key_data(jax.random.split(jax.random.key(4),
                                                        6))))
    with pytest.raises(ValueError):
        tdr.run_experiment(step, 0, key, 5, record_every=3)
