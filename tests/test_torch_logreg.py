"""repro_torch.data.logreg against repro.data.logreg.

make_problem: identical arrays (the same numpy draws).  Oracles: the port
evaluates the closed-form gradient and Hessian-sketch product, the reference
differentiates the loss with jax.grad / jax.jvp; the two round differently,
so gradients and losses are held to rtol 1e-5 and Hessian-sketch products
to rtol 1e-4, atol 1e-6 (float32, sums over r = 16..64 terms in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import logreg as jl
from repro_torch.convert import problem_from_reference
from repro_torch.data import logreg as tl


@pytest.mark.parametrize("kw", [dict(d=24, n_workers=4, r=16, seed=3),
                                dict(d=123, n_workers=20, r=64, seed=0)])
def test_make_problem_identical(kw):
    j, t = jl.make_problem(**kw), tl.make_problem(device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(j.A), t.A.numpy())
    np.testing.assert_array_equal(np.asarray(j.b), t.b.numpy())
    assert j.mu == t.mu and t.A.dtype == torch.float32


@pytest.fixture(scope="module")
def pair():
    j = jl.make_problem(d=24, n_workers=4, r=16, seed=3)
    t = problem_from_reference(np.asarray(j.A), np.asarray(j.b), j.mu,
                               device="cpu")
    rng = np.random.default_rng(1)
    w = rng.normal(size=24).astype(np.float32)
    S = rng.normal(size=(24, 3)).astype(np.float32)
    return j, t, w, S


def test_oracles_match_reference(pair):
    j, t, w, S = pair
    jg, jh = j.make_oracles()
    ids = jnp.arange(j.n_workers)
    key = jax.random.key(0)
    g_ref = jax.jit(jax.vmap(lambda i: jg(jnp.asarray(w), i, key)))(ids)
    Y_ref = jax.jit(jax.vmap(lambda i: jh(jnp.asarray(w), jnp.asarray(S), i,
                                         key)))(ids)
    tg, th = t.make_oracles()
    g = tg(torch.as_tensor(w))
    Y = th(torch.as_tensor(w), torch.as_tensor(S))
    assert g.shape == (4, 24) and Y.shape == (4, 24, 3)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Y_ref), rtol=1e-4,
                               atol=1e-6)


def test_objective_and_metrics_match_reference(pair):
    j, t, w, _ = pair
    for x in (np.zeros(24, np.float32), w):
        ref = jax.jit(j.metrics)(jnp.asarray(x))
        got = t.metrics(torch.as_tensor(x))
        np.testing.assert_allclose(got["F"].item(), float(ref["F"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["grad_sq"].item(),
                                   float(ref["grad_sq"]), rtol=1e-5)
        np.testing.assert_allclose(
            t.global_grad(torch.as_tensor(x)).numpy(),
            np.asarray(jax.jit(j.global_grad)(jnp.asarray(x))),
            rtol=1e-5, atol=1e-7)


def test_entry_point_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the CPU-only refusal is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.make_problem(d=4, n_workers=2, r=2)
