"""The natural, count-sketch and min-max compressor families of the port
against the JAX reference (``repro.core.compressors``), their prices and
variance bounds, grid specs that mix all six families, and the
``sketch_families_plan`` with its JSON rows.

Contracts.  natural: exact (abs, log2, floor, pow of two, compare), on
powers of two and one ulp either side of them too.  count_sketch: the
port sums each bucket in float64 and rounds once (so the card's atomics
and the CPU agree, tests/test_torch_gpu.py), where XLA rounds after every
term: the table within 1e-6 of its largest entry (measured <= 4.4e-7 at
L <= 5000), the decoded values within 1e-5 · max |x| (measured 4.5e-6),
and at most one coordinate in a thousand kept by one side of the
heavy-hitter top-k only (none measured).  min-max: the ℓ1 norm is summed
so too, so p can move by an ulp, a ``u < p`` decision can flip where u
lies within that ulp, and x/p can move in its last bit: values rtol 1e-5,
and at most one coordinate in a thousand kept by one package and not the
other.  Prices (``spec_bits``) and ω (``spec_omega``) are host
arithmetic: exact, for every family.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jc
from repro_torch import convert
from repro_torch.convert import key_from_reference
from repro_torch.core import compressors as tc

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: the suite runs its files in
    six parallel processes on a few cores, where eight threads a process
    spend their time waiting on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parent.parent


def _tkey(key):
    return key_from_reference(jax.random.key_data(key), device="cpu")


_rows_ref = jax.jit(jax.vmap(lambda sp, k, r: jc.compress(sp, k, r),
                             in_axes=(None, 0, 0)))
_encode_ref = jax.jit(jax.vmap(jc.count_sketch_encode, in_axes=(0, 0, None)))
# one compile a d for every family: the spec's leaves are traced
_bits_ref = jax.jit(jc.spec_bits, static_argnums=1)
_omega_ref = jax.jit(jc.spec_omega, static_argnums=1)


def _compare(name, x, kw=None, seed=4):
    """The reference's ``compress`` of each row of x (rows with keys
    ``split(key(seed), n)``) and the port's: (want, got)."""
    kw = kw or {}
    keys = jax.random.split(jax.random.key(seed), x.shape[0])
    want = np.asarray(_rows_ref(jc.make_spec(name, **kw), keys,
                                jnp.asarray(x)))
    got = tc.compress(tc.make_spec(name, **kw), _tkey(keys),
                      torch.as_tensor(x)).numpy()
    return want, got


def _powers_of_two():
    """Powers of two, one ulp below and above each, signed, with zeros."""
    p = np.float32(2.0) ** np.arange(-30, 31, 3, dtype=np.float32)
    below = np.nextafter(p, np.float32(0))
    above = np.nextafter(p, np.float32(np.inf))
    v = np.concatenate([p, below, above, -p, -below, [0.0, -0.0]])
    return v.astype(np.float32).reshape(1, -1)


@pytest.mark.parametrize("case", ["normal", "wide", "powers of two"])
def test_natural_exact(case):
    rng = np.random.default_rng(1)
    x = {"normal": rng.normal(size=(5, 123)),
         "wide": rng.normal(size=(3, 300)) * 10.0 ** rng.integers(
             -20, 20, size=(3, 300)),
         "powers of two": np.repeat(_powers_of_two(), 3, axis=0)}[case]
    want, got = _compare("natural", x.astype(np.float32))
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("name,kw", [
    ("count_sketch64", {}), ("count_sketch16", {"depth": 5}),
    ("count_sketch", {"width": 40, "depth": 4, "hh_frac": 0.25}),
    ("count_sketch8", {"depth": 1}), ("count_sketch64", {"depth": 7}),
    ("count_sketch500", {"hh_frac": 0.25})])
def test_count_sketch_matches_reference(name, kw):
    x = np.random.default_rng(2).normal(size=(4, 1000)).astype(np.float32)
    want, got = _compare(name, x, kw)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(x).max()
    assert np.count_nonzero((got != 0) != (want != 0)) <= x.size // 1000
    k = np.count_nonzero(got, axis=1)
    frac = kw.get("hh_frac", 1.0)
    assert (k <= int(np.ceil(np.float32(frac) * 1000))).all()
    keys = jax.random.split(jax.random.key(4), 4)
    params = jc.make_spec(name, **kw).params
    table = np.asarray(_encode_ref(keys, jnp.asarray(x), params))
    got_table = tc.count_sketch_encode(
        _tkey(keys), torch.as_tensor(x),
        torch.full((4,), float(params.width))).numpy()
    assert np.abs(got_table - table).max() <= 1e-6 * np.abs(table).max()


def test_count_sketch_encode_is_linear():
    """sketch(x + y) == sketch(x) + sketch(y) for one key, to f32
    reassociation (the property the reference's hierarchy relies on)."""
    rng = np.random.default_rng(3)
    x, y = (torch.as_tensor(rng.normal(size=(2, 300)).astype(np.float32))
            for _ in range(2))
    keys = _tkey(jax.random.split(jax.random.key(1), 2))
    width = torch.full((2,), 32.0)
    enc = lambda v: tc.count_sketch_encode(keys, v, width)     # noqa: E731
    np.testing.assert_allclose(enc(x + y).numpy(),
                               (enc(x) + enc(y)).numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (enc(x)[:, :, 32:] == 0).all()


@pytest.mark.parametrize("name", ["minmax0.5", "minmax0.1", "minmax0.9"])
def test_minmax_within_its_contract(name):
    x = np.random.default_rng(5).normal(size=(8, 1000)).astype(np.float32)
    x[0, :500] = 0.0
    want, got = _compare(name, x)
    flips = np.count_nonzero((want != 0) != (got != 0))
    assert flips <= x.size // 1000, flips
    both = (want != 0) & (got != 0)
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5)
    assert (got[0, :500] == 0).all()


def test_minmax_is_unbiased_on_average():
    """E Q(x) = x: the mean over 2000 draws of one row."""
    x = np.random.default_rng(6).normal(size=(1, 50)).astype(np.float32)
    keys = tc.random.split(tc.random.key(3, "cpu"), 2000)
    rows = torch.as_tensor(np.repeat(x, 2000, axis=0))
    mean = tc.compress(tc.make_spec("minmax0.2"), keys, rows).mean(0)
    np.testing.assert_allclose(mean.numpy(), x[0], atol=0.25)


FAMILIES = ["identity", "dither64", "dither3", "natural", "topk0.1",
            "topk0.25", "count_sketch64", "count_sketch7", "minmax0.5",
            "minmax0.05"]


@pytest.mark.parametrize("d", [1, 123, 5000, 20000])
def test_bits_and_omega_exact_for_every_family(d):
    for name in FAMILIES:
        js, ts = jc.make_spec(name), tc.make_spec(name)
        assert float(tc.spec_bits(ts, d, "cpu")) == float(_bits_ref(js, d))
        assert float(tc.spec_omega(ts, d)) == float(_omega_ref(js, d))
        assert tc.spec_commutes_with_sum(ts) == bool(
            jc.spec_commutes_with_sum(js))
    js = jc.stack_specs(*FAMILIES)
    ts = tc.stack_specs(*FAMILIES)
    want_bits = np.asarray(jax.vmap(lambda sp: _bits_ref(sp, d))(js))
    np.testing.assert_array_equal(tc.spec_bits_many(ts, d).numpy(),
                                  want_bits)
    np.testing.assert_array_equal(tc.spec_bits_host(ts, d), want_bits)
    np.testing.assert_array_equal(
        tc.spec_omega(ts, d).numpy(),
        np.asarray(jax.vmap(lambda sp: _omega_ref(sp, d))(js)))


def test_mixed_grid_compress_split_and_conversion():
    """A grid of all six families (two count sketches of other widths and
    depths) through ``compress_split``: every point the reference's
    vmapped ``compress`` with ``split(keys[g], n)`` (min-max to its
    contract); the reference's grid spec converts to the port's."""
    names = ["dither64", "topk0.25", "count_sketch64", "minmax0.5",
             "natural", "identity", "count_sketch16", "topk0.5"]
    kws = [{}] * 6 + [{"depth": 5, "hh_frac": 0.25}, {}]
    js = jc.stack_specs(*[jc.make_spec(n, **k) for n, k in zip(names, kws)])
    ts = tc.stack_specs(*[tc.make_spec(n, **k) for n, k in zip(names, kws)])
    conv = convert.spec_from_reference(jax.tree.map(np.asarray, js), "cpu")
    assert conv.family == ts.family
    for a, b in zip(conv.params_host, ts.params_host):
        np.testing.assert_array_equal(a, b)
    G, n = len(names), 3
    x = np.random.default_rng(7).normal(size=(G, n, 40)).astype(np.float32)
    keys = jax.random.split(jax.random.key(8), G)

    def point(sp, k, xs):
        return jax.vmap(lambda kk, r: jc.compress(sp, kk, r))(
            jax.random.split(k, n), xs)

    want = np.asarray(jax.jit(jax.vmap(point))(js, keys, jnp.asarray(x)))
    got = tc.compress_split(ts, _tkey(keys), torch.as_tensor(x)).numpy()
    for g, name in enumerate(names):
        if name.startswith("minmax"):
            np.testing.assert_allclose(got[g], want[g], rtol=1e-5)
        elif name.startswith("count_sketch"):
            assert (np.abs(got[g] - want[g]).max()
                    <= 1e-5 * np.abs(x[g]).max())
        else:
            np.testing.assert_array_equal(got[g], want[g])


@pytest.mark.parametrize("args,kwargs", [
    (("count_sketchx",), {}), (("minmaxy",), {}),
    (("count_sketch64",), {"width": 3}), (("minmax0.1",), {"frac": 0.2}),
    (("natural",), {"s": 3}), (("count_sketch",), {"s": 2}),
    (("minmax",), {"width": 8})])
def test_make_spec_errors_match_reference(args, kwargs):
    with pytest.raises((ValueError, TypeError)) as want:
        jc.make_spec(*args, **kwargs)
    with pytest.raises(want.type) as got:
        tc.make_spec(*args, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args,kwargs", [
    (("count_sketch",), {"width": 128, "depth": 5, "hh_frac": 0.5}),
    (("count_sketch32",), {"depth": 2}), (("minmax",), {}),
    (("minmax",), {"frac": 0.3}), (("natural",), {})])
def test_make_spec_names_match_reference(args, kwargs):
    want = jc.make_spec(*args, **kwargs)
    got = tc.make_spec(*args, **kwargs)
    assert got.family == int(want.family)
    assert (got.s, got.frac) == (float(want.s), float(want.frac))
    assert tuple(got.params) == tuple(float(v) for v in want.params)


SIZE = dict(d=16, n_workers=4, r=16, mu=1e-3, seed=0)
ITERS = 6


@pytest.fixture(scope="module")
def plans():
    from benchmarks import paper_experiments as pe
    from repro.core import api as japi
    from repro.data import logreg as jl
    from repro_torch import experiments as ex
    from repro_torch.core import api as tapi
    from repro_torch.data import logreg as tl
    jp, tp = jl.make_problem(**SIZE), tl.make_problem(**SIZE, device="cpu")
    return (jp, japi.run_plan(pe.sketch_families_plan(jp, ITERS)),
            tp, tapi.run_plan(ex.sketch_families_plan(tp, ITERS)))


def test_sketch_families_plan_matches_reference(plans):
    _, want, _, got = plans
    assert got.labels == want.labels == ("families",)
    (jst, jtr), (tst, ttr) = want["families"], got["families"]
    for key in ("bits_per_node", "n_active"):
        np.testing.assert_array_equal(ttr[key].numpy(), np.asarray(jtr[key]))
    np.testing.assert_allclose(ttr["F"].numpy(), np.asarray(jtr["F"]),
                               rtol=5e-4)
    np.testing.assert_allclose(ttr["grad_sq"].numpy(),
                               np.asarray(jtr["grad_sq"]), rtol=1e-2)
    assert got.hparams["families"].grad_spec.family == (1, 3, 4, 5)


def test_sketch_families_rows_match_golden(plans):
    """The rows against ``sketch_families.json``: round_bits and omega
    exact; the tolerant keys drift from the golden only where the JAX
    reference run here does, and there the port holds to the reference
    (tests/test_torch_api.py's contract)."""
    import importlib.util
    from repro.core.flecs import FlecsConfig, hparams_round_bits
    from repro_torch import experiments as ex
    spec = importlib.util.spec_from_file_location(
        "check_bench_drift", ROOT / "scripts" / "check_bench_drift.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    jp, want, tp, got = plans
    name = "sketch_families.json"
    golden = json.loads((ROOT / "benchmarks/out/golden" / name).read_text())
    # the reference's rows (benchmarks/paper_experiments.sketch_families)
    # from the plan result already run
    hp = want.hparams["families"]
    st, tr = want["families"]
    price = hparams_round_bits(FlecsConfig(m=2), hp, jp.d)
    omg = jax.vmap(lambda sp: jc.spec_omega(sp, jp.d))(hp.grad_spec)
    reference = json.loads(json.dumps([
        {"family": fam, "round_bits": float(price[g]),
         "omega": float(omg[g]), "F": float(tr["F"][g, -1]),
         "grad_sq": float(tr["grad_sq"][g, -1]),
         "Mbits_mean": float(jnp.mean(st.bits_per_node[g])) / 1e6}
        for g, fam in enumerate(ex.SKETCH_FAMILY_NAMES)]))
    port = json.loads(json.dumps(ex.sketch_families_rows(got, tp.d)))
    for row, want in zip(port, golden):
        assert (row["family"], row["round_bits"], row["omega"]) == (
            want["family"], want["round_bits"], want["omega"])

    def drift(rows, rtol=5e-2):
        errors = []
        check._compare(name, "", golden, rows, rtol, 1e-8, errors)
        return {e.split(":")[0] for e in errors}

    assert drift(port) <= drift(reference)
    errors = []
    check._compare(name, "", reference, port, 1e-2, 1e-8, errors)
    assert not errors, errors
