"""The port's sharded engine (``driver.run_sharded_sweep`` over
``torch.distributed``) against its dense engine (``driver.run_sweep``).

The worker axis is laid over gloo process groups of 1, 2 and 8 ranks
(spawned here, a ``file://`` rendezvous in a temporary directory: no
network), 16 workers, so 2 a rank at 8 ranks: the reference's own caveat
(a rank must hold at least two workers; one worker's products round as a
lone matrix-vector product).  Each rank keeps its block of the worker
leaves, computes its workers' messages under their global ids and key
stream, rebuilds the full-federation arrays with ``all_gather`` and runs
the server math replicated.  The contract is bit for bit: every state
leaf and every trace of FLECS (FedSONIA, truncated inverse, a dithered
edge tier) and DIANA equals the dense run's on the same key.  (The
reference's own sharded test fails: XLA compiles the sharded and the dense
programs apart and reassociates their sums; the port holds its own
equality here and compares with the reference elsewhere, to a
tolerance.)
"""
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import random as tr
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.core.hierarchy import HierarchyConfig
from repro_torch.data.logreg import make_problem
from repro_torch.optim import baselines as tb

N, D, ITERS = 16, 12, 5
CASES = ("fedsonia", "truncated_inverse", "hierarchy", "diana")


def _case(name, lg, lh, group):
    """(dense step, sharded step, hparams, initial state, state specs)."""
    if name == "diana":
        cfg = tb.DianaConfig(participation=0.6)
        return (tb.make_diana_sweep_step(cfg, lg),
                tb.make_diana_sharded_sweep_step(cfg, lg, N, group),
                tb.diana_hparam_grid((1.0, 0.5)),
                tb.init_diana(torch.zeros(D), N),
                tb.diana_sharded_state_specs())
    hier = name == "hierarchy"
    cfg = tf.FlecsConfig(
        m=2, participation=0.6,
        direction=("truncated_inverse" if name == "truncated_inverse"
                   else "fedsonia"),
        tinv_floor=1e-3 if name == "truncated_inverse" else 0.0,
        hierarchy=HierarchyConfig(4, "dither64") if hier else None)
    hp = tf.hparam_grid((1.0, 0.5), (1.0,), (64.0,),
                        edge_levels=(16.0,) if hier else None)
    return (tf.make_flecs_sweep_step(cfg, lg, lh),
            tf.make_flecs_sharded_sweep_step(cfg, lg, lh, N, group), hp,
            tf.init_state(torch.zeros(D), N, n_edges=4 if hier else None),
            tf.sharded_state_specs(hierarchy=hier))


def _differing(dense, sharded):
    """Names of the state leaves and traces that are not bit for bit."""
    (ds, dt), (ss, st) = dense, sharded
    out = [name for name, a, b in zip(ds._fields, ds, ss)
           if isinstance(a, torch.Tensor) and not (
               a.shape == b.shape and torch.equal(a, b))]
    out += [f"trace {k}" for k in dt if not torch.equal(dt[k], st[k])]
    if set(dt) != set(st):
        out.append("trace keys")
    return out


def _worker(rank, world, init_method, queue):
    torch.set_num_threads(1)
    group = tdr.worker_group(world, rank, init_method)
    prob = make_problem(d=D, n_workers=N, r=8, mu=1e-3, seed=0,
                        device="cpu")
    lg, lh = prob.make_oracles()
    key = tr.key(0, "cpu")
    rec = lambda s: prob.metrics(s.w)                       # noqa: E731
    out = {}
    for name in CASES:
        dense_step, step, hp, st0, specs = _case(name, lg, lh, group)
        dense = tdr.run_sweep(dense_step, hp, st0, key, ITERS, record=rec)
        sharded = tdr.run_sharded_sweep(step, hp, st0, key, ITERS, specs,
                                        group, record=rec)
        out[name] = _differing(dense, sharded)
    queue.put((rank, out))
    torch.distributed.destroy_process_group()


def _spawn(world, directory):
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    mp.spawn(_worker, (world, f"file://{directory / 'rendezvous'}", queue),
             nprocs=world)
    results = dict(queue.get() for _ in range(world))
    return results


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return {world: _spawn(world, tmp_path_factory.mktemp(f"gloo{world}"))
            for world in (1, 2, 8)}


@pytest.mark.parametrize("world", (2, 8))
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_dense_bitwise(sharded, world, case):
    for rank, out in sharded[world].items():
        assert out[case] == [], (rank, out[case])


@pytest.mark.parametrize("case", CASES)
def test_world_size_one_group_equals_dense(sharded, case):
    assert sharded[1][0][case] == []


def test_sharded_guards_and_specs():
    prob = make_problem(d=D, n_workers=N, r=8, mu=1e-3, seed=0,
                        device="cpu")
    lg, lh = prob.make_oracles()
    group = tdr.WorkerGroup(None, 0, 3)          # 16 workers over 3 ranks
    dense_step, step, hp, st0, specs = _case("fedsonia", lg, lh, group)
    with pytest.raises(ValueError, match="does not divide"):
        tdr.run_sharded_sweep(step, hp, st0, tr.key(0, "cpu"), 1, specs,
                              group)
    assert tf.sharded_state_specs() == tf.FlecsState(
        "", tdr.WORKERS, tdr.WORKERS, "", tdr.WORKERS, "", None)
    assert tf.sharded_state_specs(hierarchy=True).edge_bits == ""
    assert tb.diana_sharded_state_specs().h == tdr.WORKERS
    ids = tdr.shard_rows(tdr.WorkerGroup(None, 3, 8), N, "cpu")
    assert ids.tolist() == [6, 7]
    with pytest.raises(ValueError, match="init_method"):
        tdr.worker_group()
