"""Synchronous experiment driver and sweep engine (counterpart of
``repro.core.driver``).

Every experiment drives a step of the uniform shape

    step(state, key) -> (state, aux)

The reference scans the step in one compiled ``lax.scan`` program; here
:func:`run_experiment` is a Python loop over the same key stream,
``split(key, iters)``.  Per-round traces stay on the device and are stacked
at the end, so the loop never waits for the device between rounds.

Async.  The FedBuff-style buffered engine's primitives are here too:
:class:`StalenessSchedule` and :func:`sample_delays` (per-worker delays,
``tau`` an int or an int [G] tensor), :class:`MessageBuffer` (the in-flight
store, slots ``[G, S, n, ...]`` in a batched state, ``[S, n, ...]`` in an
unbatched one: the grid axis leads, as on every other state leaf),
:func:`buffer_send` / :func:`buffer_receive` / :func:`buffer_busy`,
:func:`fedbuff_accumulate`, :func:`applied_staleness`, :func:`damped_alpha`
and :func:`run_async_sweep`.  The async states also carry ``t``, the round
on the host: every live grid point is at that round, so it files and
drains the buffer's slots for the whole grid without a device read.

Sweeps.  The reference ``jax.vmap``s a sweep step over a [G] grid of
hparams.  Here a grid is a leading [G] dimension of the state, the hparams
and the round's keys, and one round steps every point at once
(``sweep_step(hp, state, keys [G, 2])``): G points cost about what one
costs on a host-bound card, where a loop over points would cost G times as
much.  :func:`run_sweep` / :func:`sweep_program` run such a step with the
reference's per-point key streams (:func:`sweep_keys`), so row g of a sweep
is the standalone run on ``split(key, G)[g]``.

A batched state has the unbatched state's fields with a leading [G] axis on
every tensor; its ``k`` is an int32 [G] tensor (or None where the caller
counts rounds on the host: :func:`specialize`), and a ``FlecsState``'s
``t`` is the round every live point has reached (a host int, which seeds
the sketch).  Hparams carrying a ``bit_budget`` run in the budget-freeze
mode (:func:`freeze_on_bit_budget`): a ``torch.where`` over every state
leaf with a [G] mask, on the device, no value read back in a round.

Population scale.  :func:`cohort_indices` draws a stratified cohort of K
clients of an N-client population (``COHORT_SALT``), and the masks take a
``cohort=`` axis; a cohort step updates its [G, N] tables in place
(``step.in_place``), so :func:`sweep_program` and :func:`run_experiment`
hand it a copy of the caller's state once.  :func:`run_sharded_sweep`
lays the worker axis over a ``torch.distributed`` process group
(:func:`worker_group`; gloo on the CPU, NCCL on the card), every rank
running the same program on its block (:func:`gather_workers`,
:func:`sum_workers`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.compressors import (CompressorSpec, as_grid, is_grid,
                                          spec_to, tile_spec)


def bits_dtype():
    """Accumulator dtype of the bit ledgers: float32, the reference's
    default (exact for integer counts below 2**24)."""
    return torch.float32


def participation_mask(key: torch.Tensor, n: int, p: float = 1.0,
                       kind: str = "bernoulli",
                       cohort: Optional[int] = None) -> torch.Tensor:
    """Per-round client-sampling mask [n] (or [G, n] for keys [G, 2]),
    float32 in {0, 1}, on the key's device.

    p >= 1 returns all ones (the key is unused).  kind="bernoulli": each
    worker participates independently w.p. p — the reference's
    ``uniform(key, (n,)) < p`` draw, so masks match it worker for worker.
    A rate that expects fewer than one participant per round (p·n < 1) is
    rejected, as in the reference.  kind="choice": exactly
    ``max(1, round(p·n))`` workers, without replacement — the reference's
    ``permutation(key, n) < k``.

    cohort: the rows a cohort round materializes (:func:`cohort_indices`):
    the mask is drawn over the cohort axis only, [cohort] (choice keeps
    ``max(1, round(p·cohort))``), while ``n``, the registered population,
    still sets the degenerate-rate guard.  ``cohort == n`` is the dense
    draw bit for bit.
    """
    rows = n if cohort is None else int(cohort)
    p = float(p)
    if p <= 0:
        raise ValueError(f"participation p must be > 0, got {p}")
    if p >= 1.0:
        return torch.ones(key.shape[:-1] + (rows,), dtype=torch.float32,
                          device=key.device)
    if kind == "bernoulli":
        if p * n < 1.0:
            raise ValueError(
                f"degenerate Bernoulli participation: p={p} over a "
                f"population of n={n} expects p*n={p * n:.3g} < 1 "
                f"participating client per round — raise p (or use "
                f"kind='choice', which always samples at least one worker)")
        return (random.uniform(key, (rows,))
                < torch.tensor(p, dtype=torch.float32)).to(torch.float32)
    if kind == "choice":
        k = max(1, int(round(p * rows)))
        return (random.permutation(key, rows) < k).to(torch.float32)
    raise ValueError(f"unknown sampling kind: {kind!r}")


def validate_ps(ps) -> None:
    """Grid-construction guard for a participation axis: every p > 0."""
    if ps is not None and any(p <= 0 for p in ps):
        raise ValueError(f"participation ps must be > 0, got {list(ps)}")


def resolve_participation(key: torch.Tensor, n: int, cfg_p, kind: str,
                          hp_p: Optional[torch.Tensor] = None,
                          cohort: Optional[int] = None):
    """The sweep steps' mask: the grid's Bernoulli probabilities ``hp_p``
    ([G], on the device) override the static config ``cfg_p``.  Point g's
    mask is ``uniform(keys[g], (n,)) < hp_p[g]``, the reference's traced
    draw, draw for draw.  'choice' sampling fixes its worker count from
    the static p, so it takes no p axis (rejected, as in the reference).
    ``cohort`` draws over the cohort axis only (:func:`participation_mask`)."""
    if hp_p is None:
        return participation_mask(key, n, cfg_p, kind, cohort)
    if kind != "bernoulli":
        raise ValueError(
            "traced participation p requires sampling='bernoulli'; "
            f"sampling={kind!r} resolves its worker count statically — drop "
            "the p axis or switch the config to bernoulli")
    rows = n if cohort is None else int(cohort)
    return (random.uniform(key, (rows,))
            < hp_p.unsqueeze(-1)).to(torch.float32)


#: fold_in salt of the cohort steps' selection key, derived from the
#: participation key: each method's dense key split stays as it is, so a
#: cohort == n run draws the dense engine's masks and worker keys.
COHORT_SALT = 0xC040


def validate_cohort(n_total: int, cohort: int) -> None:
    """Stratified selection draws one client a contiguous stratum of
    n_total // cohort: 1 <= cohort <= n_total and cohort | n_total."""
    if not 1 <= cohort <= n_total:
        raise ValueError(
            f"cohort size must be in [1, n_total], got cohort={cohort} "
            f"for population n_total={n_total}")
    if n_total % cohort:
        raise ValueError(
            f"cohort {cohort} must divide the registered population "
            f"{n_total}: stratified sampling draws one client per "
            f"contiguous stratum of n_total // cohort")


def cohort_indices(key: torch.Tensor, n_total: int,
                   cohort: int) -> torch.Tensor:
    """Stratified distinct-client draw, the reference's: [cohort] int64
    ids (``key.shape[:-1] + (cohort,)`` for batched keys), one uniform
    ``randint(key, (cohort,), 0, stride)`` offset a contiguous stratum of
    ``stride = n_total // cohort`` clients.  Distinct and increasing by
    construction, O(cohort), no [n_total] array; ``cohort == n_total`` is
    ``arange``."""
    validate_cohort(n_total, cohort)
    stride = n_total // cohort
    offs = random.randint(key, (cohort,), 0, stride)
    return torch.arange(cohort, dtype=torch.int64,
                        device=key.device) * stride + offs


def worker_keys(key: torch.Tensor, n: int, ids=None) -> torch.Tensor:
    """``fold_in(key, i)`` for each worker i: keys [..., 2] -> [..., n, 2],
    the keys the reference hands worker i's stochastic oracles; ``ids``
    ([n] or [G, n]) the workers' global ids where the rows are a cohort or
    a shard."""
    if ids is None:
        ids = torch.arange(n, device=key.device)
    return random.fold_in(key.unsqueeze(-2), ids)


def call_oracle(oracle: Callable, key: torch.Tensor, n: int, *args,
                ids=None):
    """``oracle(*args)``; a minibatch oracle (one with ``keyed`` set,
    ``FederatedLogReg.make_oracles(batch=B)``) also gets each worker's key
    ``fold_in(key, i)``.  Full-batch oracles derive no key.  ``ids``
    (global worker ids, [n] or [G, n]): the oracle computes those workers'
    rows only (``ids=``), the cohort's or the shard's."""
    kw = {} if ids is None else {"ids": ids}
    if getattr(oracle, "keyed", False):
        return oracle(*args, worker_keys(key, n, ids), **kw)
    return oracle(*args, **kw)


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of x over the workers with mask == 1: mask [n] (workers the
    leading axis of x) or [G, n] (x [G, n, ...])."""
    shape = mask.shape + (1,) * (x.dim() - mask.dim())
    return torch.sum(mask.reshape(shape) * x, dim=mask.dim() - 1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the sampled workers; an all-zero mask gives zeros."""
    denom = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return masked_sum(x, mask) / denom.reshape(
        denom.shape + (1,) * (x.dim() - mask.dim()))


#: Trace keys never cast by ``trace_dtype``: the bit ledgers stay in
#: ``bits_dtype()``.
TRACE_KEEP_DTYPE: Sequence[str] = ("bits_per_node", "edge_bits")


def _cast_traces(aux: dict, trace_dtype, keep=TRACE_KEEP_DTYPE) -> dict:
    if trace_dtype is None:
        return aux
    return {k: (v if k in keep or not v.is_floating_point()
                else v.to(trace_dtype)) for k, v in aux.items()}


def run_experiment(step: Callable, state, key: torch.Tensor, iters: int,
                   record: Optional[Callable] = None,
                   record_every: int = 1, trace_dtype=None):
    """Run ``step`` for ``iters`` rounds on the keys ``split(key, iters)``.

    record: optional (state) -> dict of extra trace entries (e.g. the
            global objective), evaluated after a round and merged into its
            aux; its keys shadow aux keys.
    record_every: keep only every E-th round's entries (rows E-1, 2E-1,
            ...); E must divide iters.
    trace_dtype: optional dtype the float trace entries are cast to; the
            bit ledgers (``TRACE_KEEP_DTYPE``) keep ``bits_dtype()``.
    Returns (final_state, traces): each trace entry stacked to
    ``[iters // record_every, ...]`` on the device.
    """
    if record_every < 1 or iters % record_every:
        raise ValueError(
            f"record_every={record_every} must divide iters={iters}")
    if getattr(step, "in_place", False):
        state = map_tree(torch.clone, state)   # the rounds own a copy
    keys = random.split(key, iters)
    rows = []
    for t in range(iters):
        state, aux = step(state, keys[t])
        if (t + 1) % record_every == 0:
            if record is not None:
                aux = {**aux, **record(state)}
            rows.append(_cast_traces(aux, trace_dtype))
    traces = {name: torch.stack([row[name] for row in rows])
              for name in rows[0]} if rows else {}
    return state, traces


# ---------------------------------------------------------------------------
# Hparam grids and batched states
# ---------------------------------------------------------------------------

def map_hparams(hp, tensor_fn: Callable, spec_fn: Callable):
    """Rebuild an hparam tree (NamedTuples of tensors, grid specs and None)
    with ``tensor_fn`` on every tensor and ``spec_fn`` on every spec."""
    if hp is None:
        return None
    if isinstance(hp, CompressorSpec):
        return spec_fn(hp)
    if isinstance(hp, torch.Tensor):
        return tensor_fn(hp)
    if isinstance(hp, tuple) and hasattr(hp, "_fields"):
        return type(hp)(*(map_hparams(v, tensor_fn, spec_fn) for v in hp))
    raise TypeError(f"hparam leaf of type {type(hp).__name__}")


def grid_size(hp) -> int:
    """G of an hparam grid; every leaf must agree."""
    sizes = set()
    map_hparams(hp, lambda t: sizes.add(t.shape[0]),
                lambda sp: sizes.add(len(sp.family) if is_grid(sp) else -1))
    if len(sizes) != 1 or -1 in sizes:
        raise ValueError(f"hparam leaves disagree on the grid axis: sizes "
                         f"{sorted(sizes)}")
    return sizes.pop()


def hparams_to(hp, device):
    """An hparam grid with every tensor on ``device`` (one copy a run)."""
    return map_hparams(hp, lambda t: t.to(device),
                       lambda sp: spec_to(sp, device))


def grid1(hp):
    """A scalar hparams point (floats, scalar specs, tensors and nested
    hparams such as an async point's) as a [1] grid: a float leaf becomes
    float32 [1], a tensor leaf gains a leading axis (an integer tensor,
    such as an async point's ``tau``, keeps its dtype)."""
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, CompressorSpec):
            return as_grid(v, 1)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return grid1(v)
        if isinstance(v, torch.Tensor):
            v = v.unsqueeze(0)
            return v.to(torch.float32) if v.is_floating_point() else v
        return torch.tensor([float(v)], dtype=torch.float32)
    return type(hp)(*(leaf(v) for v in hp))


def tile_hparams(hp, reps: int):
    """Every grid leaf repeated ``reps`` times (point b·G + g is point g)."""
    return map_hparams(
        hp, lambda t: t.repeat((reps,) + (1,) * (t.dim() - 1)),
        lambda sp: tile_spec(sp, reps))


def map_tree(fn: Callable, *trees):
    """``fn`` over the tensors of state trees (NamedTuples and dicts,
    rebuilt as such, e.g. an async state's ``MessageBuffer``); any other
    leaf (an int, None) is the first tree's."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: map_tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(map_tree(fn, *xs) for xs in zip(*trees)))
    return t


def _state_device(state) -> torch.device:
    return next(v for v in state if isinstance(v, torch.Tensor)).device


def batch_state(state, G: int, count: bool = True, copy: bool = False):
    """A single (unbatched) state shared by G grid points: every tensor
    (those of nested buffers too) broadcast to a leading [G] axis (a view;
    with ``copy``, G copies the rounds may update in place), ``k`` as an
    int32 [G] tensor (None unless ``count``), ``t`` (where the state has
    one) = k."""
    dev = _state_device(state)
    fields = {}
    for name, v in zip(state._fields, state):
        if name == "k":
            fields[name] = (torch.full((G,), int(v), dtype=torch.int32,
                                       device=dev) if count else None)
        elif name == "t":
            fields[name] = int(state.k)
        elif copy:
            fields[name] = map_tree(
                lambda x: x.unsqueeze(0).repeat((G,) + (1,) * x.dim()), v)
        else:
            fields[name] = map_tree(
                lambda x: x.unsqueeze(0).expand((G,) + x.shape), v)
    return type(state)(**fields)


def point_state(state, g: int, k: int):
    """Grid point g of a batched state as an unbatched state at round
    ``k``."""
    fields = {}
    for name, v in zip(state._fields, state):
        if name in ("k", "t"):
            fields[name] = k
        else:
            fields[name] = map_tree(lambda x: x[g], v)
    return type(state)(**fields)


def specialize(sweep_step: Callable, hp) -> Callable:
    """The sweep step at one hparams point: ``step(state, key)`` on an
    unbatched state, run as the [1] grid of that point (the reference's
    legacy ``make_*_step``).  ``hp`` is a scalar point; its [1] grid is
    moved to each device once."""
    hp1 = grid1(hp)
    on = {}

    def step(state, key):
        dev = key.device
        if dev not in on:
            on[dev] = hparams_to(hp1, dev)
        new, aux = sweep_step(on[dev], batch_state(state, 1, count=False),
                              key.unsqueeze(0))
        return point_state(new, 0, state.k + 1), {k: v[0]
                                                  for k, v in aux.items()}

    # an in-place sweep step (the cohort engines) updates the state it is
    # given: run_experiment hands it a copy of the caller's
    step.in_place = getattr(sweep_step, "in_place", False)
    return step


def sweep_keys(key: torch.Tensor, G: int, iters: int) -> torch.Tensor:
    """[G, iters, 2] per-point key streams: point g steps with
    ``split(split(key, G)[g], iters)``, the stream a standalone
    ``run_experiment(step_g, state, split(key, G)[g], iters)`` uses."""
    return random.split(random.split(key, G), iters)


# ---------------------------------------------------------------------------
# Bit budgets: the budget-freeze mode
# ---------------------------------------------------------------------------

def hparams_bit_budget(hp):
    """The per-point bit budget an hparam grid carries ([G]), or None.
    Async hparams carry it on their inner sync ``hp``: the budget gates
    the arrival-billed ledger the same way."""
    budget = getattr(hp, "bit_budget", None)
    if budget is None:
        inner = getattr(hp, "hp", None)
        if inner is not None:
            budget = getattr(inner, "bit_budget", None)
    return budget


#: Aux entries zeroed on frozen rounds: nothing is sent or moves.
_FROZEN_ZERO_KEYS: Sequence[str] = ("n_active", "n_arrived", "flushed",
                                    "staleness_mean", "g_tilde_norm",
                                    "dir_norm")


def _where(active: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


def freeze_on_bit_budget(sweep_step: Callable) -> Callable:
    """Budget-freeze mode: once a grid point's cumulative per-node bits
    (``max_i bits_per_node[g, i]``) reach its ``bit_budget[g]``, its whole
    state is held at the previous round's (``torch.where`` over every
    state leaf, an async state's buffers included, with the [G] mask) and
    nothing more is charged; a T-round
    budget run is the truncated run padded with bit-stable rows.  The mask
    stays on the device.  Hparams without a budget pass through."""
    def step(hp, state, key):
        budget = hparams_bit_budget(hp)
        if budget is None:
            return sweep_step(hp, state, key)
        active = torch.amax(state.bits_per_node, dim=-1) < budget
        new_state, aux = sweep_step(hp, state, key)
        frozen = map_tree(lambda new, old: _where(active, new, old),
                          new_state, state)
        aux = dict(aux)
        if "bits_per_node" in aux:
            aux["bits_per_node"] = frozen.bits_per_node
        if "buffered" in aux and hasattr(frozen, "acc_n"):
            aux["buffered"] = frozen.acc_n
        for name in _FROZEN_ZERO_KEYS:
            if name in aux:
                aux[name] = _where(active, aux[name],
                                   torch.zeros_like(aux[name]))
        return frozen, aux

    return step


def iters_for_bit_budget(budget, bits_per_round) -> int:
    """Upper-bound scan length of a budget run: the smallest round count
    whose cumulative per-node bits reach ``budget``, maxed over a grid (the
    reference's bound and checks; host numbers)."""
    budget = np.asarray(budget, dtype=float)
    price = np.asarray(bits_per_round, dtype=float)
    if budget.size == 0 or price.size == 0:
        raise ValueError("empty bit-budget/price grid")
    if not np.all(np.isfinite(budget)):
        raise ValueError(
            f"bit budgets must be finite, got {budget}: an inf/nan budget "
            "has no derivable scan length — pin run.iters explicitly for "
            "unbounded runs instead")
    if np.any(price <= 0) or not np.all(np.isfinite(price)):
        raise ValueError(
            f"bits_per_round must be finite and > 0, got {price}")
    return max(1, int(np.ceil(np.max(budget / price))))


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def sweep_program(sweep_step: Callable, iters: int,
                  record: Optional[Callable] = None,
                  record_every: int = 1, trace_dtype=None) -> Callable:
    """fn(hparams, state, keys) -> (final states, traces): ``iters``
    rounds of ``sweep_step`` over the [G] grid, keys [G, iters, 2] from
    :func:`sweep_keys`, ``state`` one unbatched initial state shared by the
    grid, hparams on the state's device.  Budget-carrying hparams run in
    the budget-freeze mode.  Traces are [G, iters // record_every, ...];
    ``record(batched state)`` gives [G]-leading entries."""
    if record_every < 1 or iters % record_every:
        raise ValueError(
            f"record_every={record_every} must divide iters={iters}")
    # a step that updates its state in place (the cohort engines' [G, N]
    # tables) owns a copy of the initial state; the caller's is untouched
    in_place = getattr(sweep_step, "in_place", False)
    step = sweep_step if in_place else freeze_on_bit_budget(sweep_step)

    def fn(hp, state, keys):
        if in_place and hparams_bit_budget(hp) is not None:
            raise ValueError(
                "the cohort engines update their population tables in "
                "place and run without a bit budget")
        st = batch_state(state, keys.shape[0], copy=in_place)
        per_round = keys.transpose(0, 1).contiguous()       # [iters, G, 2]
        rows = []
        for t in range(iters):
            st, aux = step(hp, st, per_round[t])
            if (t + 1) % record_every == 0:
                if record is not None:
                    aux = {**aux, **record(st)}
                rows.append(_cast_traces(aux, trace_dtype))
        return st, {name: torch.stack([row[name] for row in rows], dim=1)
                    for name in rows[0]}

    return fn


def run_sweep(sweep_step: Callable, hparams, state, key: torch.Tensor,
              iters: int, record: Optional[Callable] = None,
              record_every: int = 1, trace_dtype=None):
    """A grid of runs as one batched program: ``hparams`` a [G] grid (built
    on any device; moved to the state's once), ``state`` one unbatched
    initial state shared by every point.  Returns (final states [G, ...],
    traces [G, iters // record_every, ...]); row g is the standalone run
    on ``split(key, G)[g]``."""
    G = grid_size(hparams)
    hp = hparams_to(hparams, _state_device(state))
    fn = sweep_program(sweep_step, iters, record=record,
                       record_every=record_every, trace_dtype=trace_dtype)
    return fn(hp, state, sweep_keys(key, G, iters))


# ---------------------------------------------------------------------------
# Sharded sweeps: the worker axis over a process group
# ---------------------------------------------------------------------------

#: The state-spec name of a worker-sharded leaf (dim 0 of the unbatched
#: state, dim 1 of a batched one); "" is replicated.
WORKERS = "workers"


class WorkerGroup(NamedTuple):
    """A ``torch.distributed`` process group laid over the worker axis
    (the reference's 1-D device mesh): rank r holds the contiguous block
    [r·n_local, (r+1)·n_local) of every worker-sharded leaf."""
    group: Any
    rank: int
    size: int


def worker_group(world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 init_method: Optional[str] = None,
                 backend: str = "gloo") -> WorkerGroup:
    """The process group of the sharded engine (the reference's
    ``worker_mesh``).  Initializes ``torch.distributed`` where it is not:
    ``init_method`` (``file://...`` or ``tcp://localhost:<port>``), the
    world size and this process's rank are given explicitly, as nothing
    tells a program of a cluster; ``backend`` "nccl" for CUDA tensors,
    "gloo" for CPU ones.  Returns the default group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if init_method is None or world_size is None or rank is None:
            raise ValueError(
                "worker_group: torch.distributed is not initialized; pass "
                "init_method, world_size and rank")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return WorkerGroup(dist.group.WORLD, dist.get_rank(),
                       dist.get_world_size())


def gather_workers(x: torch.Tensor, group: WorkerGroup,
                   dim: int = 1) -> torch.Tensor:
    """Every rank's block of x, concatenated along ``dim`` in rank order
    (``all_gather(tiled=True)``): the full-federation array, the same
    values on every rank."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.group)
    return torch.cat(parts, dim=dim)


def sum_workers(x: torch.Tensor, group: WorkerGroup) -> torch.Tensor:
    """Sum over the ranks (``psum``) — for integer-exact counts only: a
    float sum would depend on the order of the ranks' partials."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, group=group.group)
    return out


def max_workers(x: torch.Tensor, group: WorkerGroup) -> torch.Tensor:
    """The maximum over the ranks (``pmax``; ``all_reduce(MAX)``), exact in
    any order: the dither norms' int32 bits in the trainer."""
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group.group)
    return out


def sum_levels_workers(levels: torch.Tensor,
                       group: WorkerGroup) -> torch.Tensor:
    """Each rank's integer level sums, summed over the ranks with float16
    on the wire (the reference's f16 ``psum``: 2 bytes an element).  Exact
    while every partial and total stays within ±2048, which
    ``compressors.psum_level_cap`` ensures; returns float16."""
    import torch.distributed as dist
    wire = levels.to(torch.float16)
    dist.all_reduce(wire, group=group.group)
    return wire


def worker_block(group: Optional[WorkerGroup], n_total: int) -> range:
    """The global ids of this rank's workers, [r·n_local, (r+1)·n_local)
    (all of them without a group).  A count that does not divide over the
    ranks raises."""
    if group is None:
        return range(n_total)
    if n_total % group.size:
        raise ValueError(f"{n_total} workers do not divide over "
                         f"{group.size} rank(s)")
    n_loc = n_total // group.size
    return range(group.rank * n_loc, (group.rank + 1) * n_loc)


def shard_rows(group: WorkerGroup, n_total: int, device) -> torch.Tensor:
    """This rank's global worker ids, int64 [n_total // size]."""
    ids = worker_block(group, n_total)
    return torch.arange(ids.start, ids.stop, device=device)


def run_sharded_sweep(sweep_step: Callable, hparams, state,
                      key: torch.Tensor, iters: int, state_specs,
                      group: Optional[WorkerGroup] = None,
                      record: Optional[Callable] = None,
                      record_every: int = 1, trace_dtype=None,
                      worker_traces: Sequence[str] = ("bits_per_node",)):
    """:func:`run_sweep` with the worker axis over a process group, called
    in every rank with the full initial state (SPMD).

    ``sweep_step`` is shard-aware (``make_*_sharded_sweep_step``): each
    rank keeps its contiguous block of the worker leaves (``state_specs``:
    a tree like ``state`` whose leaves are :data:`WORKERS` or ""), computes
    its workers' messages under their global ids and the global key
    stream, rebuilds the full-federation arrays with ``all_gather`` and
    runs the server math replicated; only integer-exact counts are summed
    over the ranks.  The server math is the dense round's ops on the same
    values, so the result equals :func:`run_sweep` bit for bit where each
    rank's worker computations give the bits they give in one batch.

    Returns (final states, traces) shaped as :func:`run_sweep`'s: the
    worker leaves and the ``worker_traces`` (a trailing worker axis)
    gathered from every rank.  A worker leaf that does not divide over the
    ranks raises."""
    if group is None:
        group = worker_group()

    def local(leaf, spec):
        if spec != WORKERS:
            return leaf
        if leaf.dim() == 0 or leaf.shape[0] % group.size:
            raise ValueError(
                f"worker-sharded state leaf of shape {tuple(leaf.shape)} "
                f"does not divide over {group.size} rank(s)")
        n_loc = leaf.shape[0] // group.size
        return leaf[group.rank * n_loc:(group.rank + 1) * n_loc]

    local_state = type(state)(*(
        local(v, sp) if isinstance(v, torch.Tensor) else v
        for v, sp in zip(state, state_specs)))
    G = grid_size(hparams)
    hp = hparams_to(hparams, _state_device(state))
    fn = sweep_program(sweep_step, iters, record=record,
                       record_every=record_every, trace_dtype=trace_dtype)
    sts, tr = fn(hp, local_state, sweep_keys(key, G, iters))
    sts = type(sts)(*(
        gather_workers(v, group, 1) if sp == WORKERS else v
        for v, sp in zip(sts, state_specs)))
    tr = {name: gather_workers(v, group, 2) if name in worker_traces else v
          for name, v in tr.items()}
    return sts, tr


# ---------------------------------------------------------------------------
# Staleness: per-worker delays
# ---------------------------------------------------------------------------

#: fold_in salt of the async steps' per-round delay key: deriving it by
#: fold_in (not by widening a method's key split) leaves the synchronous
#: key streams untouched, which is what makes tau = 0 the synchronous run.
ASYNC_SALT = 0x5A17


def per_point(v, key: torch.Tensor) -> torch.Tensor:
    """An int or a [G] tensor as an int64 tensor that broadcasts against
    [..., n] draws of keys [..., 2] (a [G] tensor as [G, 1])."""
    t = torch.as_tensor(v, dtype=torch.int64, device=key.device)
    return t.unsqueeze(-1) if t.dim() else t


def geometric_delays(u: torch.Tensor, q: float, tau) -> torch.Tensor:
    """``min(floor(log(u) / log(q)), tau)`` as int64: the reference's
    geometric delay from its uniforms, in its expression order (float32
    ``log`` of u and of q, a quotient, a floor, a truncation to int)."""
    lq = torch.log(torch.tensor(q, dtype=torch.float32, device=u.device))
    g = torch.floor(torch.log(u) / lq)
    return torch.minimum(g.to(torch.int64), torch.as_tensor(
        tau, dtype=torch.int64, device=u.device))


def sample_delays(kind: str, key: torch.Tensor, n: int, tau,
                  q: float = 0.5) -> torch.Tensor:
    """Per-worker delays in [0, tau], int64 ``key.shape[:-1] + (n,)``, the
    reference's draws: "fixed" is tau, "uniform" ``randint(key, (n,), 0,
    tau + 1)``, "geometric" :func:`geometric_delays` of ``uniform(key,
    (n,), minval=finfo(float32).tiny)``.  ``tau`` is an int, or an int
    [G] tensor with keys [G, 2] (a grid point's own bound); at tau = 0
    every kind gives zeros."""
    tau = per_point(tau, key)
    shape = key.shape[:-1] + (n,)
    if kind == "fixed":
        return tau.expand(shape).clone()
    if kind == "uniform":
        return random.randint(key, (n,), 0, tau + 1)
    if kind == "geometric":
        # q is a static float; a degenerate q makes log(q) 0 or -inf
        if not 0.0 < q < 1.0:
            raise ValueError(f"geometric q must be in (0, 1), got {q}")
        u = random.uniform(key, (n,),
                           minval=float(np.finfo(np.float32).tiny))
        return geometric_delays(u, q, tau)
    raise ValueError(f"unknown staleness kind: {kind!r}")


@dataclasses.dataclass(frozen=True)
class StalenessSchedule:
    """Per-worker integer round delays, drawn each round: "fixed" (every
    message arrives exactly ``tau`` rounds late; tau = 0 is synchronous),
    "uniform" (Uniform{0, ..., tau}) or "geometric" (each round in flight
    continues with probability ``q``, capped at tau).  ``tau`` bounds the
    delay, so the :class:`MessageBuffer` needs ``tau + 1`` slots."""
    kind: str = "fixed"
    tau: int = 0
    q: float = 0.5     # geometric only: per-round straggle probability

    def __post_init__(self):
        if self.kind not in ("fixed", "uniform", "geometric"):
            raise ValueError(f"unknown staleness kind: {self.kind!r}")
        if self.tau < 0:
            raise ValueError(f"tau must be >= 0, got {self.tau}")
        if self.kind == "geometric" and not 0.0 < self.q < 1.0:
            raise ValueError(f"geometric q must be in (0, 1), got {self.q}")

    @property
    def max_delay(self) -> int:
        return self.tau

    def sample(self, key: torch.Tensor, n: int) -> torch.Tensor:
        return sample_delays(self.kind, key, n, self.tau, self.q)


def damped_alpha(alpha0, sampled_frac, buffer_k, n_workers):
    """The auto-damped async step size ``alpha0 · min(1, p · K / n)``, in
    float32 (the reference's rule; any argument may be a [G] tensor)."""
    f32 = dict(dtype=torch.float32)
    scale = (torch.as_tensor(sampled_frac, **f32)
             * torch.as_tensor(buffer_k, **f32) / n_workers)
    return torch.as_tensor(alpha0, **f32) * torch.clamp(scale, 0.0, 1.0)


# ---------------------------------------------------------------------------
# The bounded in-flight message buffer
# ---------------------------------------------------------------------------

class MessageBuffer(NamedTuple):
    """Cyclic in-flight store: slot ``r % S`` holds the messages arriving
    at round r (S = max_delay + 1).

    slots:    dict of [..., S, n, ...] tensors, one a message field (a
              leading [G] axis in a batched state).  Cells of workers with
              ``occupied == 0`` hold stale values: every consumer gates on
              the arrival mask.
    occupied: [..., S, n] float32 in {0, 1}.
    """
    slots: Any
    occupied: torch.Tensor


def init_buffer(proto: dict, max_delay: int) -> MessageBuffer:
    """An empty buffer for per-worker message prototypes ``proto`` (a dict
    of [n, ...] tensors) with room for delays in [0, max_delay]."""
    S = int(max_delay) + 1
    first = next(iter(proto.values()))
    slots = {k: torch.zeros((S,) + x.shape, dtype=x.dtype, device=x.device)
             for k, x in proto.items()}
    return MessageBuffer(slots, torch.zeros((S, first.shape[0]),
                                            dtype=torch.float32,
                                            device=first.device))


def buffer_busy(buf: MessageBuffer) -> torch.Tensor:
    """[..., n] {0, 1}: the worker has a message in flight.  A busy worker
    is not handed new work (the shift-consistency lock)."""
    return torch.amax(buf.occupied, dim=-2)


def buffer_hits(buf: MessageBuffer, mask: torch.Tensor,
                delays: torch.Tensor, k: int) -> torch.Tensor:
    """[..., S, n] {0, 1}: worker i's message of round ``k`` (a host int)
    goes to slot ``(k + delay_i) % S`` where ``mask`` is 1."""
    S = buf.occupied.shape[-2]
    slot = (k + delays) % S                                       # [..., n]
    ar = torch.arange(S, device=slot.device).unsqueeze(-1)         # [S, 1]
    return (ar == slot.unsqueeze(-2)).to(torch.float32) * mask.unsqueeze(-2)


def blend(cur: torch.Tensor, hit: torch.Tensor, msg) -> torch.Tensor:
    """The reference's slot write ``cur * (1 - h) + h * msg`` (an
    arithmetic blend, not a select: every cell goes through ``cur + 0 ·
    msg``, so a stored -0 becomes +0 and a non-finite message NaN in every
    slot of its worker).  ``hit`` [..., S, n]; ``msg`` [..., n, ...], or
    None for the zero message of a round nobody computes."""
    h = hit.reshape(hit.shape + (1,) * (cur.dim() - hit.dim()))
    kept = cur * (1.0 - h)
    if msg is None:
        return kept + 0.0                 # + h · 0
    return torch.addcmul(kept, h, msg.unsqueeze(hit.dim() - 2).to(cur.dtype))


def buffer_send(buf: MessageBuffer, msgs: dict, mask: torch.Tensor,
                delays: torch.Tensor, k: int) -> MessageBuffer:
    """File ``msgs`` (dict of [..., n, ...]) computed at round ``k`` by the
    workers with ``mask == 1`` under arrival slot ``(k + delay_i) % S``."""
    hit = buffer_hits(buf, mask, delays, k)
    return MessageBuffer({name: blend(cur, hit, msgs[name])
                          for name, cur in buf.slots.items()},
                         buf.occupied * (1.0 - hit) + hit)


def buffer_receive(buf: MessageBuffer, k: int):
    """Drain round ``k``'s arrivals (``k`` a host int): (buf', msgs,
    arrived), msgs a dict of [..., n, ...] and arrived the [..., n] {0, 1}
    arrival mask.  Cells with ``arrived == 0`` are stale."""
    S = buf.occupied.shape[-2]
    s = int(k) % S
    axis = buf.occupied.dim() - 2
    msgs = {name: a.select(axis, s) for name, a in buf.slots.items()}
    arrived = buf.occupied.select(-2, s)
    keep = (torch.arange(S, device=arrived.device) != s).to(
        torch.float32).unsqueeze(-1)                              # [S, 1]
    return MessageBuffer(buf.slots, buf.occupied * keep), msgs, arrived


def fedbuff_accumulate(acc, acc_n, contributions, arrived, buffer_k):
    """One round of FedBuff server bookkeeping, shared by every async step.

    acc:           the running sums since the last flush (a tensor or a
                   dict of tensors, [G, ...]); contributions the matching
                   per-worker [G, n, ...] values, rows with ``arrived ==
                   0`` ignored.
    Returns (acc', acc_n', means, flush, reset): the sums and count, the
    buffered means (sum / max(count, 1), the synchronous ``masked_mean``
    algebra, so tau = 0 stays the synchronous run), the [G] bool "count
    reached buffer_k", and ``reset(tree)``, zeroing a tree where a point
    flushed."""
    acc = map_tree(lambda a, x: a + masked_sum(x, arrived), acc,
                   contributions)
    acc_n = acc_n + torch.sum(arrived, dim=-1)
    flush = acc_n >= buffer_k
    denom = torch.clamp(acc_n, min=1.0)

    def per_point(t, a):
        return t.reshape(t.shape + (1,) * (a.dim() - t.dim()))

    means = map_tree(lambda a: a / per_point(denom, a), acc)

    def reset(tree):
        return map_tree(lambda a: torch.where(per_point(flush, a),
                                              torch.zeros_like(a), a), tree)

    return acc, acc_n, means, flush, reset


def applied_staleness(k: int, msg_t: torch.Tensor,
                      arrived: torch.Tensor) -> torch.Tensor:
    """Mean age in rounds of this round's applied updates (``k`` the host
    round, ``msg_t`` the compute-round stamps), 0 where nothing
    arrived."""
    return (torch.sum(arrived * (float(k) - msg_t), dim=-1)
            / torch.clamp(torch.sum(arrived, dim=-1), min=1.0))


def run_async_sweep(sweep_step: Callable, hparams, state,
                    key: torch.Tensor, iters: int,
                    record: Optional[Callable] = None,
                    record_every: int = 1, trace_dtype=None):
    """:func:`run_sweep` for an async grid (hparams with a ``tau`` leaf):
    every point shares the state's buffer, which must hold max(tau) + 1
    slots (a point's smaller tau leaves the later slots unused).  Row g is
    the standalone async run on ``split(key, G)[g]``."""
    taus = getattr(hparams, "tau", None)
    buf = getattr(state, "buf", None)
    if taus is not None and buf is not None:
        slots = buf.occupied.shape[-2]
        tau_max = int(torch.as_tensor(taus).max())
        if tau_max + 1 > slots:
            raise ValueError(
                f"shared MessageBuffer has {slots} slot(s) but the grid "
                f"reaches tau={tau_max}; init the async state with "
                f"max_delay >= {tau_max}")
    return run_sweep(sweep_step, hparams, state, key, iters, record=record,
                     record_every=record_every, trace_dtype=trace_dtype)
