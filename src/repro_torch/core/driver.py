"""Synchronous experiment driver (counterpart of ``repro.core.driver``).

Every experiment drives a step of the uniform shape

    step(state, key) -> (state, aux)

The reference scans the step in one compiled ``lax.scan`` program; here
:func:`run_experiment` is a Python loop over the same key stream,
``split(key, iters)``.  Per-round traces stay on the device and are stacked
at the end, so the loop never waits for the device between rounds.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import random


def bits_dtype():
    """Accumulator dtype of the bit ledgers: float32, the reference's
    default (exact for integer counts below 2**24)."""
    return torch.float32


def participation_mask(key: torch.Tensor, n: int, p: float = 1.0,
                       kind: str = "bernoulli") -> torch.Tensor:
    """Per-round client-sampling mask [n], float32 in {0, 1}, on the key's
    device.

    p >= 1 returns all ones (the key is unused).  kind="bernoulli": each
    worker participates independently w.p. p — the reference's
    ``uniform(key, (n,)) < p`` draw, so masks match it worker for worker.
    A rate that expects fewer than one participant per round (p·n < 1) is
    rejected, as in the reference.
    """
    p = float(p)
    if p <= 0:
        raise ValueError(f"participation p must be > 0, got {p}")
    if p >= 1.0:
        return torch.ones(n, dtype=torch.float32, device=key.device)
    if kind == "bernoulli":
        if p * n < 1.0:
            raise ValueError(
                f"degenerate Bernoulli participation: p={p} over a "
                f"population of n={n} expects p*n={p * n:.3g} < 1 "
                f"participating client per round — raise p (or use "
                f"kind='choice', which always samples at least one worker)")
        return (random.uniform(key, (n,))
                < torch.tensor(p, dtype=torch.float32)).to(torch.float32)
    if kind == "choice":
        raise NotImplementedError(
            "sampling='choice' needs random.permutation, which is not "
            "ported yet (ROADMAP.md, queue 1: 'choice sampling')")
    raise ValueError(f"unknown sampling kind: {kind!r}")


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum of x over the workers (leading axis) with mask == 1."""
    shape = (-1,) + (1,) * (x.dim() - 1)
    return torch.sum(mask.reshape(shape) * x, dim=0)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the sampled workers; an all-zero mask gives zeros."""
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return masked_sum(x, mask) / denom


def run_experiment(step: Callable, state, key: torch.Tensor, iters: int,
                   record: Optional[Callable] = None,
                   record_every: int = 1):
    """Run ``step`` for ``iters`` rounds on the keys ``split(key, iters)``.

    record: optional (state) -> dict of extra trace entries (e.g. the
            global objective), evaluated after a round and merged into its
            aux; its keys shadow aux keys.
    record_every: keep only every E-th round's entries (rows E-1, 2E-1,
            ...); E must divide iters.
    Returns (final_state, traces): each trace entry stacked to
    ``[iters // record_every, ...]`` on the device.
    """
    if record_every < 1 or iters % record_every:
        raise ValueError(
            f"record_every={record_every} must divide iters={iters}")
    keys = random.split(key, iters)
    rows = []
    for t in range(iters):
        state, aux = step(state, keys[t])
        if (t + 1) % record_every == 0:
            if record is not None:
                aux = {**aux, **record(state)}
            rows.append(aux)
    traces = {name: torch.stack([row[name] for row in rows])
              for name in rows[0]} if rows else {}
    return state, traces
