"""Traffic for the async engine: arrival processes, client availability and
server-side admission (counterpart of ``repro.core.traffic``).

* :class:`ArrivalSchedule` — a message sent at round k completes at offset
  t with probability ``rate_table[(k + t) % P]`` ("poisson": one rate,
  "diurnal": a P-phase table), or replays a recorded ``[T, n]`` delay
  trace ("trace"), or keeps the ``StalenessSchedule`` draw ("schedule").
  Every delay stays within the point's tau (the buffer's slot contract).
* :class:`AvailabilityModel` — a Markov chain over {AVAILABLE, BUSY,
  DROPPED} for each client (:class:`TrafficState`), stepped once a round;
  only AVAILABLE clients may be sent work.
* :class:`AdmissionPolicy` — ``max_in_flight`` caps the messages in flight
  (the excess senders, in worker order, wait), ``staleness_cutoff``
  discards older arrivals before they are billed or applied.

The numbers ride the async hparams as :class:`TrafficHParams` ([G, ...]
tensors in a grid), the chain's states the async state as
:class:`TrafficState` ([G, n] in a batched state).  The draws come from the
round key by ``fold_in`` with :data:`ARRIVAL_SALT` and :data:`AVAIL_SALT`,
so a traffic model never perturbs a method's own key stream: a cutoff of 0
at tau = 0 is the synchronous run, bit for bit.

:func:`route_round` is the routing half of every async round (delays,
traffic, the buffer's slots, admission, the FedBuff count): it reads one
small tensor to the host a round, which tells the methods whether any
point sends, receives or flushes, so they skip the work no point needs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import random
from repro_torch.core.driver import (ASYNC_SALT, MessageBuffer,
                                     applied_staleness, blend, buffer_busy,
                                     buffer_hits, buffer_receive, per_point,
                                     sample_delays)

#: fold_in salts of the traffic draws (see ``driver.ASYNC_SALT``).
ARRIVAL_SALT = 0x7AF1
AVAIL_SALT = 0xAB1E

#: Availability states: only AVAILABLE clients may be sent work.
AVAILABLE, BUSY, DROPPED = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """Which process draws a round's per-worker delays: "schedule" (the
    ``StalenessSchedule`` draw), "poisson" (completion each round with
    probability ``rates[0]``), "diurnal" (the P-phase table ``rates``) or
    "trace" (row ``k % T`` of a ``[T, n]`` delay trace)."""
    kind: str = "schedule"
    rates: Sequence[float] = (0.5,)
    trace: Any = None

    def __post_init__(self):
        if self.kind not in ("schedule", "poisson", "diurnal", "trace"):
            raise ValueError(f"unknown arrival kind: {self.kind!r}")
        if self.kind == "poisson" and len(self.rates) != 1:
            raise ValueError(
                f"poisson arrivals take a single rate, got {len(self.rates)}"
                " — use kind='diurnal' for a multi-phase rate table")
        if self.kind in ("poisson", "diurnal"):
            if len(self.rates) == 0:
                raise ValueError("arrival rate table must be non-empty")
            if any(not 0.0 < r <= 1.0 for r in self.rates):
                raise ValueError(
                    f"arrival rates must be in (0, 1], got {list(self.rates)}")
        if self.kind == "trace":
            if self.trace is None:
                raise ValueError("kind='trace' requires a [T, n] delay trace")
            t = np.asarray(self.trace)
            if t.ndim != 2 or t.size == 0:
                raise ValueError(
                    f"delay trace must be a non-empty [T, n] array, got "
                    f"shape {t.shape}")
            if np.any(t < 0):
                raise ValueError("delay trace entries must be >= 0")


@dataclasses.dataclass(frozen=True)
class AvailabilityModel:
    """Per-client availability chain: ``transition[s]`` is the
    distribution of the next state given state s."""
    transition: Sequence[Sequence[float]] = ((0.85, 0.10, 0.05),
                                             (0.60, 0.40, 0.00),
                                             (0.10, 0.00, 0.90))

    def __post_init__(self):
        t = np.asarray(self.transition, np.float64)
        if t.ndim != 2 or t.shape[0] != t.shape[1] or t.shape[0] < 2:
            raise ValueError(
                f"transition must be a square (>= 2-state) matrix, got "
                f"shape {t.shape}")
        if np.any(t < 0) or not np.allclose(t.sum(axis=1), 1.0, atol=1e-6):
            raise ValueError(
                "transition rows must be non-negative and sum to 1, got "
                f"{t.tolist()}")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Server-side admission: ``max_in_flight`` caps the messages in flight
    (inf: uncapped), ``staleness_cutoff`` discards arrivals older than it
    (inf: admit all; 0: only fresh ones), unbilled."""
    staleness_cutoff: float = float("inf")
    max_in_flight: float = float("inf")

    def __post_init__(self):
        if self.staleness_cutoff < 0:
            raise ValueError(
                f"staleness_cutoff must be >= 0, got {self.staleness_cutoff}")
        if self.max_in_flight < 0:
            raise ValueError(
                f"max_in_flight must be >= 0, got {self.max_in_flight}")


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """The static traffic structure a plan or step carries; its numbers
    are :func:`traffic_hparams`."""
    arrival: ArrivalSchedule = ArrivalSchedule()
    availability: Optional[AvailabilityModel] = None
    admission: Optional[AdmissionPolicy] = None


class TrafficHParams(NamedTuple):
    """A model's numbers: rate_table [P], avail_transition [S, S] (the
    identity without availability), staleness_cutoff and max_in_flight
    (0-d); each with a leading [G] axis in a grid."""
    rate_table: torch.Tensor
    avail_transition: torch.Tensor
    staleness_cutoff: torch.Tensor
    max_in_flight: torch.Tensor


class TrafficState(NamedTuple):
    """The availability chain's states, int64 [n] ([G, n] batched),
    all AVAILABLE at init."""
    avail: torch.Tensor


def traffic_hparams(model: TrafficModel) -> TrafficHParams:
    """The numbers of a model, as a point on the CPU (``api`` broadcasts
    them over a run's [G] grid)."""
    f32 = dict(dtype=torch.float32)
    if model.arrival.kind in ("poisson", "diurnal"):
        table = torch.tensor(np.asarray(model.arrival.rates, np.float32),
                             **f32)
    else:
        table = torch.ones((1,), **f32)
    if model.availability is not None:
        trans = torch.tensor(np.asarray(model.availability.transition,
                                        np.float32), **f32)
    else:
        trans = torch.eye(3, **f32)
    adm = model.admission if model.admission is not None else AdmissionPolicy()
    return TrafficHParams(table, trans,
                          torch.tensor(np.float32(adm.staleness_cutoff),
                                       **f32),
                          torch.tensor(np.float32(adm.max_in_flight), **f32))


def init_traffic_state(n_workers: int, device="cpu") -> TrafficState:
    return TrafficState(torch.zeros((n_workers,), dtype=torch.int64,
                                    device=device))


# ---------------------------------------------------------------------------
# Arrival draws
# ---------------------------------------------------------------------------

def thinned_delays(rate_table: torch.Tensor, key: torch.Tensor, n: int,
                   k: int, tau, slots: int) -> torch.Tensor:
    """Poisson-thinned delays of the messages sent at round ``k`` (a host
    int), int64 ``key.shape[:-1] + (n,)``: offset t completes with
    probability ``rate_table[..., (k + t) % P]``; the first completing
    offset of ``slots`` is the delay, and a message that completes in none
    is charged tau, the cap.  ``rate_table`` [..., P] and ``tau`` (an int
    or [G]) per point."""
    P = rate_table.shape[-1]
    offs = (k + torch.arange(slots, device=key.device)) % P
    r = rate_table[..., offs]                                 # [..., slots]
    u = random.uniform(key, (n, slots))
    hit = u < r.unsqueeze(-2)
    first = torch.argmax(hit.to(torch.uint8), dim=-1)         # first True
    tau = per_point(tau, key)
    return torch.minimum(torch.where(hit.any(dim=-1), first, tau), tau)


def replay_delays(trace, k: int, tau) -> torch.Tensor:
    """Row ``k % T`` of a recorded ``[T, n]`` delay trace, clipped to tau
    (an int or an int [G] tensor: [G, n] then)."""
    tau = torch.as_tensor(tau, dtype=torch.int64)
    dev = tau.device
    trace = torch.as_tensor(np.asarray(trace), dtype=torch.int64,
                            device=dev)
    row = trace[int(k) % trace.shape[0]]
    return torch.minimum(row, tau.unsqueeze(-1) if tau.dim() else tau)


# ---------------------------------------------------------------------------
# The availability chain
# ---------------------------------------------------------------------------

def availability_step(avail_transition: torch.Tensor, avail: torch.Tensor,
                      key: torch.Tensor) -> torch.Tensor:
    """One Markov step of every client's state: its transition row, summed
    left to right in float32 (the reference's cumsum), and the count of
    partial sums at or below a uniform, clamped to the last state (a sum
    can land an ulp under 1).  ``avail_transition`` [..., S, S], ``avail``
    [..., n] int64, ``key`` [..., 2]."""
    n_states = avail_transition.shape[-1]
    rows = torch.gather(
        avail_transition, -2,
        avail.unsqueeze(-1).expand(avail.shape + (n_states,)))  # [..., n, S]
    acc = rows[..., 0]
    cum = [acc]
    for j in range(1, n_states):
        acc = acc + rows[..., j]
        cum.append(acc)
    cum = torch.stack(cum, dim=-1)
    u = random.uniform(key, avail.shape[-1:])
    nxt = torch.sum((u.unsqueeze(-1) >= cum).to(torch.int64), dim=-1)
    return torch.clamp(nxt, max=n_states - 1)


def available_mask(avail: torch.Tensor) -> torch.Tensor:
    """float32 {0, 1}: the clients in the AVAILABLE state."""
    return (avail == AVAILABLE).to(torch.float32)


def stationary_distribution(transition) -> np.ndarray:
    """The stationary law pi (pi T = pi, sum 1) of a row-stochastic
    matrix, in numpy: the oracle of the chain's occupancy."""
    t = np.asarray(transition, np.float64)
    s = t.shape[0]
    a = np.vstack([t.T - np.eye(s), np.ones((1, s))])
    b = np.zeros(s + 1)
    b[-1] = 1.0
    pi, *_ = np.linalg.lstsq(a, b, rcond=None)
    return pi


# ---------------------------------------------------------------------------
# An async round's send and receive sides
# ---------------------------------------------------------------------------

def traffic_send(model: TrafficModel, thp: Optional[TrafficHParams],
                 tstate: Optional[TrafficState], buf: MessageBuffer,
                 mask: torch.Tensor, key: torch.Tensor, k: int, tau,
                 base_delays: torch.Tensor):
    """The traffic model on a round's send side: (send mask, delays,
    traffic state').  Availability (the chain stepped with
    ``fold_in(key, AVAIL_SALT)``, non-AVAILABLE clients masked out), busy
    exclusion, the in-flight cap (senders past ``max_in_flight - |in
    flight|`` in worker order wait), then the arrival process's delays
    (``base_delays`` for "schedule")."""
    if thp is None:
        raise ValueError(
            "a TrafficModel needs its traced leaves: attach "
            "traffic_hparams(model) to the async hparams' traffic field")
    busy = buffer_busy(buf)
    if model.availability is not None:
        if tstate is None:
            raise ValueError(
                "an AvailabilityModel needs per-worker chain state: init "
                "with init_traffic_state(n) on the async state's traffic "
                "field")
        avail = availability_step(thp.avail_transition, tstate.avail,
                                  random.fold_in(key, AVAIL_SALT))
        tstate = TrafficState(avail)
        mask = mask * available_mask(avail)
    send = mask * (1.0 - busy)
    if model.admission is not None:
        room = torch.clamp(thp.max_in_flight - torch.sum(busy, dim=-1),
                           min=0.0)
        send = send * (torch.cumsum(send, dim=-1)
                       <= room.unsqueeze(-1)).to(torch.float32)
    kind = model.arrival.kind
    if kind == "schedule":
        delays = base_delays
    elif kind == "trace":
        delays = replay_delays(model.arrival.trace, k, torch.as_tensor(
            tau, device=key.device))
    else:
        delays = thinned_delays(thp.rate_table,
                                random.fold_in(key, ARRIVAL_SALT),
                                busy.shape[-1], k, tau,
                                buf.occupied.shape[-2])
    return send, delays, tstate


def admit_arrivals(model: Optional[TrafficModel],
                   thp: Optional[TrafficHParams], arrived: torch.Tensor,
                   msg_t: torch.Tensor, k: int) -> torch.Tensor:
    """The receive side's admission: arrivals older than
    ``staleness_cutoff`` rounds leave the arrival mask (drained, so their
    workers are free, but never billed or applied).  The identity without
    a model or an admission policy."""
    if model is None or model.admission is None:
        return arrived
    age = float(k) - msg_t
    cutoff = thp.staleness_cutoff
    cutoff = cutoff.unsqueeze(-1) if cutoff.dim() else cutoff
    return arrived * (age <= cutoff).to(torch.float32)


class Route(NamedTuple):
    """The routing half of an async round at every grid point.

    send, delays: [G, n]; tstate: the traffic state after the round;
    hit: [G, S, n] (where the round's messages go); occupied: the slots'
    occupancy after the send and the drain; slot: the slot drained (a
    host int); t_slots: the buffer's stamps after the send; msg_t,
    drained, arrived: the drained stamps, the drained slot's occupancy
    and the admitted arrival mask [G, n];
    flush: [G] bool, the FedBuff count reaching ``buffer_k`` this round;
    sends: numpy [G] bool, the points with a sender; arrives, flushes:
    whether any point receives or flushes; tau_zero: every point's tau
    is 0."""
    send: torch.Tensor
    delays: torch.Tensor
    tstate: Any
    hit: torch.Tensor
    occupied: torch.Tensor
    slot: int
    t_slots: torch.Tensor
    msg_t: torch.Tensor
    drained: torch.Tensor
    arrived: torch.Tensor
    flush: torch.Tensor
    sends: np.ndarray
    arrives: bool
    flushes: bool
    tau_zero: bool


def route_round(delay_kind: str, q: float, model: Optional[TrafficModel],
                ahp, state, keys: torch.Tensor,
                mask: torch.Tensor) -> Route:
    """Route round ``state.t`` of a batched async state: the delays
    (``fold_in(keys, ASYNC_SALT)``), the traffic model if any (else busy
    exclusion alone), the slots the messages go to, the drained slot's
    admitted arrivals and the FedBuff count, with one host read of the
    per-point flags.  The messages themselves are written by
    :func:`deliver` once computed."""
    t = state.t
    n = mask.shape[-1]
    base = sample_delays(delay_kind, random.fold_in(keys, ASYNC_SALT), n,
                         ahp.tau, q)
    if model is None:
        send = mask * (1.0 - buffer_busy(state.buf))
        delays, tstate = base, state.traffic
    else:
        send, delays, tstate = traffic_send(model, ahp.traffic,
                                            state.traffic, state.buf, mask,
                                            keys, t, ahp.tau, base)
    # the stamps and the occupancy, sent and drained; the messages
    # themselves are written by deliver
    buf = state.buf
    hit = buffer_hits(buf, send, delays, t)
    stamp = torch.full(send.shape, float(t), dtype=torch.float32,
                       device=send.device)
    sent = MessageBuffer({"t": blend(buf.slots["t"], hit, stamp)},
                         buf.occupied * (1.0 - hit) + hit)
    after, got, drained = buffer_receive(sent, t)
    msg_t = got["t"]
    arrived = admit_arrivals(model, ahp.traffic, drained, msg_t, t)
    flush = state.acc_n + torch.sum(arrived, dim=-1) >= ahp.buffer_k
    flags = torch.stack([torch.amax(send, dim=-1), torch.amax(arrived, dim=-1),
                         flush.to(torch.float32),
                         ahp.tau.to(torch.float32)]).cpu().numpy()
    return Route(send, delays, tstate, hit, after.occupied,
                 t % after.occupied.shape[-2], sent.slots["t"], msg_t,
                 drained, arrived, flush, flags[0] > 0,
                 bool((flags[1] > 0).any()), bool((flags[2] > 0).any()),
                 bool((flags[3] == 0).all()))


def gate(msgs: dict, route: Route) -> dict:
    """The round's messages as the reference's per-point compute gate
    leaves them: a point with no sender carries zeros (its branch was not
    taken), the others their computed values."""
    if route.sends.all():
        return msgs
    on = torch.as_tensor(route.sends, device=route.send.device)
    return {k: torch.where(on.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                           torch.zeros((), dtype=v.dtype, device=v.device))
            for k, v in msgs.items()}


def deliver(route: Route, buf: MessageBuffer, msgs: Optional[dict]):
    """Write the round's messages (a dict of [G, n, ...] without "t", or
    None where no point computed) into their slots: (buf', the drained
    slot's messages, "t" included)."""
    if msgs is not None:
        msgs = gate(msgs, route)
    slots = {name: route.t_slots if name == "t" else blend(
        cur, route.hit, None if msgs is None else msgs[name])
        for name, cur in buf.slots.items()}
    axis = route.occupied.dim() - 2
    msg = {name: a.select(axis, route.slot) for name, a in slots.items()}
    return MessageBuffer(slots, route.occupied), msg


def round_aux(route: Route, acc_n: torch.Tensor, flush: torch.Tensor,
              t: int, bits: torch.Tensor, g_norm: torch.Tensor,
              dir_norm=None) -> dict:
    """An async round's aux: the norms, the sends and admitted arrivals,
    the buffered count after the round, the flushes, the applied updates'
    mean age, the ledger."""
    aux = {"g_tilde_norm": g_norm}
    if dir_norm is not None:
        aux["dir_norm"] = dir_norm
    aux.update({"n_active": torch.sum(route.send, dim=-1),
                "n_arrived": torch.sum(route.arrived, dim=-1),
                "buffered": acc_n,
                "flushed": flush.to(torch.float32),
                "staleness_mean": applied_staleness(t, route.msg_t,
                                                    route.arrived),
                "bits_per_node": bits})
    return aux
