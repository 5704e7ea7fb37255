"""Carry the JAX reference's data and state into the port.

The arguments are numpy arrays (``np.asarray`` of the reference's leaves,
and ``jax.random.key_data`` for a key), so this module needs no JAX.  The
tests use it to run both packages from the same state.  A state whose
``k`` has a leading [G] axis (a reference sweep's) converts to the port's
batched state (``driver.batch_state``'s layout).  The async states carry
their buffers (``MessageBuffer`` slots [S, n, ...], or [G, S, n, ...] from
a sweep: the reference's vmapped layout is the port's), FedBuff sums and
traffic state, the async hparams their tau, buffer_k and traffic numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compressors import (CompressorSpec, SketchParams,
                                          default_sketch_params, grid_spec)
from repro_torch.core.driver import MessageBuffer
from repro_torch.core.flecs import (FlecsAsyncHParams, FlecsCohortState,
                                    FlecsHParams, FlecsState)
from repro_torch.core.traffic import TrafficHParams, TrafficState
from repro_torch.data.logreg import FederatedLogReg
from repro_torch.device import resolve_device
from repro_torch.optim.baselines import (DianaAsyncHParams, DianaHParams,
                                         DianaState, FedNLAsyncHParams,
                                         FedNLHParams, FedNLState,
                                         GDAsyncHParams, GDHParams, GDState)


def key_from_reference(key_data, device=None) -> torch.Tensor:
    """A reference key's uint32 words (``jax.random.key_data(key)``, shape
    [..., 2]) as the port's int64 key tensor."""
    words = np.asarray(key_data, dtype=np.uint32).astype(np.int64)
    return torch.as_tensor(words, device=resolve_device(device))


def problem_from_reference(A, b, mu, device=None) -> FederatedLogReg:
    """``FederatedLogReg`` from the reference problem's A [n, r, d],
    b [n, r] and mu."""
    dev = resolve_device(device)
    return FederatedLogReg(
        torch.as_tensor(np.array(A, np.float32), device=dev),
        torch.as_tensor(np.array(b, np.float32), device=dev), float(mu))


def _leaf(a, dev) -> torch.Tensor:
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, dev) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_tree(v, dev) for v in tree)
    return _leaf(tree, dev)


def params_from_reference(tree, device=None):
    """A reference pytree (nested dicts, lists and tuples of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as the port keeps it: the
    same structure, shapes and dtypes (bf16 bits carried), on ``device``.
    The parameters, an optimizer's state (adam's {"m", "v", "t"}, sgd's
    ()) and the FLECS-CGD shifts ({"own", "mean"}) all convert so."""
    return _tree(tree, resolve_device(device))


#: The same conversion, named for the optimizer state and the shifts.
opt_state_from_reference = params_from_reference
shifts_from_reference = params_from_reference


def _state(cls, leaves: dict, k, device):
    """``cls`` from float32 leaves and the counter k: an int, or for a
    batched state an int32 [G] tensor (and ``t``, the round of the live
    points, where the state has one)."""
    dev = resolve_device(device)
    fields = {name: torch.as_tensor(np.array(a, np.float32), device=dev)
              for name, a in leaves.items() if a is not None}
    k = np.asarray(k)
    if k.ndim == 0:
        fields["k"] = int(k)
    else:
        fields["k"] = torch.as_tensor(k.astype(np.int32), device=dev)
        if "t" in cls._fields:
            fields["t"] = int(k.max())
    return cls(**fields)


def state_from_reference(w, h, B, k, bits_per_node, edge_bits=None,
                         device=None) -> FlecsState:
    """``FlecsState`` from the reference ``FlecsState``'s leaves (its
    backhaul ledger ``edge_bits`` where the state has one)."""
    return _state(FlecsState, dict(w=w, h=h, B=B, bits_per_node=bits_per_node,
                                   edge_bits=edge_bits), k, device)


def cohort_state_from_reference(w, h, B, k, bits_per_node, edge_bits=None,
                                device=None) -> FlecsCohortState:
    """``FlecsCohortState`` (the [N, d] shift table, the shared [d, d]
    curvature, the [N] ledger) from the reference's leaves."""
    return _state(FlecsCohortState, dict(w=w, h=h, B=B,
                                         bits_per_node=bits_per_node,
                                         edge_bits=edge_bits), k, device)


def diana_state_from_reference(w, h, k, bits_per_node,
                               device=None) -> DianaState:
    """``DianaState`` from the reference ``DianaState``'s leaves."""
    return _state(DianaState, dict(w=w, h=h, bits_per_node=bits_per_node),
                  k, device)


def fednl_state_from_reference(w, H, k, bits_per_node,
                               device=None) -> FedNLState:
    """``FedNLState`` from the reference ``FedNLState``'s leaves."""
    return _state(FedNLState, dict(w=w, H=H, bits_per_node=bits_per_node),
                  k, device)


def gd_state_from_reference(w, k, bits_per_node, device=None) -> GDState:
    """``GDState`` from the reference ``GDState``'s leaves."""
    return _state(GDState, dict(w=w, bits_per_node=bits_per_node), k,
                  device)


def spec_from_reference(spec, device=None) -> CompressorSpec:
    """A reference ``CompressorSpec`` (numpy leaves: family, s, frac and
    the sketch params, which may be absent): a scalar spec, or a grid spec
    for [G] leaves, families mixed freely."""
    family = np.asarray(spec.family)
    params = getattr(spec, "params", None)
    if params is not None:
        params = SketchParams(*(np.asarray(v, np.float32) for v in params))
    if family.ndim == 0:
        return CompressorSpec(
            int(family), float(np.float32(spec.s)),
            float(np.float32(spec.frac)),
            params=(default_sketch_params() if params is None
                    else SketchParams(*(float(v) for v in params))))
    return grid_spec(family.tolist(), np.asarray(spec.s, np.float32),
                     np.asarray(spec.frac, np.float32),
                     resolve_device(device), params)


def hparams_from_reference(cls, hp, device=None):
    """The port's hparams ``cls`` (``FlecsHParams``, ``DianaHParams``, ...)
    from a reference hparams tuple of numpy leaves: each field of ``cls``
    read by name, specs through :func:`spec_from_reference`, [G] leaves as
    float32 tensors, scalars as floats."""
    dev = resolve_device(device)

    def leaf(v):
        if v is None:
            return None
        if hasattr(v, "family"):
            return spec_from_reference(v, dev)
        a = np.asarray(v, np.float32)
        return float(a) if a.ndim == 0 else torch.as_tensor(a, device=dev)

    return cls(**{name: leaf(getattr(hp, name, None))
                  for name in cls._fields})


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=dev)


def async_state_from_reference(cls, state, device=None):
    """An async state ``cls`` (``FlecsAsyncState``, ``DianaAsyncState``,
    ``FedNLAsyncState``, ``GDAsyncState``) from the reference's state of
    the same name with numpy leaves (``jax.tree.map(np.asarray, st)``):
    its buffer's slots and occupancy, FedBuff sums and count, ledger,
    iterate, k (and the host round ``t``), and the availability chain's
    states (int64) where the state has them."""
    dev = resolve_device(device)
    k = np.asarray(state.k)
    fields = {}
    for name in cls._fields:
        if name == "t":
            fields[name] = int(k.max())
        elif name == "k":
            fields[name] = (int(k) if k.ndim == 0 else torch.as_tensor(
                k.astype(np.int32), device=dev))
        elif name == "buf":
            buf = state.buf
            fields[name] = MessageBuffer(
                {key: _f32(v, dev) for key, v in buf.slots.items()},
                _f32(buf.occupied, dev))
        elif name == "traffic":
            tr = getattr(state, "traffic", None)
            fields[name] = None if tr is None else TrafficState(
                torch.as_tensor(np.asarray(tr.avail).astype(np.int64),
                                device=dev))
        else:
            fields[name] = _f32(getattr(state, name), dev)
    return cls(**fields)


#: The sync hparams inside each async hparams class.
_SYNC_HPARAMS = {FlecsAsyncHParams: FlecsHParams,
                 DianaAsyncHParams: DianaHParams,
                 FedNLAsyncHParams: FedNLHParams,
                 GDAsyncHParams: GDHParams}

def traffic_hparams_from_reference(thp, device=None) -> TrafficHParams:
    """``TrafficHParams`` from the reference's (numpy leaves)."""
    dev = resolve_device(device)
    return TrafficHParams(*(_f32(v, dev) for v in thp))


def async_hparams_from_reference(cls, ahp, device=None):
    """The port's async hparams ``cls`` from the reference's (numpy
    leaves): the sync hparams through :func:`hparams_from_reference`, tau
    as int32 and buffer_k as float32 tensors, the traffic numbers (or
    None)."""
    dev = resolve_device(device)
    thp = getattr(ahp, "traffic", None)
    return cls(
        hparams_from_reference(_SYNC_HPARAMS[cls], ahp.hp, dev),
        torch.as_tensor(np.asarray(ahp.tau).astype(np.int32), device=dev),
        _f32(ahp.buffer_k, dev),
        None if thp is None else traffic_hparams_from_reference(thp, dev))
