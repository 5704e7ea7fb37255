"""Carry the JAX reference's data and state into the port.

The arguments are numpy arrays (``np.asarray`` of the reference's leaves,
and ``jax.random.key_data`` for a key), so this module needs no JAX.  The
tests use it to run both packages from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flecs import FlecsState
from repro_torch.data.logreg import FederatedLogReg
from repro_torch.device import resolve_device


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


def state_from_reference(w, h, B, k, bits_per_node,
                         device=None) -> FlecsState:
    """``FlecsState`` from the reference ``FlecsState``'s leaves."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    return FlecsState(tensor(w), tensor(h), tensor(B), int(np.asarray(k)),
                      tensor(bits_per_node))
