"""First-order optimizers (counterpart of ``repro.optim.optimizers``).

Each optimizer is a pair of functions bundled in an ``Optimizer``:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
new_state)``, where ``updates`` are to be ADDED to params (sign included).
Trees are the port's nested dicts and lists of tensors; the update is
functional, as the reference's: new tensors, nothing changed in place.

The scalars follow the reference's float32 arithmetic: the step count ``t``
is an int32 tensor, and adam's bias corrections ``1 - b ** t`` are taken in
float32 (a Python float64 power drifts from the reference's), with the
update divided in the reference's order, ``m / bc1 / (sqrt(v / bc2) +
eps)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]


def _cast_like(x, ref):
    return x.to(ref.dtype)


def _device(params):
    return tree_leaves(params)[0].device


def _f32(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def sgd(lr: float):
    def init(params):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g, p: _cast_like(-lr * g, p), grads, params), ()

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9):
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        new_m = tree_map(lambda m, g: beta * m + g.to(m.dtype), state, grads)
        upd = tree_map(lambda m, p: _cast_like(-lr * m, p), new_m, params)
        return upd, new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0):
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}

    def update(grads, state, params):
        t = state["t"] + 1
        dev = t.device
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"],
                     grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        bc1 = 1 - _f32(b1, dev) ** t.float()
        bc2 = 1 - _f32(b2, dev) ** t.float()

        def upd(m, v, p):
            step = m / bc1 / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return _cast_like(-lr * step, p)

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adafactor(lr: float, eps: float = 1e-30, clip: float = 1.0,
              decay: float = 0.8):
    """Memory-factored RMS optimizer (Shazeer & Stern).  The second moment
    is factored over the last two dims of tensors with ndim >= 2."""

    def init(params):
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"r": torch.zeros(p.shape[:-1], **f32),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"s": tree_map(leaf, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}

    def update(grads, state, params):
        t = state["t"] + 1
        beta = 1.0 - (t.float() + 1.0) ** (-decay)

        def leaf(p, g, s):
            g = g.float()
            g2 = torch.square(g) + eps
            if p.dim() >= 2:
                r = beta * s["r"] + (1 - beta) * g2.mean(dim=-1)
                c = beta * s["c"] + (1 - beta) * g2.mean(dim=-2)
                rc = r.mean(dim=-1, keepdim=True)
                vhat = (r[..., None] / torch.clamp(rc[..., None], min=eps)
                        ) * c[..., None, :]
                u = g * torch.rsqrt(torch.clamp(vhat, min=eps))
                new_s = {"r": r, "c": c}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                new_s = {"v": v}
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip, min=1.0)
            return _cast_like(-lr * u, p), new_s

        # tree_map walks the params' structure: at each param its state is
        # the {"r", "c"} or {"v"} dict, and the result a pair
        pairs = tree_map(leaf, params, grads, state["s"])
        upd = tree_map(lambda p, pair: pair[0], params, pairs)
        new_s = tree_map(lambda p, pair: pair[1], params, pairs)
        return upd, {"s": new_s, "t": t}

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam,
              "adafactor": adafactor}


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    return OPTIMIZERS[name](lr, **kw)
