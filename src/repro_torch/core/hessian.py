"""Sketched Hessians without materialising the Hessian (counterpart of
``repro.core.hessian``).

Y = ∇²f(w) S through m Hessian-vector products, hvp(v) = d/dt ∇f(w + t v)
at t = 0: forward over reverse, as the reference's ``jax.jvp`` of
``jax.grad``.  Here the parameters are ``torch.autograd.forward_ad`` dual
tensors (primal w, tangent v) around ``torch.autograd.grad``: the gradient
comes out as a dual whose tangent is ∇²f(w) v.  Not ``torch.func``: its
transforms refuse the saved-tensor hooks of ``torch.utils.checkpoint``, so
remat would not run under them, while dual tensors pass through it.  On the
card the attention kernels carry the tangents themselves
(``kernels/flash_attention/ops.py``); a dual that would reach any other
kernel raises.  The reference's ``vmap`` over the sketch's columns is a
loop here.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


def _hvp_leaves(loss_fn, leaves, tangents, rebuild, args):
    with fwAD.dual_level():
        live = [p.detach().requires_grad_(True) for p in leaves]
        duals = [fwAD.make_dual(p, t.to(p.dtype))
                 for p, t in zip(live, tangents)]
        loss = loss_fn(rebuild(duals), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        out = []
        for g, p in zip(grads, live):
            t = None if g is None else fwAD.unpack_dual(g).tangent
            out.append(torch.zeros_like(p) if t is None else t.detach())
    return out


def hvp(loss_fn, w, v, *args):
    """∇²f(w) · v for a flat w.  loss_fn: (w, *args) -> scalar."""
    return _hvp_leaves(loss_fn, [w], [v], lambda d: d[0], args)[0]


def sketched_hessian(loss_fn, w, S, *args):
    """Y = ∇²f(w) S — S: [d, m]; returns [d, m], one HVP a column."""
    cols = [hvp(loss_fn, w, S[:, j], *args) for j in range(S.shape[1])]
    return torch.stack(cols, dim=1)


def hvp_pytree(loss_fn, params, v_tree, *args):
    """HVP for tree params (the DL-scale path): v_tree matches params;
    returns a tree like params."""
    leaves, treedef = tree_flatten(params)
    out = _hvp_leaves(loss_fn, leaves, tree_leaves(v_tree),
                      lambda d: tree_unflatten(treedef, d), args)
    return tree_unflatten(treedef, out)
