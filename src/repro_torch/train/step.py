"""Train and serve step factories (counterpart of ``repro.train.step``).

The reference's ``ctx`` (mesh, data axes, ``remat``) has no counterpart on
one card but ``remat``, which is passed on its own.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.loss import lm_loss
from repro_torch.models.model import decode_step, forward, prefill
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


def _loss_fn(params, batch, cfg: ModelConfig, remat: bool = False):
    hidden, aux = forward(params, batch, cfg, remat=remat)
    mask = None
    if cfg.family == "vlm":                      # loss on text positions only
        S = hidden.shape[1]
        text = torch.arange(S, device=hidden.device) >= cfg.n_img_tokens
        mask = text[None, :].float().expand(hidden.shape[:2])
    loss = lm_loss(params, hidden, batch["labels"], cfg, mask=mask)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss


def value_and_grad(params, batch, cfg: ModelConfig, remat: bool = False):
    """(loss, gradients of the loss by every parameter leaf), as
    ``jax.value_and_grad(_loss_fn)``: the gradients are a tree like
    ``params``."""
    leaves, treedef = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = _loss_fn(tree_unflatten(treedef, live), batch, cfg, remat)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    microbatches: int = 1, remat: bool = False):
    """Standard training step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  With ``microbatches`` > 1 the batch rows are
    split into that many microbatches whose gradients are summed in float32
    and averaged, which keeps a step's activation memory at 1/microbatches
    (the reference's ``lax.scan`` is a loop here)."""

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch, cfg, remat)
        else:
            def split(x, i):
                return x.reshape(microbatches, x.shape[0] // microbatches,
                                 *x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                mb = tree_map(lambda x: split(x, i), batch)
                l, g = value_and_grad(params, mb, cfg, remat)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = tree_map(lambda p, u: p + u.to(p.dtype), params,
                              updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int = 0):
    """(params, batch) -> (last logits [B, 1, V], cache)."""

    def prefill_step(params, batch):
        return prefill(params, batch, cfg, max_len=max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, batch, pos) -> (logits, cache); the
    cache is updated in place."""

    def serve_step(params, cache, batch, pos: int):
        return decode_step(params, cache, batch, pos, cfg)

    return serve_step
