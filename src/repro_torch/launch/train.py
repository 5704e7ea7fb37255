"""Training on one card: the standard trainer or FLECS-CGD (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --flecs
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --flecs \\
        --workers 4
    PYTHONPATH=src python -m repro_torch.launch.train --no-smoke \\
        --batch 8 --seq 1024 --steps 5 [--flecs]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch musicgen-large --steps 1 [--flecs]
    PYTHONPATH=src python -m repro_torch.launch.train --no-smoke \\
        --arch gemma2-9b --layers 2 --batch 8 --seq 1024 --steps 3 [--flecs]

As in the reference's launcher: float32 weights drawn from key ``--seed``
(0) by the reference's key tree, ``remat`` on, a synthetic token stream
from ``numpy.random.default_rng(--seed)`` (a fresh batch a step, the first
draw spent on shapes as the reference spends it) in the shapes of
``launch/inputs.input_specs``, as the reference's dryrun takes them for
every family (codebook tokens ``[B, S, C]``, a VLM's image embeds), adam
at lr 3e-3, and FLECS-CGD with ``alpha = 30 · lr`` and m = 0.  ``--smoke``
(the default, as in the reference, whose flag cannot be turned off) runs
the reduced config; ``--no-smoke`` the full width, and ``--layers N``
keeps its first N layers.  ``--checkpoint DIR`` saves the last params
there (``checkpoint/store.py``, the reference's format) with step
``--steps``.  There is no mesh: ``--mesh debug`` is the
one device, and ``--workers N`` (with ``--flecs``) runs N federated
workers on it, each on its block of the batch, the counterpart of the
reference's debug mesh data axis (forced host devices); the model axis
inside a worker is not ported.  Prints loss and grad norm every 5 steps and at the last, with
the step's time (host clock around a synchronize) and, on the card, the
peak memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.dl_flecs import (FlecsDLConfig, init_shifts,
                                       make_flecs_train_step)
from repro_torch.device import resolve_device
from repro_torch.launch import inputs
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

def setup(arch="tinyllama-1.1b", smoke=True, device=None, n_layers=0,
          seed=0):
    """(cfg, float32 params on ``device``).  ``n_layers`` > 0 keeps only
    the first n layers of the plan (depth cut, every width intact)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  layer_plan=cfg.layer_plan[:n_layers])
    return cfg, init_params(cfg, random.key(seed, dev), torch.float32)


def token_batches(cfg, batch: int, seq: int, device, seed=0):
    """The launcher's synthetic stream, a batch a draw in the shapes and
    dtypes of ``inputs.input_specs`` (kind ``train``) on ``device``:
    "tokens" and "labels" [batch, seq] (or [batch, seq, C] for the audio
    codebooks), labels the tokens shifted by one along the sequence; a
    VLM's "image_embeds" [batch, min(n_img_tokens, seq), d_model], standard
    normal, drawn from the same generator after the tokens.  A family
    without codebooks or image embeds draws [batch, seq + 1] a batch, as
    the launcher always has."""
    specs = inputs.input_specs(cfg, InputShape("train", seq, batch,
                                               "train"))
    shape, dtype = specs["tokens"]
    rng = np.random.default_rng(seed)
    while True:
        t = torch.as_tensor(rng.integers(
            0, cfg.vocab, (shape[0], shape[1] + 1, *shape[2:]))).to(dtype)
        out = {"tokens": t[:, :-1].to(device), "labels": t[:, 1:].to(device)}
        if "image_embeds" in specs:
            (B, n, D), img_dtype = specs["image_embeds"]
            img = rng.normal(size=(B, min(n, seq), D)).astype(np.float32)
            out["image_embeds"] = torch.as_tensor(img).to(device, img_dtype)
        yield out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, params, batches, steps: int, *, flecs=False,
          optimizer="adam", lr=3e-3, microbatches=1, workers=1, log=None):
    """``steps`` steps of the standard trainer (``optimizer``) or of
    FLECS-CGD (alpha = 30 · lr, m = 0, ``workers`` federated workers in
    this process) from ``params``, one batch of the iterator ``batches`` a
    step, with remat on, as the reference's launcher runs them.  ``params``
    is not changed.

    Returns a dict: ``params`` (the last), ``state`` (optimizer state or
    shifts), ``metrics`` (a list of each step's metrics as floats), and
    ``step_ms`` (each step's time, host clock around work that ends in a
    synchronize)."""
    dev = tree_leaves(params)[0].device
    if flecs:
        step = make_flecs_train_step(cfg, FlecsDLConfig(alpha=lr * 30),
                                     remat=True, n_workers=workers)
        state = init_shifts(params, workers)
    elif workers != 1:
        raise ValueError("workers: more than one worker needs flecs")
    else:
        opt = get_optimizer(optimizer, lr)
        step_fn = make_train_step(cfg, opt, microbatches=microbatches,
                                  remat=True)
        state = opt.init(params)

        def step(p, s, b, i):
            return step_fn(p, s, b)
    history, step_ms = [], []
    for i in range(steps):
        batch = next(batches)
        _sync(dev)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, i)
        _sync(dev)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        history.append({k: float(v) for k, v in m.items()})
        if log and (i % 5 == 0 or i == steps - 1):
            peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
                    f" GiB" if dev.type == "cuda" else "")
            log(f"step {i:4d} loss {history[-1]['loss']:.4f} gnorm "
                f"{history[-1]['grad_norm']:.3f} ({step_ms[-1]:.1f} ms"
                f"{peak})")
    return {"params": params, "state": state, "metrics": history,
            "step_ms": step_ms}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (0: all)")
    ap.add_argument("--mesh", choices=["debug"], default="debug",
                    help="one device; the production meshes need the "
                         "sharded slice")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--flecs", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="FLECS-CGD's federated workers (with --flecs)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights key and token stream seed")
    args = ap.parse_args(argv)

    cfg, params = setup(args.arch, args.smoke, args.device,
                        n_layers=args.layers, seed=args.seed)
    dev = tree_leaves(params)[0].device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if args.workers != 1 and not args.flecs:
        ap.error("--workers needs --flecs")
    mode = (f"FLECS-CGD (m = 0, {args.workers} workers)" if args.flecs
            else f"{args.optimizer} x{args.microbatches} microbatches")
    print(f"{cfg.arch_id} on {where}: {mode}, batch {args.batch} x "
          f"{args.seq}")
    batches = token_batches(cfg, args.batch, args.seq, dev, args.seed)
    next(batches)      # the reference's launcher spends its first draw
    out = train(cfg, params, batches, args.steps, flecs=args.flecs,
                optimizer=args.optimizer, lr=args.lr,
                microbatches=args.microbatches, workers=args.workers,
                log=print)
    if args.flecs:
        print(f"uplink {out['metrics'][-1]['uplink_mbits']:.3f} Mbit a step")
    if args.checkpoint:
        store.save(args.checkpoint, out["params"], step=args.steps)
        print("saved", args.checkpoint)
    return out


if __name__ == "__main__":
    main()
