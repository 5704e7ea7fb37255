"""End-to-end LM training driver with the FLECS-CGD trainer (counterpart of
``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.train_lm --smoke --steps 50 --flecs \\
        --device cpu                            # CPU-sized demo
    PYTHONPATH=src python -m repro_torch.train_lm --flecs --flecs-m 2 \\
        --steps 3                               # tinyllama-1.1b on the card
    PYTHONPATH=src python -m repro_torch.train_lm --preset 100m --steps 300

As in the example: float32 weights from key 0, a synthetic power-law token
stream from ``numpy.random.default_rng(0)`` with each of 4 workers'
distribution shifted (``token_stream``: the example's tokens), adam at
``--lr``, or with ``--flecs`` FLECS-CGD at ``alpha = 10 · lr`` with
``--flecs-m`` sketch columns (0 = first order; m > 0 the sketched-Hessian
preconditioner, Hessian-vector products through the attention kernels on
the card), one worker; FLECS-CGD spends the stream's first batch on shapes
as the example does.  ``--checkpoint DIR`` saves the last params there
(``checkpoint/store.py``, the reference's format) with step ``--steps``.
Runs on the card unless ``--device cpu``; ``--remat`` recomputes each
layer's activations in the backward (off, as the example's context).
Prints the loss and the mean seconds a step so far every 10 steps and at
the last.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.base import (ATTN_GLOBAL, FFN_DENSE, ModelConfig,
                                      uniform_plan)
from repro_torch.core.dl_flecs import (FlecsDLConfig, init_shifts,
                                       make_flecs_train_step)
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves


def preset_100m() -> ModelConfig:
    return ModelConfig(
        arch_id="preset-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32000,
        layer_plan=uniform_plan(12, ATTN_GLOBAL, FFN_DENSE),
        source="example driver")


def token_stream(cfg, rng, batch, seq, n_workers=4, device="cpu"):
    """Power-law unigram stream; each worker's distribution is shifted.
    Yields {"tokens", "labels"} int64 [batch, seq] on ``device``: the
    example's tokens, drawn by the same numpy calls."""
    V = cfg.vocab
    base = 1.0 / (np.arange(1, V + 1) ** 1.1)
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        for b in range(batch):
            w = b % n_workers
            p = np.roll(base, w * (V // max(n_workers, 1) // 8))
            p = p / p.sum()
            toks[b] = rng.choice(V, size=seq + 1, p=p)
        t = torch.as_tensor(toks.astype(np.int64), device=device)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", choices=["100m"], default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--flecs", action="store_true",
                    help="FLECS-CGD compressed-difference trainer")
    ap.add_argument("--flecs-m", type=int, default=0,
                    help="sketched-Hessian columns (0 = first-order CGD)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=False)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.preset == "100m":
        cfg = preset_100m()
    else:
        cfg = get_config(args.arch or "tinyllama-1.1b", smoke=args.smoke)
    params = init_params(cfg, random.key(0, dev), torch.float32)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.arch_id} params≈{n_params / 1e6:.1f}M on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    stream = token_stream(cfg, np.random.default_rng(0), args.batch,
                          args.seq, device=dev)

    if args.flecs:
        fcfg = FlecsDLConfig(alpha=args.lr * 10, m=args.flecs_m)
        next(stream)          # the example spends a batch on shapes
        step = make_flecs_train_step(cfg, fcfg, remat=args.remat)
        state = init_shifts(params)
    else:
        opt = get_optimizer("adam", args.lr)
        adam_step = make_train_step(cfg, opt, remat=args.remat)
        state = opt.init(params)

        def step(p, s, b, i):
            return adam_step(p, s, b)
    history = []
    _sync(dev)
    t0 = time.time()
    for step_i in range(args.steps):
        batch = next(stream)
        params, state, metrics = step(params, state, batch, step_i)
        history.append({k: float(v) for k, v in metrics.items()})
        if step_i % 10 == 0 or step_i == args.steps - 1:
            _sync(dev)
            print(f"step {step_i:4d} loss {history[-1]['loss']:.4f} "
                  f"({(time.time() - t0) / (step_i + 1):.2f}s/step)")

    if args.checkpoint:
        store.save(args.checkpoint, params, step=args.steps)
        print(f"checkpoint saved to {args.checkpoint}")
    return {"params": params, "state": state, "metrics": history}


if __name__ == "__main__":
    main()
