"""Run Algorithm 1 in the JAX reference and in the PyTorch port side by side
on the CPU and print the objective of both after every round.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_vs_reference.py \\
        --d 1000 --r 60 --iters 10 --hess dither64

Same problem (``make_problem`` draws), same key stream, same config
(m=4, n=20, alpha=beta=gamma=1); the ledgers must match exactly and the
objectives closely.  Keep d small: exact mode holds n·d² floats of
curvature per copy.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import driver as jdr
from repro.core import flecs as jf
from repro.data import logreg as jl
from repro_torch import random as tr
from repro_torch.core import driver as tdr
from repro_torch.core import flecs as tf
from repro_torch.data import logreg as tl


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=123)
    ap.add_argument("--workers", type=int, default=20)
    ap.add_argument("--r", type=int, default=64)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--hess", default="dither64")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    kw = dict(d=args.d, n_workers=args.workers, r=args.r, seed=args.seed)
    cfg = dict(m=args.m, hess_compressor=args.hess)

    jp = jl.make_problem(**kw)
    _, want = jdr.run_experiment(
        jf.make_flecs_step(jf.FlecsConfig(**cfg), *jp.make_oracles()),
        jf.init_state(jnp.zeros(args.d), args.workers),
        jax.random.key(args.seed), args.iters,
        record=lambda st: jp.metrics(st.w))
    tp = tl.make_problem(device="cpu", **kw)
    _, got = tdr.run_experiment(
        tf.make_flecs_step(tf.FlecsConfig(**cfg), *tp.make_oracles()),
        tf.init_state(torch.zeros(args.d), args.workers),
        tr.key(args.seed, "cpu"), args.iters,
        record=lambda st: tp.metrics(st.w))
    same = np.array_equal(np.asarray(want["bits_per_node"]),
                          got["bits_per_node"].numpy())
    print(f"ledgers equal every round: {same}")
    print(f"{'round':>5s} {'F reference':>16s} {'F port':>16s} {'rel diff':>10s}")
    for k, (a, b) in enumerate(zip(np.asarray(want["F"]), got["F"].numpy())):
        print(f"{k:5d} {float(a):16.9g} {float(b):16.9g} "
              f"{abs(float(b) / float(a) - 1):10.3g}")


if __name__ == "__main__":
    main()
