"""Quickstart: FLECS-CGD on a federated logistic-regression problem
(counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.quickstart --device cuda
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu \\
        --hess topk0.1 --iters 51

Runs the paper's Algorithm 1 (FedSONIA direction, direct Hessian update,
random-dithering compression) on the synthetic heterogeneous federation
and prints objective / gradient norm / communicated bits per node.  At the
defaults it is the reference quickstart's run: same data, same key stream.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import random
from repro_torch.core.driver import run_experiment
from repro_torch.core.flecs import FlecsConfig, init_state, make_flecs_step
from repro_torch.data.logreg import make_problem
from repro_torch.device import resolve_device


#: The stochastic setting's knobs as the reference tests it: minibatch
#: oracles of 32 rows a worker, exact-k sampling of half the workers, and
#: the step size of its Theorem-4 test (tests/test_flecs_convergence.py;
#: alpha 1 diverges there).
STOCHASTIC = dict(batch=32, participation=0.5, sampling="choice", alpha=0.2)


def setup(d: int = 123, n_workers: int = 20, r: int = 64, m: int = 4,
          grad: str = "dither64", hess: str = "dither64", seed: int = 0,
          batch: int = 0, participation: float = 1.0,
          sampling: str = "bernoulli", sketch: str = "rademacher",
          alpha: float = 1.0, device=None):
    """The quickstart's pieces: (problem, step, initial state w = 0, key
    ``key(seed)``), all on ``device``.  ``batch`` > 0 takes minibatch
    oracles of that many rows a worker."""
    dev = resolve_device(device)
    prob = make_problem(d=d, n_workers=n_workers, r=r, mu=1e-3, seed=seed,
                        device=dev)
    cfg = FlecsConfig(m=m, grad_compressor=grad, hess_compressor=hess,
                      alpha=alpha, beta=1.0, gamma=1.0,
                      participation=participation, sampling=sampling,
                      sketch_kind=sketch)
    step = make_flecs_step(cfg, *prob.make_oracles(batch))
    state = init_state(torch.zeros(prob.d, device=dev), prob.n_workers)
    return prob, step, state, random.key(seed, dev)


def run(iters: int = 201, record: bool = True, **setup_kw):
    """Run ``iters`` rounds of the :func:`setup` pieces; returns (problem,
    final state, traces).  With ``record`` the traces hold F and grad_sq
    after every round."""
    prob, step, state, key = setup(**setup_kw)
    state, tr = run_experiment(step, state, key, iters,
                               record=(lambda st: prob.metrics(st.w))
                               if record else None)
    return prob, state, tr


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--grad", default="dither64",
                    help="gradient compressor ('identity' is plain FLECS)")
    ap.add_argument("--hess", default="dither64",
                    help="Hessian compressor, e.g. dither64 or topk0.1")
    ap.add_argument("--d", type=int, default=123)
    ap.add_argument("--workers", type=int, default=20)
    ap.add_argument("--r", type=int, default=64)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--iters", type=int, default=201)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    _, _, tr = run(args.iters, d=args.d, n_workers=args.workers, r=args.r,
                   m=args.m, grad=args.grad, hess=args.hess, seed=args.seed,
                   device=args.device)
    F = tr["F"].cpu().numpy()
    g = tr["grad_sq"].sqrt().cpu().numpy()
    kbits = tr["bits_per_node"].amax(dim=1).cpu().numpy() / 1e3
    print(f"{'iter':>5s} {'F(w)':>10s} {'||grad||':>10s} {'kbits/node':>11s}")
    for k in range(0, args.iters, 25):
        print(f"{k:5d} {F[k]:10.6f} {g[k]:10.2e} {kbits[k]:11.1f}")


if __name__ == "__main__":
    main()
