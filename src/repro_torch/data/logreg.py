"""Synthetic heterogeneous federated logistic regression (counterpart of
``repro.data.logreg``).

``make_problem`` is a copy of the reference's numpy generator, so the port's
data is identical by construction.  The worker oracles are batched over all
workers at once and closed-form:

    z_i = b_i ⊙ A_i w
    g_i = -(1/r) A_iᵀ (b_i ⊙ σ(-z_i)) + μ w
    Y_i = (1/r) A_iᵀ (σ(z_i) σ(-z_i) ⊙ A_i S) + μ S

The reference differentiates the same loss per worker with ``jax.grad`` and
``jax.jvp``: the formulas agree, the rounding does not (the tests state the
tolerance).

Loss (paper §5):  F(w) = (1/n) Σ_i (1/r) Σ_j log(1+exp(-b_ij a_ijᵀ w))
                  + (μ/2)||w||².
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FederatedLogReg:
    A: torch.Tensor           # [n, r, d] features per worker
    b: torch.Tensor           # [n, r]   labels in {-1, +1}
    mu: float                 # L2 regularization

    @property
    def n_workers(self):
        return self.A.shape[0]

    @property
    def d(self):
        return self.A.shape[2]

    def _margins(self, w):
        return self.b * torch.einsum("nrd,d->nr", self.A, w)

    def global_loss(self, w):
        z = self._margins(w)
        return (torch.mean(torch.logaddexp(torch.zeros_like(z), -z))
                + 0.5 * self.mu * (w @ w))

    def global_grad(self, w):
        z = self._margins(w)
        coef = -self.b * torch.sigmoid(-z) / z.numel()
        return torch.einsum("nrd,nr->d", self.A, coef) + self.mu * w

    def metrics(self, w):
        """Trace entries for ``driver.run_experiment(record=)``: the global
        objective and the squared gradient norm, left on the device."""
        return {"F": self.global_loss(w),
                "grad_sq": torch.sum(torch.square(self.global_grad(w)))}

    def make_oracles(self):
        """Returns ``(local_grad(w) -> [n, d], local_hvp(w, S) -> [n, d, m])``:
        full local gradients and Hessian-sketch products of every worker.
        (Minibatch oracles are a later slice of the port.)"""
        r = self.A.shape[1]

        def local_grad(w):
            z = self._margins(w)
            coef = self.b * torch.sigmoid(-z)
            return (-torch.einsum("nrd,nr->nd", self.A, coef) / r
                    + self.mu * w)

        def local_hvp(w, S):
            z = self._margins(w)
            wgt = torch.sigmoid(z) * torch.sigmoid(-z)          # [n, r]
            AS = torch.matmul(self.A, S)                        # [n, r, m]
            return (torch.matmul(self.A.transpose(1, 2),
                                 wgt[..., None] * AS) / r
                    + self.mu * S)

        return local_grad, local_hvp


def make_problem(d: int = 123, n_workers: int = 20, r: int = 64,
                 mu: float = 1e-3, heterogeneity: float = 1.0,
                 label_noise: float = 0.05, seed: int = 0,
                 device=None) -> FederatedLogReg:
    """The reference's generator (``repro.data.logreg.make_problem``),
    draw for draw, with the arrays placed on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d) / np.sqrt(d)
    shift = rng.normal(size=(n_workers, d)) * heterogeneity / np.sqrt(d)
    A = rng.normal(size=(n_workers, r, d)) / np.sqrt(d) + shift[:, None, :]
    logits = A @ w_true
    p = 1.0 / (1.0 + np.exp(-logits))
    b = np.where(rng.uniform(size=p.shape) < p, 1.0, -1.0)
    flip = rng.uniform(size=b.shape) < label_noise
    b = np.where(flip, -b, b)
    return FederatedLogReg(
        torch.as_tensor(A.astype(np.float32), device=dev),
        torch.as_tensor(b.astype(np.float32), device=dev), mu)
