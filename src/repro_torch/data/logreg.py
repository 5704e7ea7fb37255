"""Synthetic heterogeneous federated logistic regression (counterpart of
``repro.data.logreg``).

``make_problem`` is a copy of the reference's numpy generator, so the port's
data is identical by construction.  The worker oracles are batched over all
workers at once, and over a grid of iterates w [G, d] where a sweep runs
(the results then lead with [G]), and closed-form, over each worker's r
rows or, for the minibatch oracles, its B sampled rows:

    z_i = b_i ⊙ A_i w
    g_i = -(1/r) A_iᵀ (b_i ⊙ σ(-z_i)) + μ w
    Y_i = (1/r) A_iᵀ (σ(z_i) σ(-z_i) ⊙ A_i S) + μ S
    H_i = (1/r) A_iᵀ diag(σ(z_i) σ(-z_i)) A_i + μ I      (FedNL)

The reference differentiates the same loss per worker with ``jax.grad``,
``jax.jvp`` and ``jax.hessian``: the formulas agree, the rounding does not
(the tests state the tolerance).

Loss (paper §5):  F(w) = (1/n) Σ_i (1/r) Σ_j log(1+exp(-b_ij a_ijᵀ w))
                  + (μ/2)||w||².
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random
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
        """z [..., n, r] for w [..., d]."""
        return self.b * torch.einsum("nrd,...d->...nr", self.A, w)

    def global_loss(self, w):
        """F(w) for w [d] (0-d) or a grid w [G, d] ([G])."""
        z = self._margins(w)
        return (torch.mean(torch.logaddexp(torch.zeros_like(z), -z),
                           dim=(-2, -1))
                + 0.5 * self.mu * torch.sum(w * w, dim=-1))

    def global_grad(self, w):
        z = self._margins(w)
        coef = -self.b * torch.sigmoid(-z) / (z.shape[-1] * z.shape[-2])
        return (torch.einsum("nrd,...nr->...d", self.A, coef)
                + self.mu * w)

    def metrics(self, w):
        """Trace entries for ``driver.run_experiment(record=)`` (w [d]) and
        the sweeps (w [G, d]): the global objective and the squared
        gradient norm, left on the device."""
        return {"F": self.global_loss(w),
                "grad_sq": torch.sum(torch.square(self.global_grad(w)),
                                     dim=-1)}

    def make_oracles(self, batch: int = 0):
        """Returns ``(local_grad, local_hvp)`` for w [..., d]: every
        worker's gradient [..., n, d] and Hessian-sketch product
        [..., n, d, m] (of every grid point).

        batch=0: full local batches, ``local_grad(w)`` and
        ``local_hvp(w, S)``.  batch=B: minibatch oracles, the stochastic
        setting of Theorems 4/5: ``local_grad(w, keys)`` and
        ``local_hvp(w, S, keys)`` with keys [..., n, 2], worker i's rows
        ``A_i[randint(keys[..., i, :], (B,), 0, r)]`` as the reference picks
        them (the rounds pass ``fold_in(k_g, i)`` and ``fold_in(k_h, i)``:
        ``driver.call_oracle``, which the ``keyed`` attribute selects)."""
        r = self.A.shape[1]
        if batch:
            return self._minibatch_oracles(batch)

        def local_grad(w):
            z = self._margins(w)
            coef = self.b * torch.sigmoid(-z)
            return (-torch.einsum("nrd,...nr->...nd", self.A, coef) / r
                    + self.mu * w.unsqueeze(-2))

        def local_hvp(w, S):
            z = self._margins(w)
            wgt = torch.sigmoid(z) * torch.sigmoid(-z)          # [..., n, r]
            AS = torch.matmul(self.A, S)                        # [n, r, m]
            return (torch.matmul(self.A.transpose(1, 2),
                                 wgt[..., None] * AS) / r
                    + self.mu * S)

        return local_grad, local_hvp

    def minibatch(self, keys: torch.Tensor, batch: int):
        """Worker i's minibatch of B rows under keys [..., n, 2]: (A rows
        [..., n, B, d], labels [..., n, B]), rows
        ``randint(keys[..., i, :], (B,), 0, r)`` of worker i's shard."""
        idx = random.randint(keys, (batch,), 0, self.A.shape[1])
        workers = torch.arange(self.n_workers, device=idx.device)[:, None]
        return self.A[workers, idx], self.b[workers, idx]

    def _minibatch_oracles(self, batch: int):
        def local_grad(w, keys):
            A, b = self.minibatch(keys, batch)          # [..., n, B, d]
            z = b * torch.einsum("...nbd,...d->...nb", A, w)
            coef = b * torch.sigmoid(-z)
            return (-torch.einsum("...nbd,...nb->...nd", A, coef) / batch
                    + self.mu * w.unsqueeze(-2))

        def local_hvp(w, S, keys):
            A, b = self.minibatch(keys, batch)
            z = b * torch.einsum("...nbd,...d->...nb", A, w)
            wgt = torch.sigmoid(z) * torch.sigmoid(-z)          # [..., n, B]
            AS = torch.matmul(A, S)                     # [..., n, B, m]
            return (torch.matmul(A.transpose(-1, -2), wgt[..., None] * AS)
                    / batch + self.mu * S)

        local_grad.keyed = local_hvp.keyed = True
        return local_grad, local_hvp

    def local_hessian(self, w):
        """Every worker's Hessian of its local loss at w [..., d]:
        ``A_iᵀ diag(σ(z_i) σ(-z_i)) A_i / r + μ I``, [..., n, d, d] (the
        reference takes ``jax.hessian`` of ``local_loss``)."""
        r, d = self.A.shape[1], self.A.shape[2]
        z = self._margins(w)
        wgt = torch.sigmoid(z) * torch.sigmoid(-z)              # [..., n, r]
        H = torch.matmul(self.A.transpose(1, 2), wgt[..., None] * self.A) / r
        return H + self.mu * torch.eye(d, dtype=H.dtype, device=H.device)


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
