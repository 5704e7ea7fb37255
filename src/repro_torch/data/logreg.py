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

#: torch.sigmoid on the CPU takes a tensor's elements through a vector path
#: and its last few through a scalar one, whose exp differs by an ulp now
#: and then: an element's value would depend on its position in the
#: tensor.  Padded to a multiple of this many elements, every element takes
#: the vector path, so a worker's value does not depend on how many
#: workers share the call (what the sharded and cohort engines need).
_SIGMOID_PAD = 128


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``, on the CPU of every element through the vector
    path (:data:`_SIGMOID_PAD`)."""
    if x.device.type != "cpu":
        return torch.sigmoid(x)
    flat = x.reshape(-1)
    k = flat.numel()
    pad = (-k) % _SIGMOID_PAD
    if pad:
        flat = torch.cat((flat, flat.new_zeros(pad)))
    return torch.sigmoid(flat)[:k].view(x.shape)


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
        coef = -self.b * _sigmoid(-z) / (z.shape[-1] * z.shape[-2])
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
        ``driver.call_oracle``, which the ``keyed`` attribute selects).

        Both take ``ids=``: the workers to compute, [K] (a shard's block,
        shared by the grid) or [G, K] (each point's cohort), giving
        [G, K, ...] — worker by worker the values of the full call."""
        if batch:
            return self._minibatch_oracles(batch)

        def rows(ids):
            return self.A[ids], self.b[ids]

        def local_grad(w, ids=None):
            if ids is None:
                return _grad_rows(self.A, self.b, self.mu, w)
            return _on_rows(_grad_rows, rows, ids, self.mu, w)

        def local_hvp(w, S, ids=None):
            if ids is None:
                return _hvp_rows(self.A, self.b, self.mu, w, S)
            return _on_rows(_hvp_rows, rows, ids, self.mu, w, S)

        return local_grad, local_hvp

    def minibatch(self, keys: torch.Tensor, batch: int, ids=None):
        """Worker i's minibatch of B rows under keys [..., n, 2]: (A rows
        [..., n, B, d], labels [..., n, B]), rows
        ``randint(keys[..., i, :], (B,), 0, r)`` of worker i's shard;
        ``ids`` ([n] or [G, n]) the workers where they are not 0..n-1."""
        idx = random.randint(keys, (batch,), 0, self.A.shape[1])
        workers = (torch.arange(self.n_workers, device=idx.device)
                   if ids is None else ids)[..., None]
        return self.A[workers, idx], self.b[workers, idx]

    def _minibatch_oracles(self, batch: int):
        def local_grad(w, keys, ids=None):
            A, b = self.minibatch(keys, batch, ids)     # [..., n, B, d]
            z = b * torch.einsum("...nbd,...d->...nb", A, w)
            coef = b * _sigmoid(-z)
            return (-torch.einsum("...nbd,...nb->...nd", A, coef) / batch
                    + self.mu * w.unsqueeze(-2))

        def local_hvp(w, S, keys, ids=None):
            A, b = self.minibatch(keys, batch, ids)
            z = b * torch.einsum("...nbd,...d->...nb", A, w)
            wgt = _sigmoid(z) * _sigmoid(-z)                    # [..., n, B]
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
        wgt = _sigmoid(z) * _sigmoid(-z)                        # [..., n, r]
        H = torch.matmul(self.A.transpose(1, 2), wgt[..., None] * self.A) / r
        return H + self.mu * torch.eye(d, dtype=H.dtype, device=H.device)


def _rows_dot(A, w):
    """A_i w for every worker i and grid point: A [n, r, d], w [..., d] ->
    [..., n, r], as one matrix-vector product a (point, worker) pair: on
    the CPU each pair's values do not depend on how many pairs share the
    call (but for a call of one pair), where an einsum folds the workers
    into one matrix whose product's rounding depends on its height."""
    return torch.matmul(A, w[..., None, :, None]).squeeze(-1)


def _rows_tdot(A, c):
    """A_iᵀ c_i: A [n, r, d], c [..., n, r] -> [..., n, d], one
    matrix-vector product a (point, worker) pair (see :func:`_rows_dot`)."""
    return torch.matmul(A.transpose(1, 2), c[..., None]).squeeze(-1)


def _on_rows(fn, rows, ids, mu, w, *args):
    """``fn(A, b, mu, w, *args)`` on the workers ``ids`` (``rows(ids)`` ->
    their (A, b)): a block [K] shared by every grid point, or [G, K], point
    g's own workers at its iterate w[g] (a call a point, so each worker's
    values are those of the one-point call)."""
    if ids.dim() == 1:
        return fn(*rows(ids), mu, w, *args)
    return torch.cat([fn(*rows(ids[g]), mu, w[g:g + 1], *args)
                      for g in range(ids.shape[0])])


def _grad_rows(A, b, mu, w):
    """Each worker's full-batch gradient: A [n, r, d], b [n, r], w [..., d]
    -> [..., n, d]."""
    z = b * _rows_dot(A, w)
    coef = b * _sigmoid(-z)
    return -_rows_tdot(A, coef) / A.shape[1] + mu * w.unsqueeze(-2)


def _hvp_rows(A, b, mu, w, S):
    """Each worker's Hessian-sketch product [..., n, d, m]."""
    z = b * _rows_dot(A, w)
    wgt = _sigmoid(z) * _sigmoid(-z)                            # [..., n, r]
    AS = torch.matmul(A, S)                                     # [n, r, m]
    return (torch.matmul(A.transpose(1, 2), wgt[..., None] * AS)
            / A.shape[1] + mu * S)


@dataclasses.dataclass(frozen=True, eq=False)
class VirtualLogReg:
    """Population-scale federated logistic regression whose shards are
    generated, not stored (the reference's ``VirtualLogReg``): client i's
    shard is a function of ``fold_in(key(seed), i)`` — ``k_a, k_s, k_b,
    k_f = split(.., 4)``, a per-client feature shift ``normal(k_s, (d,))``
    · heterogeneity / √d, features ``normal(k_a, (r, d)) / √d + shift``,
    labels +1 where ``uniform(k_b, (r,)) < σ(A w_true)``, flipped where
    ``uniform(k_f, (r,)) < label_noise`` — re-drawn each time the client is
    sampled, so memory is O(d) whatever the population and a round costs
    O(cohort · r · d).  ``random.normal`` is within a few ulps of JAX's,
    so features agree to that; a label can flip where a uniform lies
    within an ulp of σ.

    The oracles are the closed forms of :class:`FederatedLogReg`'s over
    the generated rows: ``local_grad(w, ids)`` and ``local_hvp(w, S,
    ids)`` with ids [K] or [G, K] (None: every client, for small N).  The
    trace's F and grad_sq are the objective of a fixed stratified probe of
    ``probe_clients`` clients (one a contiguous stratum), an N-independent
    estimate of the population's."""
    n_workers: int            # registered population N
    d: int
    r: int                    # samples per client shard
    mu: float
    heterogeneity: float
    label_noise: float
    seed: int
    probe_clients: int
    w_true: torch.Tensor      # [d] shared ground truth
    _probe: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.w_true.device

    def shards(self, ids) -> tuple:
        """(A [..., r, d], b [..., r]) of the clients ``ids`` (int)."""
        ids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        ki = random.fold_in(random.key(self.seed, self.device), ids)
        k_a, k_s, k_b, k_f = random.split(ki, 4).unbind(dim=-2)
        inv = float(np.float32(1.0 / np.sqrt(self.d)))
        shift = random.normal(k_s, (self.d,)) * self.heterogeneity * inv
        # XLA fuses normal · inv + shift into one fma: a float64 product
        # and sum rounded once is that fma
        A = (random.normal(k_a, (self.r, self.d)).to(torch.float64) * inv
             + shift[..., None, :].to(torch.float64)).to(torch.float32)
        p = _sigmoid(torch.matmul(A, self.w_true))
        b = torch.where(random.uniform(k_b, (self.r,)) < p, 1.0, -1.0)
        flip = random.uniform(k_f, (self.r,)) < self.label_noise
        return A, torch.where(flip, -b, b)

    def _all(self, ids):
        if ids is None:
            ids = torch.arange(self.n_workers, device=self.device)
        return ids

    def make_oracles(self, batch: int = 0):
        """(local_grad(w, ids), local_hvp(w, S, ids)): each sampled
        client's shard generated from its id inside the call; full local
        batches only (``batch`` raises, as in the reference)."""
        if batch:
            raise ValueError(
                "VirtualLogReg generates full shards per sampled client; "
                "minibatching within a virtual shard is not supported")

        def local_grad(w, ids=None):
            return _on_rows(_grad_rows, self.shards, self._all(ids), self.mu,
                            w)

        def local_hvp(w, S, ids=None):
            return _on_rows(_hvp_rows, self.shards, self._all(ids), self.mu,
                            w, S)

        return local_grad, local_hvp

    @property
    def probe_ids(self) -> torch.Tensor:
        """One client a contiguous stratum, fixed across rounds."""
        return (torch.arange(self.probe_clients, device=self.device)
                * (self.n_workers // self.probe_clients))

    def _probe_shards(self, device):
        key = str(device)
        if key not in self._probe:
            A, b = self.shards(self.probe_ids)
            self._probe[key] = (A.to(device), b.to(device))
        return self._probe[key]

    def probe_loss(self, w):
        """The probe clients' mean local loss at w [d] (0-d) or [G, d]."""
        A, b = self._probe_shards(w.device)
        z = b * torch.einsum("nrd,...d->...nr", A, w)
        return (torch.mean(torch.logaddexp(torch.zeros_like(z), -z),
                           dim=(-2, -1))
                + 0.5 * self.mu * torch.sum(w * w, dim=-1))

    def probe_grad(self, w):
        A, b = self._probe_shards(w.device)
        z = b * torch.einsum("nrd,...d->...nr", A, w)
        coef = -b * _sigmoid(-z) / (z.shape[-1] * z.shape[-2])
        return torch.einsum("nrd,...nr->...d", A, coef) + self.mu * w

    def metrics(self, w):
        """The probe objective and its squared gradient norm (the keys of
        ``FederatedLogReg.metrics``)."""
        return {"F": self.probe_loss(w),
                "grad_sq": torch.sum(torch.square(self.probe_grad(w)),
                                     dim=-1)}


def make_virtual_problem(d: int = 24, n_total: int = 100_000, r: int = 16,
                         mu: float = 1e-3, heterogeneity: float = 1.0,
                         label_noise: float = 0.05, seed: int = 0,
                         probe_clients: int = 16,
                         device=None) -> VirtualLogReg:
    """The reference's population-scale problem factory (``w_true`` from
    numpy's generator, as there), on ``device``."""
    if not 1 <= probe_clients <= n_total:
        raise ValueError(
            f"probe_clients={probe_clients} must be in [1, {n_total}]")
    rng = np.random.default_rng(seed)
    w_true = torch.as_tensor((rng.normal(size=d) / np.sqrt(d)).astype(
        np.float32), device=resolve_device(device))
    return VirtualLogReg(n_total, d, r, mu, heterogeneity, label_noise,
                         seed, probe_clients, w_true)


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
