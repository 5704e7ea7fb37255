"""Search directions (Definition 7, Algorithms 4 and 5); counterpart of
``repro.core.directions``.

Truncated inverse (Alg 4) needs an O(d³) eigendecomposition of the averaged
d×d approximation.  FedSONIA (Alg 5) works from the current sketch (Ỹ, M)
alone: O(d m² + m³).  Both produce p = -A g with μ₁ I ⪯ A ⪯ μ₂ I (Lemma 9).
Every argument may lead with a grid axis [G] (g [G, d], B [G, d, d], ...).
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg import eigh, pinv


def inverse_apply(V, scale, grad):
    """V diag(1/scale) Vᵀ g for g [..., d]."""
    coef = V.mT @ grad.unsqueeze(-1)
    return (V @ (coef / scale.unsqueeze(-1))).squeeze(-1)


def truncate_eigs(lam, omega: float, Omega: float):
    """Definition 7 with the reference's safeguard: |λ| < ω carries no
    trustworthy curvature and maps to Ω (step 1/Ω ≈ 0, as FedSONIA treats
    its orthogonal complement); observed curvature is clipped into [ω, Ω]."""
    a = torch.abs(lam)
    return torch.where(a >= omega, torch.clamp(a, max=Omega),
                       torch.full_like(a, Omega))


def truncated_inverse_direction_floored(B, grad, omega, Omega, floor):
    """Alg 4 with a curvature floor: eigendirections with |λ| < floor are
    treated like FedSONIA's orthogonal complement (1/Ω)."""
    lam, V = eigh(0.5 * (B + B.mT))
    a = torch.abs(lam)
    lam_t = torch.where(a >= floor, torch.clamp(a, omega, Omega),
                        torch.full_like(a, Omega))
    return -inverse_apply(V, lam_t, grad)


def truncated_inverse_direction(B, grad, omega: float, Omega: float):
    """Alg 4: p = -(|B|_ω^Ω)^{-1} ∇F.  B: [..., d, d] symmetric."""
    lam, V = eigh(0.5 * (B + B.mT))
    lam_t = truncate_eigs(lam, omega, Omega)
    return -inverse_apply(V, lam_t, grad)


def fedsonia_direction(Y_tilde, M, grad, omega: float, Omega: float,
                       rho: float):
    """Alg 5 (FedSONIA): low-rank truncated inverse + scaled complement.

    B_sonia = Ỹ M† Ỹᵀ = Q (R M† Rᵀ) Qᵀ with Ỹ = Q R (reduced QR).
    p = -(|B_sonia|_ω^Ω)^{-1} g_∥  -  ρ g_⊥.
    ``pinv(M, rtol=1e-10)`` is the reference's ``pinv(M, rcond=1e-10)``.
    """
    Q, R = torch.linalg.qr(Y_tilde)                     # d x m, m x m
    core = R @ pinv(M, rtol=1e-10) @ R.mT              # m x m
    lam, V = eigh(0.5 * (core + core.mT))
    lam_t = truncate_eigs(lam, omega, Omega)
    Vq = Q @ V                                          # d x m orthonormal
    coef = Vq.mT @ grad.unsqueeze(-1)                   # m x 1
    g_par = (Vq @ coef).squeeze(-1)
    g_perp = grad - g_par
    return (-(Vq @ (coef / lam_t.unsqueeze(-1))).squeeze(-1)
            - rho * g_perp)
