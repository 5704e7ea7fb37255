"""Server-side Hessian-approximation updates (Algorithms 2 and 3);
counterpart of ``repro.core.updates``, batched over leading worker
dimensions (B [n, d, d], Ỹ [n, d, m], M [n, m, m]; S [d, m] is shared).

Truncated L-SR1 (Alg 2):
    M - SᵀBS = U L Uᵀ;   B⁺ = B + (Ỹ - B S) U [L⁻¹]_ω Uᵀ (Ỹ - B S)ᵀ
Direct update (Alg 3):
    B̃ = Ỹ M† Ỹᵀ;   B⁺ = (1-β) B + β B̃.
"""
from __future__ import annotations

import torch

from repro_torch.core.linalg import eigh, pinv


def _sym(a):
    return 0.5 * (a + a.mT)


def truncated_lsr1_update(B, Y_tilde, M, S, omega: float):
    """Alg 2; returns (B⁺, the symmetrized m×m residual G)."""
    R = Y_tilde - B @ S                      # d x m residual
    G = _sym(M - S.mT @ (B @ S))             # m x m
    lam, U = eigh(G)
    # [L⁻¹]_ω: |λ| floored at ω before inverting, sign kept
    inv = torch.sign(lam) / torch.clamp(torch.abs(lam), min=omega)
    W = R @ U
    return _sym(B + (W * inv[..., None, :]) @ W.mT), G


def direct_update(B, Y_tilde, M, beta: float):
    """Alg 3.  B⁺ = (1-β) B + β Ỹ M† Ỹᵀ, with the reference's
    ``pinv(M, rcond=1e-10)`` as ``pinv(M, rtol=1e-10)``."""
    B_tilde = Y_tilde @ pinv(M, rtol=1e-10) @ Y_tilde.mT
    return _sym((1.0 - beta) * B + beta * B_tilde)
