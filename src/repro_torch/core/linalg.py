"""``pinv`` and ``eigh`` with the reference's handling of non-finite input.

``jnp.linalg.pinv`` / ``eigh`` return NaN for a matrix holding inf or NaN
(a diverged run then carries NaN on, as the reference does), while
``torch.linalg`` raises.  These wrappers zero such matrices before the
decomposition and return NaN in their place; batch elements that are finite
are computed as ``torch.linalg`` computes them.  The check stays on the
device.
"""
from __future__ import annotations

import torch


def _finite(A: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(A).all(dim=-1).all(dim=-1)       # batch shape


def pinv(M: torch.Tensor, rtol: float) -> torch.Tensor:
    """``torch.linalg.pinv(M, rtol=rtol)`` (SVD, non-Hermitian); NaN for a
    batch element with a non-finite entry."""
    ok = _finite(M)[..., None, None]
    P = torch.linalg.pinv(torch.where(ok, M, 0.0), rtol=rtol)
    return torch.where(ok, P, torch.nan)


def eigh(A: torch.Tensor):
    """``torch.linalg.eigh(A)``; NaN eigenpairs for a batch element with a
    non-finite entry."""
    ok = _finite(A)
    lam, V = torch.linalg.eigh(torch.where(ok[..., None, None], A, 0.0))
    return (torch.where(ok[..., None], lam, torch.nan),
            torch.where(ok[..., None, None], V, torch.nan))
