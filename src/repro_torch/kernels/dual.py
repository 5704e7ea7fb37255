"""The guard every raw kernel launch passes: a forward-AD dual tensor
(``torch.autograd.forward_ad``) must never reach a kernel, which would
compute with its primal and drop its tangent.  Tangents reach the card
only through the ``autograd.Function``s whose ``jvp`` launches a tangent
kernel (``kernels/flash_attention/ops.py``)."""
from __future__ import annotations

import torch.autograd.forward_ad as fwAD


def tangent(t):
    """t's tangent at the current dual level, or None."""
    return fwAD.unpack_dual(t).tangent


def refuse_duals(name: str, *tensors) -> None:
    """Raise if any of ``tensors`` (None skipped) is a dual tensor."""
    for t in tensors:
        if t is not None and tangent(t) is not None:
            raise RuntimeError(
                f"{name}: a forward-AD dual tensor reached a raw kernel "
                f"launch, which would drop its tangent; only the "
                f"flash-attention Functions carry tangents on the card")
