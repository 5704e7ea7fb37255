"""Sketch matrices S_k ∈ R^{d×m} (counterpart of ``repro.core.sketch``).

Worker and server agree on S_k by seeding it with the iteration number k
(Algorithm 1, lines 3 and 9): ``sketch(kind, d, m, k, device)`` is a pure
function of its arguments, drawn from ``fold_in(key(17), k)`` as the
reference draws it.  The Rademacher and coordinate sketches are the
reference's bit for bit; the Gaussian one within ``random.normal``'s few
ulps.
"""
from __future__ import annotations

import torch

from repro_torch import random


def sketch(kind: str, d: int, m: int, k, device) -> torch.Tensor:
    """Deterministic S_k from iteration number k: [d, m], float32.  ``k``
    may be an int tensor of rounds (any shape, on ``device``): one sketch
    for each, ``k.shape + (d, m)``, drawn on the device at once (the async
    L-SR1 update regenerates each message's compute-round sketch so)."""
    key = random.fold_in(random.key(17, device), k)
    root_m = torch.sqrt(torch.tensor(m, dtype=torch.float32))
    if kind == "rademacher":
        return random.rademacher(key, (d, m)) / root_m
    if kind == "gaussian":
        return random.normal(key, (d, m)) / root_m
    if kind == "coordinate":
        idx = random.choice(key, d, (m,), replace=False)
        S = torch.zeros(key.shape[:-1] + (d, m), dtype=torch.float32,
                        device=key.device)
        return S.scatter_(-2, idx.unsqueeze(-2), 1.0)
    raise ValueError(kind)
