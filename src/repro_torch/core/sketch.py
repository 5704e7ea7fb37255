"""Sketch matrices S_k ∈ R^{d×m} (counterpart of ``repro.core.sketch``).

Worker and server agree on S_k by seeding it with the iteration number k
(Algorithm 1, lines 3 and 9): ``sketch(kind, d, m, k, device)`` is a pure
function of its arguments, bit for bit the reference's.
"""
from __future__ import annotations

import torch

from repro_torch import random


def sketch(kind: str, d: int, m: int, k: int, device) -> torch.Tensor:
    """Deterministic S_k from iteration number k.  [d, m], float32."""
    if kind == "rademacher":
        key = random.fold_in(random.key(17, device), k)
        return (random.rademacher(key, (d, m))
                / torch.sqrt(torch.tensor(m, dtype=torch.float32)))
    if kind in ("gaussian", "coordinate"):
        raise NotImplementedError(
            f"sketch_kind={kind!r} is not ported yet (ROADMAP.md, queue 1: "
            "'other sketches': Gaussian needs only the sketch itself, "
            "coordinate needs random.choice)")
    raise ValueError(kind)
