"""The port's device rule, shared by every entry point.

``device=None`` means the card: an entry point raises when CUDA is absent,
unless the caller asks for the CPU explicitly (the tests do).  Every
function below an entry point takes its device from the tensors it is
given.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Map an entry point's ``device`` argument to a ``torch.device``.

    None -> ``cuda``.  A CUDA device raises when no card is present (there
    is no silent move to the CPU).  Float32 matrix products are pinned to
    full float32 (TF32 off, for both cuBLAS and cuDNN): the JAX reference
    computes in float32 and the port is compared against it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
