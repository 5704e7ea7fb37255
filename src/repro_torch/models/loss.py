"""Cross-entropy LM loss (counterpart of ``repro.models.loss``), chunked over
tokens so that [T, V] logits never exist for the whole batch at once."""
from __future__ import annotations

import torch

from repro_torch.models.model import head_logits


def _ce(logits, labels):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    return lse - gold


def lm_loss(params, hidden, labels, cfg, *, mask=None, chunk=1024):
    """hidden: [B, S, D]; labels: [B, S] (int64).  Mean cross-entropy over
    the positions ``mask`` keeps (all by default), summed chunk by chunk of
    ``chunk`` tokens; when T % chunk != 0 the whole batch is one chunk, as
    in the reference."""
    B, S, D = hidden.shape
    T = B * S
    h = hidden.reshape(T, D)
    lab = labels.reshape(T, *labels.shape[2:])
    m = (torch.ones((T,), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.reshape(T).float())
    chunk = min(chunk, T)
    if T % chunk:
        chunk = T
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, T, chunk):
        ce = _ce(head_logits(params, h[lo:lo + chunk], cfg),
                 lab[lo:lo + chunk])
        if ce.dim() > 1:                     # audio: mean over codebooks
            ce = ce.mean(dim=-1)
        total = total + torch.sum(ce * m[lo:lo + chunk])
    return total / torch.clamp(m.sum(), min=1.0)
