"""Serve step factories (counterpart of ``repro.train.step``).

``make_train_step`` and its loss come with the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, prefill


def make_prefill_step(cfg: ModelConfig, max_len: int = 0):
    """(params, batch) -> (last logits [B, 1, V], cache)."""

    def prefill_step(params, batch):
        return prefill(params, batch, cfg, max_len=max_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, batch, pos) -> (logits, cache); the
    cache is updated in place."""

    def serve_step(params, cache, batch, pos: int):
        return decode_step(params, cache, batch, pos, cfg)

    return serve_step
