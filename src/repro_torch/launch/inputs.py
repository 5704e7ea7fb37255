"""Shapes and dtypes of every model input, with no allocation (counterpart
of ``repro.launch.inputs``).

``input_specs(cfg, shape)`` gives the batch of an ``InputShape`` as a dict
of ``(shape, dtype)`` pairs where the reference gives
``jax.ShapeDtypeStruct``s: tokens and labels ``[B, S]`` (``[B, S, C]`` for
the audio codebooks) in ``torch.int64``, the port's token type (the
reference's ``int32``), and a VLM's projected patch embeddings
``[B, n_img_tokens, d_model]`` in ``torch.bfloat16``, as the reference
gives them.  The trainer (``launch/train.token_batches``) and the server
(``launch/serve.image_embeds``) draw their batches in these shapes.

Not ported: ``abstract_cache``, which traces the cache of a mesh and a
``ModelContext`` with ``jax.eval_shape``; it waits with
``models/context.py`` (ROADMAP.md queue 1, 'tooling, port-side only').
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig

#: The dtypes of the batch's leaves.
TOKEN_DTYPE = torch.int64
IMAGE_DTYPE = torch.bfloat16


def _tok_shape(cfg: ModelConfig, B: int, S: int) -> tuple:
    if cfg.n_codebooks:
        return (B, S, cfg.n_codebooks)
    return (B, S)


def _image(cfg: ModelConfig, B: int) -> tuple:
    return (B, cfg.n_img_tokens, cfg.d_model), IMAGE_DTYPE


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The batch of ``shape`` (its kind ``train``, ``prefill`` or
    ``decode``) as ``{name: (shape, dtype)}``."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": (_tok_shape(cfg, B, S), TOKEN_DTYPE),
                 "labels": (_tok_shape(cfg, B, S), TOKEN_DTYPE)}
        if cfg.family == "vlm":
            batch["image_embeds"] = _image(cfg, B)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": (_tok_shape(cfg, B, S), TOKEN_DTYPE)}
        if cfg.family == "vlm":
            batch["image_embeds"] = _image(cfg, B)
        return batch
    if shape.kind == "decode":
        return {"tokens": (_tok_shape(cfg, B, 1), TOKEN_DTYPE)}
    raise ValueError(shape.kind)
