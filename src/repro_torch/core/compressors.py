"""Compressors of the main path (counterpart of ``repro.core.compressors``).

A :class:`CompressorSpec` names a family and its parameters.  In this slice
the family is a concrete Python int, so the entry points dispatch in Python
(the reference's traced ``lax.switch`` over family axes comes with sweeps):

    compress(spec, keys, x)      — apply Q to each row of x (one row per
                                   worker message, one key per row)
    compress_split(spec, key, x) — compress(spec, random.split(key, n), x)
                                   for n rows: the round's call
    spec_bits(spec, d, device)   — exact uplink payload bits of a d-element
                                   message, a float32 0-d tensor
    shared_scale_levels(key, x, s) / decode_int8(levels, scale)
                                 — the int8 wire format of the deep-learning
                                   trainer (``core/dl_flecs.py``), through
                                   the dither codec kernels

Dither and top-k run through the fused kernels of
``repro_torch.kernels.compressor`` on a CUDA tensor and through their plain
versions on a CPU tensor; both equal the reference bit for bit.  The dither
uniforms are the reference's own, ``uniform(key, message.shape)`` with each
worker's key ``split(k, n)[i]`` (``repro_torch.random``), so outputs compare
element for element.  ``compress`` draws them with ``random.uniform`` from
the keys it is given; ``compress_split`` on a CUDA tensor hands the parent
key to ``fused_dither_keyed``, which derives the workers' keys and their
uniforms in registers, so no key or uniform reaches device memory.

Families ported: identity (32·d bits), dither<s> (⌈log2(2s+1)⌉·d bits) and
topk<frac> (⌈frac·d⌉·(32 + ⌈log2 d⌉) bits).  natural, count_sketch and
minmax raise ``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.compressor import ops
from repro_torch.kernels.dither import ops as dither_ops

# Family ids, the reference's (natural = 2, count_sketch = 4 and minmax = 5
# are not ported)
FAMILY_IDENTITY = 0
FAMILY_DITHER = 1
FAMILY_TOPK = 3


def _f32(v) -> float:
    return float(np.float32(v))


class CompressorSpec(NamedTuple):
    """(family, s, frac): the family id (FAMILY_*), the dithering level
    count s (FAMILY_DITHER) and the kept fraction frac (FAMILY_TOPK), both
    rounded to float32 as the reference holds them."""
    family: int
    s: float
    frac: float


def identity_spec() -> CompressorSpec:
    return CompressorSpec(FAMILY_IDENTITY, 1.0, 1.0)


def dither_spec(s) -> CompressorSpec:
    """Random ∞-norm dithering with s levels."""
    return CompressorSpec(FAMILY_DITHER, _f32(s), 1.0)


def topk_spec(frac) -> CompressorSpec:
    """Biased top-k contraction keeping ⌈frac·d⌉ magnitudes."""
    return CompressorSpec(FAMILY_TOPK, 1.0, _f32(frac))


_VALID_NAMES = ("'identity'", "'dither<s>' (e.g. 'dither64')", "'natural'",
                "'topk<frac>' (e.g. 'topk0.1')",
                "'count_sketch<width>' (e.g. 'count_sketch64')",
                "'minmax<frac>' (e.g. 'minmax0.25')")


def _unknown_name(name: str) -> ValueError:
    return ValueError(
        f"unknown compressor name {name!r}; valid names: "
        + ", ".join(_VALID_NAMES)
        + " — numeric suffixes may instead be passed as make_spec keywords")


def make_spec(name_or_spec: Union[str, CompressorSpec],
              **params) -> CompressorSpec:
    """The compressor constructor: a registry name (``"identity"``,
    ``"dither64"``, ``"topk0.1"``; the numeric suffix is the family's main
    parameter, which may instead be a keyword: ``s`` or ``frac``) or an
    existing spec.  Errors and their messages are the reference's."""
    if isinstance(name_or_spec, CompressorSpec):
        if params:
            raise ValueError(
                "make_spec(spec, **params): keyword parameters only apply "
                "to name-based construction; rebuild the spec instead")
        return name_or_spec
    if not isinstance(name_or_spec, str):
        raise TypeError(
            f"make_spec takes a name, CompressorSpec, or Compressor — got "
            f"{type(name_or_spec).__name__}")
    name = name_or_spec

    def suffix_param(prefix, cast, pname):
        raw = name[len(prefix):]
        if not raw:
            return
        if pname in params:
            raise ValueError(
                f"compressor parameter {pname!r} given both in the name "
                f"{name!r} and as a keyword — pick one")
        try:
            params[pname] = cast(raw)
        except ValueError:
            raise _unknown_name(name) from None

    if name == "identity":
        allowed, ctor = (), identity_spec
    elif name == "natural" or name.startswith(("count_sketch", "minmax")):
        raise NotImplementedError(
            f"compressor {name!r} is not ported yet (ROADMAP.md, queue 1: "
            "'other compressor families'); ported: identity, dither<s>, "
            "topk<frac>")
    elif name.startswith("dither"):
        allowed = ("s",)
        suffix_param("dither", int, "s")
        ctor = lambda: dither_spec(params.get("s", 64))       # noqa: E731
    elif name.startswith("topk"):
        allowed = ("frac",)
        suffix_param("topk", float, "frac")
        ctor = lambda: topk_spec(params.get("frac", 0.1))     # noqa: E731
    else:
        raise _unknown_name(name)
    unknown = set(params) - set(allowed)
    if unknown:
        raise ValueError(
            f"unknown parameter(s) {sorted(unknown)} for compressor "
            f"{name!r}; this family takes {list(allowed) or 'no parameters'}")
    return ctor()


def compress(spec: CompressorSpec, keys: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Q(x) for each row of x ``[n, ...]``: row i is one whole message,
    compressed with key ``keys[i]`` (``keys`` is ``[n, 2]``).  Returns a
    tensor shaped like x."""
    if spec.family == FAMILY_IDENTITY:
        return x
    rows = x.reshape(x.shape[0], -1).contiguous()
    if spec.family == FAMILY_DITHER:
        u = random.uniform(keys, rows.shape[1:])     # == _dither's draw
        out = ops.fused_dither(rows, u, spec.s)[0]
    elif spec.family == FAMILY_TOPK:
        out = ops.fused_topk(rows, spec.frac)[0]
    else:
        raise NotImplementedError(
            f"compressor family {spec.family} is not ported yet "
            "(ROADMAP.md, queue 1: 'other compressor families')")
    return out.reshape(x.shape)


def compress_split(spec: CompressorSpec, key: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``compress(spec, random.split(key, n), x)`` for x ``[n, ...]``: row
    i is compressed with the i-th key split from ``key`` (``[2]``).  On a
    CUDA tensor the dither family launches the keyed kernel, which splits
    the key and draws the uniforms itself; on the CPU this is exactly that
    call.  The other families use no key, so they never split one."""
    if spec.family != FAMILY_DITHER:
        return compress(spec, None, x)
    if x.device.type == "cuda":
        rows = x.reshape(x.shape[0], -1).contiguous()
        return ops.fused_dither_keyed(rows, key, spec.s)[0].reshape(x.shape)
    return compress(spec, random.split(key, x.shape[0]), x)


def spec_bits(spec: CompressorSpec, d: int,
              device: torch.device) -> torch.Tensor:
    """Exact uplink payload bits of compressing a d-element message, as a
    float32 0-d tensor on ``device`` (the ledger stays on the device).

    identity: 32·d.  dither: ⌈log2(2s+1)⌉·d.  top-k: ⌈frac·d⌉ kept values,
    each a 32-bit payload plus a ⌈log2 d⌉-bit index.  Dither and top-k are
    priced by the ledger kernels on a CUDA device."""
    if spec.family == FAMILY_IDENTITY:
        return torch.tensor(32.0 * float(np.float32(d)), dtype=torch.float32,
                            device=device)
    if spec.family == FAMILY_DITHER:
        return ops.dither_bits(spec.s, d, device)
    if spec.family == FAMILY_TOPK:
        return ops.topk_bits(spec.frac, d, device)
    raise NotImplementedError(
        f"compressor family {spec.family} is not ported yet (ROADMAP.md, "
        "queue 1: 'other compressor families')")


# ---------------------------------------------------------------------------
# int8 wire format of the deep-learning trainer (one worker)
# ---------------------------------------------------------------------------

def psum_level_cap(s_levels, n_workers: int) -> float:
    """Dithering-level cap of the int8 collective: min(s, 2047 // n),
    clipped to at least 1, as a float32 value (the reference's lax-side
    clip; n workers' level sums stay exact in an f16 accumulation)."""
    cap = np.float32(max(1, 2047 // n_workers))
    return float(np.clip(np.float32(s_levels), np.float32(1.0), cap))


def _leaf_rows(x: torch.Tensor) -> torch.Tensor:
    """A tensor as the rows of one block: [numel / last dim, last dim]."""
    return x.reshape(-1, x.shape[-1])


def shared_scale_levels(key, x: torch.Tensor, s):
    """int8 dithering levels of x with one ∞-norm scale over the whole
    tensor: (levels int8 of x's shape, scale float32 0-d).

    The reference agrees the norm across the workers with a ``pmax``; on
    one worker that is the identity, so this is ``dither_encode`` over x
    as a single block, with the uniforms ``uniform(key, x.shape)`` of the
    reference, bit for bit.  On a CUDA tensor the keyed encode kernel draws
    them in registers (``dither_encode_keyed``); a later sharded slice puts
    an all-reduce of the norm between its two passes."""
    rows = _leaf_rows(x)
    levels, scale = dither_ops.dither_encode_keyed(
        rows.contiguous(), key, s=s, block_rows=rows.shape[0])
    return levels.reshape(x.shape), scale[0]


def decode_int8(levels: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``levels · scale`` in float32 (the reference's ``decode_int8``), by
    the decode kernel over the tensor as a single block."""
    rows = _leaf_rows(levels)
    out = dither_ops.dither_decode(rows.contiguous(), scale.reshape(1),
                                   block_rows=rows.shape[0])
    return out.reshape(levels.shape)
