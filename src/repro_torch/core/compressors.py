"""Compressors of the main path (counterpart of ``repro.core.compressors``).

A :class:`CompressorSpec` names a family and its parameters.  A scalar spec
holds a Python int family and float parameters.  A grid spec (a sweep's [G]
axis, :func:`stack_specs`) holds the families as a host tuple, known when
the grid is built, and s and frac as float32 [G] tensors beside their host
numpy copies (which price the grid without reading the device).  The entry
points dispatch on the families in Python, where the reference's traced
``lax.switch`` selects per grid point:

    compress(spec, keys, x)      — apply Q to each row of x (one row per
                                   worker message, one key per row)
    compress_split(spec, key, x) — compress(spec, random.split(key, n), x)
                                   for n rows: the round's call; a grid spec
                                   takes keys [G, 2] and x [G, n, ...] and
                                   launches once per family of the grid
    spec_bits(spec, d, device)   — exact uplink payload bits of a d-element
                                   message, a float32 0-d tensor
    spec_bits_many(spec, d)      — the same for each point of a grid spec
                                   ([G], one ledger launch per family)
    spec_bits_host(spec, d)      — the same in numpy, priced on the CPU
                                   from the host copies
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

import functools
from typing import NamedTuple, Optional, Tuple, Union

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
    rounded to float32 as the reference holds them.

    A grid spec ([G] points, :func:`stack_specs`, :func:`grid_spec`) holds
    ``family`` as a tuple of G ids, ``s`` and ``frac`` as float32 [G]
    tensors, and ``s_host`` / ``frac_host``, their numpy copies."""
    family: Union[int, Tuple[int, ...]]
    s: Union[float, torch.Tensor]
    frac: Union[float, torch.Tensor]
    s_host: Optional[np.ndarray] = None
    frac_host: Optional[np.ndarray] = None


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


# ---------------------------------------------------------------------------
# Grid specs: a sweep's [G] axis of compressors
# ---------------------------------------------------------------------------

def is_grid(spec: CompressorSpec) -> bool:
    return isinstance(spec.family, tuple)


def grid_spec(family, s, frac, device="cpu") -> CompressorSpec:
    """A [G] grid spec from G family ids and G levels and fractions
    (rounded to float32), the tensors on ``device``."""
    s_host = np.asarray(s, np.float32).reshape(-1).copy()
    frac_host = np.asarray(frac, np.float32).reshape(-1).copy()
    family = tuple(int(f) for f in family)
    if not len(family) == s_host.shape[0] == frac_host.shape[0] >= 1:
        raise ValueError(f"grid spec: {len(family)} families, "
                         f"{s_host.shape[0]} levels, {frac_host.shape[0]} "
                         "fractions")
    return CompressorSpec(family, torch.as_tensor(s_host, device=device),
                          torch.as_tensor(frac_host, device=device),
                          s_host, frac_host)


def stack_specs(*specs) -> CompressorSpec:
    """Stack scalar specs (names or specs) into one [G] grid spec whose
    axis may vary the family itself: ``stack_specs("identity", "dither64")``
    is the FLECS-vs-FLECS-CGD comparison as one grid axis."""
    scal = [make_spec(sp) for sp in specs]
    if not scal or any(is_grid(sp) for sp in scal):
        raise ValueError("stack_specs takes one or more scalar specs")
    return grid_spec([sp.family for sp in scal], [sp.s for sp in scal],
                     [sp.frac for sp in scal])


def as_grid(spec: CompressorSpec, G: int) -> CompressorSpec:
    """A scalar spec broadcast to a [G] grid spec; a grid spec of G points
    as it is."""
    if is_grid(spec):
        if len(spec.family) != G:
            raise ValueError(f"grid spec of {len(spec.family)} points, "
                             f"expected {G}")
        return spec
    return grid_spec((spec.family,) * G, [spec.s] * G, [spec.frac] * G)


def tile_spec(spec: CompressorSpec, reps: int) -> CompressorSpec:
    """A grid spec's points repeated ``reps`` times (point b·G + g is
    point g): ``jnp.tile`` of every leaf."""
    return grid_spec(spec.family * reps, np.tile(spec.s_host, reps),
                     np.tile(spec.frac_host, reps), spec.s.device)


def spec_point(spec: CompressorSpec, g: int) -> CompressorSpec:
    """Point g of a grid spec as a scalar spec (from the host copies)."""
    return CompressorSpec(spec.family[g], float(spec.s_host[g]),
                          float(spec.frac_host[g]))


def spec_to(spec: CompressorSpec, device) -> CompressorSpec:
    """A grid spec with its tensors on ``device`` (scalar specs hold no
    tensor)."""
    if not is_grid(spec):
        return spec
    return spec._replace(s=spec.s.to(device), frac=spec.frac.to(device))


@functools.lru_cache(maxsize=64)
def _groups(family: tuple, device: torch.device):
    """[(family id, the points of that family)] of a grid: a slice where
    the points are one run, else an index tensor on ``device`` (built once
    per grid and device: the round reads no host value)."""
    out = []
    for fam in sorted(set(family)):
        idx = [g for g, f in enumerate(family) if f == fam]
        if idx == list(range(idx[0], idx[-1] + 1)):
            out.append((fam, slice(idx[0], idx[-1] + 1)))
        else:
            out.append((fam, torch.tensor(idx, dtype=torch.int64,
                                          device=device)))
    return tuple(out)


def _unported(family) -> NotImplementedError:
    return NotImplementedError(
        f"compressor family {family} is not ported yet (ROADMAP.md, queue "
        "1: 'other compressor families')")


def _compress_grid_rows(family: int, rows, keys, s, frac):
    """One family's points: rows [P·n, L] of P points, their keys [P, 2]
    and parameters [P] — one grouped launch on the card."""
    if family == FAMILY_IDENTITY:
        return rows
    if family == FAMILY_DITHER:
        return ops.fused_dither_keyed_grouped(rows, keys, s)[0]
    if family == FAMILY_TOPK:
        return ops.fused_topk_grouped(rows, frac)[0]
    raise _unported(family)


def _compress_split_grid(spec: CompressorSpec, keys: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """compress_split of each grid point: x [G, n, ...], keys [G, 2]."""
    G, n = x.shape[0], x.shape[1]
    if keys.shape != (G, 2):
        raise ValueError(f"grid compress_split: keys [{G}, 2] required, got "
                         f"{tuple(keys.shape)}")
    rows = x.reshape(G * n, -1).contiguous()
    groups = _groups(spec.family, x.device)
    if len(groups) == 1:
        out = _compress_grid_rows(groups[0][0], rows, keys.contiguous(),
                                  spec.s, spec.frac)
        return out.reshape(x.shape)
    L = rows.shape[1]
    out = rows.clone() if FAMILY_IDENTITY in spec.family else \
        torch.empty_like(rows)
    view = out.view(G, n, L)
    for fam, sel in groups:
        if fam == FAMILY_IDENTITY:
            continue
        sub = rows.view(G, n, L)[sel]
        res = _compress_grid_rows(fam, sub.reshape(-1, L).contiguous(),
                                  keys[sel].contiguous(),
                                  spec.s[sel].contiguous(),
                                  spec.frac[sel].contiguous())
        view[sel] = res.view(-1, n, L)
    return out.reshape(x.shape)


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
    call.  The other families use no key, so they never split one.

    A grid spec of G points takes keys [G, 2] and x [G, n, ...]: point g's
    rows are compressed with ``split(keys[g], n)`` at its own parameters,
    one grouped launch per family of the grid, G = 1 included (identity
    points pass through)."""
    if is_grid(spec):
        return _compress_split_grid(spec, key, x)
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
    raise _unported(spec.family)


def _bits_grid(family: int, s, frac, d, device) -> torch.Tensor:
    if family == FAMILY_IDENTITY:
        return torch.full(s.shape, 32.0 * float(np.float32(d)),
                          dtype=torch.float32, device=device)
    if family == FAMILY_DITHER:
        return ops.dither_bits_grouped(s, d)
    if family == FAMILY_TOPK:
        return ops.topk_bits_grouped(frac, d)
    raise _unported(family)


def spec_bits_many(spec: CompressorSpec, d, device=None) -> torch.Tensor:
    """:func:`spec_bits` of each point of a grid spec: float32 [G] on the
    spec's device, one grouped ledger launch per family of the grid, G = 1
    included.  A scalar spec passes straight through to :func:`spec_bits`
    on ``device``."""
    if not is_grid(spec):
        return spec_bits(spec, d, device)
    dev = spec.s.device
    G = len(spec.family)
    groups = _groups(spec.family, dev)
    if len(groups) == 1:
        return _bits_grid(groups[0][0], spec.s, spec.frac, d, dev)
    out = torch.empty(G, dtype=torch.float32, device=dev)
    for fam, sel in groups:
        out[sel] = _bits_grid(fam, spec.s[sel].contiguous(),
                              spec.frac[sel].contiguous(), d, dev)
    return out


def spec_bits_host(spec: CompressorSpec, d) -> np.ndarray:
    """:func:`spec_bits` (or :func:`spec_bits_many`) priced on the host:
    the plain ledger versions on CPU tensors built from the spec's host
    values, so no device value is read.  float32 [G] for a grid spec, 0-d
    for a scalar one.  Budget scan lengths are priced so."""
    if not is_grid(spec):
        return spec_bits(spec, d, "cpu").numpy()
    return spec_bits_many(grid_spec(spec.family, spec.s_host,
                                     spec.frac_host), d).numpy()


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
