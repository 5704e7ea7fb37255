"""Compressors (counterpart of ``repro.core.compressors``).

A :class:`CompressorSpec` names a family and its parameters.  A scalar spec
holds a Python int family, float parameters and float
:class:`SketchParams`.  A grid spec (a sweep's [G] axis,
:func:`stack_specs`) holds the families as a host tuple, known when the
grid is built, and s, frac and the sketch parameters as float32 [G] tensors
beside their host numpy copies (which price the grid without reading the
device).  The entry points dispatch on the families in Python, where the
reference's traced ``lax.switch`` selects per grid point:

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
    spec_omega(spec, d)          — the variance bound ω of Definition 3
    spec_commutes_with_sum(spec) — whether the encoding is linear
    Compressor, identity(), random_dithering(s), natural(), top_k(frac),
    count_sketch(width, depth, hh_frac), min_max(frac)
                                 — the static veneer: a named scalar spec
                                   with ``compress``, ``bits(d)`` and
                                   ``omega(d)``; ``get_compressor``,
                                   ``as_spec`` and ``spec_from_name`` are
                                   deprecated aliases, as in the reference
    shared_scale_levels(key, x, s) / decode_int8(levels, scale)
                                 — the int8 wire format of the deep-learning
                                   trainer (``core/dl_flecs.py``), through
                                   the dither codec kernels

The six families, priced and bounded as the reference prices them:

* identity — Q(x) = x; 32·d bits; ω = 0.
* dither<s> — random ∞-norm dithering to s levels; ⌈log2(2s+1)⌉·d bits;
  ω = d/(4s²).
* natural — the exponent kept, the mantissa rounded to a power of two
  stochastically; 9·d bits; ω = 1/8.
* topk<frac> — the ⌈frac·d⌉ largest magnitudes (biased); ⌈frac·d⌉·(32 +
  ⌈log2 d⌉) bits.
* count_sketch<width> — a sign-hashed [depth, width] linear sketch (the
  hashes drawn from the message's key), decoded by the median over the
  depth's rows and a top-k of the ``hh_frac`` heaviest coordinates;
  32·depth·width bits (width clipped to d); ω = d/width.
* minmax<frac> — coordinate i kept with probability min(1, k|x_i|/||x||₁),
  k = ⌈frac·d⌉, and reweighted by its inverse; priced like top-k; ω = d/k.

Dither and top-k run through the fused kernels of
``repro_torch.kernels.compressor`` on a CUDA tensor and through their plain
versions on a CPU tensor; both equal the reference bit for bit.  The dither
uniforms are the reference's own, ``uniform(key, message.shape)`` with each
worker's key ``split(k, n)[i]`` (``repro_torch.random``), so outputs compare
element for element.  ``compress`` draws them with ``random.uniform`` from
the keys it is given; ``compress_split`` on a CUDA tensor hands the parent
key to ``fused_dither_keyed``, which derives the workers' keys and their
uniforms in registers, so no key or uniform reaches device memory.

natural, count_sketch and minmax are plain ``jnp`` in the reference,
outside any Pallas kernel, and plain PyTorch here on either device, on the
reference's key streams: natural and minmax draw ``uniform(key, shape)``,
the count sketch its hashes from ``split(key)``.  The count sketch's
heavy-hitter step is a top-k of the median estimate, through
``fused_topk_grouped`` on the card.  The count sketch's table and
min-max's ℓ1 norm are sums, taken in float64 and rounded once, so the card
(atomics, a tree) and the CPU agree in practice: the float64 sum is exact
while its terms span fewer than about 29 - log2(terms) binary orders, and
otherwise two orders can still round to neighbouring float32 values when
the sum lies next to a float32 midpoint (a double rounding; rare, never
more than one ulp).  XLA's float32 sums round at every term, so against
the reference both are held to a tolerance, their ledgers exactly; natural
is the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.compressor import ops
from repro_torch.kernels.compressor.ref import sign
from repro_torch.kernels.dither import ops as dither_ops

# Family ids, the reference's
FAMILY_IDENTITY = 0
FAMILY_DITHER = 1
FAMILY_NATURAL = 2
FAMILY_TOPK = 3
FAMILY_COUNT_SKETCH = 4
FAMILY_MINMAX = 5

#: Row capacity of the count-sketch table: ``depth`` is clipped to
#: [1, SKETCH_DEPTH_MAX] and the hashes are drawn for all of its rows.
SKETCH_DEPTH_MAX = 7
DEFAULT_SKETCH_WIDTH = 64.0
DEFAULT_SKETCH_DEPTH = 3.0


def _f32(v) -> float:
    return float(np.float32(v))


class SketchParams(NamedTuple):
    """Count-sketch parameters (ignored by the other families): table
    columns ``width`` (clipped to [1, d]), estimator rows ``depth``
    (clipped to [1, SKETCH_DEPTH_MAX]) and the heavy-hitter fraction
    ``hh_frac`` kept on decode (1 keeps every coordinate).  Floats in a
    scalar spec, float32 [G] tensors (or their numpy copies) in a grid
    spec."""
    width: object
    depth: object
    hh_frac: object


def default_sketch_params(G: Optional[int] = None) -> SketchParams:
    """The defaults (width 64, depth 3, hh_frac 1): floats, or float32
    numpy [G] arrays for a grid of G points."""
    vals = (DEFAULT_SKETCH_WIDTH, DEFAULT_SKETCH_DEPTH, 1.0)
    if G is None:
        return SketchParams(*vals)
    return SketchParams(*(np.full(G, v, np.float32) for v in vals))


class CompressorSpec(NamedTuple):
    """(family, s, frac, ..., params): the family id (FAMILY_*), the
    dithering level count s (FAMILY_DITHER), the kept fraction frac
    (FAMILY_TOPK, FAMILY_MINMAX) and the count sketch's
    :class:`SketchParams`, all rounded to float32 as the reference holds
    them.

    A grid spec ([G] points, :func:`stack_specs`, :func:`grid_spec`) holds
    ``family`` as a tuple of G ids, ``s``, ``frac`` and each of ``params``
    as float32 [G] tensors, and ``s_host``, ``frac_host`` and
    ``params_host``, their numpy copies."""
    family: Union[int, Tuple[int, ...]]
    s: Union[float, torch.Tensor]
    frac: Union[float, torch.Tensor]
    s_host: Optional[np.ndarray] = None
    frac_host: Optional[np.ndarray] = None
    params: Optional[SketchParams] = None
    params_host: Optional[SketchParams] = None


def fill_params(spec: CompressorSpec) -> CompressorSpec:
    """A spec without sketch parameters given the defaults (for a grid
    spec, on its device), so every entry point sees one layout."""
    if spec.params is not None:
        return spec
    if not is_grid(spec):
        return spec._replace(params=default_sketch_params())
    host = default_sketch_params(len(spec.family))
    return spec._replace(params=SketchParams(*(
        torch.as_tensor(v, device=spec.s.device) for v in host)),
        params_host=host)


def identity_spec() -> CompressorSpec:
    return CompressorSpec(FAMILY_IDENTITY, 1.0, 1.0,
                          params=default_sketch_params())


def dither_spec(s) -> CompressorSpec:
    """Random ∞-norm dithering with s levels."""
    return CompressorSpec(FAMILY_DITHER, _f32(s), 1.0,
                          params=default_sketch_params())


def natural_spec() -> CompressorSpec:
    """Natural compression (the exponent kept, the mantissa rounded)."""
    return CompressorSpec(FAMILY_NATURAL, 1.0, 1.0,
                          params=default_sketch_params())


def topk_spec(frac) -> CompressorSpec:
    """Biased top-k contraction keeping ⌈frac·d⌉ magnitudes."""
    return CompressorSpec(FAMILY_TOPK, 1.0, _f32(frac),
                          params=default_sketch_params())


def count_sketch_spec(width=DEFAULT_SKETCH_WIDTH, depth=DEFAULT_SKETCH_DEPTH,
                      hh_frac=1.0) -> CompressorSpec:
    """A linear count sketch of ``width`` columns and ``depth`` rows that
    keeps the ``hh_frac`` heaviest coordinates of its estimate."""
    return CompressorSpec(FAMILY_COUNT_SKETCH, 1.0, 1.0,
                          params=SketchParams(_f32(width), _f32(depth),
                                              _f32(hh_frac)))


def minmax_spec(frac) -> CompressorSpec:
    """Unbiased min-max (iceberg) sampling of ~⌈frac·d⌉ coordinates."""
    return CompressorSpec(FAMILY_MINMAX, 1.0, _f32(frac),
                          params=default_sketch_params())


_VALID_NAMES = ("'identity'", "'dither<s>' (e.g. 'dither64')", "'natural'",
                "'topk<frac>' (e.g. 'topk0.1')",
                "'count_sketch<width>' (e.g. 'count_sketch64')",
                "'minmax<frac>' (e.g. 'minmax0.25')")


def _unknown_name(name: str) -> ValueError:
    return ValueError(
        f"unknown compressor name {name!r}; valid names: "
        + ", ".join(_VALID_NAMES)
        + " — numeric suffixes may instead be passed as make_spec keywords")


def make_spec(name_or_spec: Union[str, CompressorSpec, "Compressor"],
              **params) -> CompressorSpec:
    """The compressor constructor: a registry name (``"identity"``,
    ``"dither64"``, ``"natural"``, ``"topk0.1"``, ``"count_sketch64"``,
    ``"minmax0.25"``; the numeric suffix is the family's main parameter,
    which may instead be a keyword: ``s``, ``frac`` or, for the count
    sketch, ``width``, with ``depth`` and ``hh_frac`` beside it), an
    existing spec (given the default sketch parameters where it has none),
    or a :class:`Compressor` (its spec).
    Errors and their messages are the reference's."""
    if isinstance(name_or_spec, CompressorSpec):
        if params:
            raise ValueError(
                "make_spec(spec, **params): keyword parameters only apply "
                "to name-based construction; rebuild the spec instead")
        return fill_params(name_or_spec)
    if isinstance(name_or_spec, Compressor):
        if params:
            raise ValueError(
                "make_spec(compressor, **params): keyword parameters only "
                "apply to name-based construction")
        return fill_params(name_or_spec.spec)
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
    elif name == "natural":
        allowed, ctor = (), natural_spec
    elif name.startswith("count_sketch"):
        allowed = ("width", "depth", "hh_frac")
        suffix_param("count_sketch", int, "width")
        ctor = lambda: count_sketch_spec(**params)            # noqa: E731
    elif name.startswith("dither"):
        allowed = ("s",)
        suffix_param("dither", int, "s")
        ctor = lambda: dither_spec(params.get("s", 64))       # noqa: E731
    elif name.startswith("minmax"):
        allowed = ("frac",)
        suffix_param("minmax", float, "frac")
        ctor = lambda: minmax_spec(params.get("frac", 0.1))   # noqa: E731
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


def _warn_deprecated(old: str, repl: str) -> None:
    warnings.warn(f"compressors.{old} is deprecated; use {repl}",
                  DeprecationWarning, stacklevel=3)


def spec_from_name(name: str) -> CompressorSpec:
    """DEPRECATED alias of :func:`make_spec` (name form)."""
    _warn_deprecated("spec_from_name(name)", "make_spec(name)")
    return make_spec(name)


# ---------------------------------------------------------------------------
# Grid specs: a sweep's [G] axis of compressors
# ---------------------------------------------------------------------------

def is_grid(spec: CompressorSpec) -> bool:
    return isinstance(spec.family, tuple)


def grid_spec(family, s, frac, device="cpu", params=None) -> CompressorSpec:
    """A [G] grid spec from G family ids, levels, fractions and, optionally,
    :class:`SketchParams` of G values each (the defaults where None), all
    rounded to float32, the tensors on ``device``."""
    s_host = np.asarray(s, np.float32).reshape(-1).copy()
    frac_host = np.asarray(frac, np.float32).reshape(-1).copy()
    family = tuple(int(f) for f in family)
    G = len(family)
    if not G == s_host.shape[0] == frac_host.shape[0] >= 1:
        raise ValueError(f"grid spec: {G} families, "
                         f"{s_host.shape[0]} levels, {frac_host.shape[0]} "
                         "fractions")
    if params is None:
        params_host = default_sketch_params(G)
    else:
        params_host = SketchParams(*(np.asarray(v, np.float32).reshape(-1)
                                     .copy() for v in params))
        if any(v.shape[0] != G for v in params_host):
            raise ValueError(f"grid spec: {G} families, sketch params of "
                             f"{[v.shape[0] for v in params_host]} points")

    def t(a):
        return torch.as_tensor(a, device=device)

    return CompressorSpec(family, t(s_host), t(frac_host), s_host, frac_host,
                          SketchParams(*(t(v) for v in params_host)),
                          params_host)


def stack_specs(*specs) -> CompressorSpec:
    """Stack scalar specs (names or specs) into one [G] grid spec whose
    axis may vary the family itself: ``stack_specs("identity", "dither64")``
    is the FLECS-vs-FLECS-CGD comparison as one grid axis."""
    scal = [make_spec(sp) for sp in specs]
    if not scal or any(is_grid(sp) for sp in scal):
        raise ValueError("stack_specs takes one or more scalar specs")
    return grid_spec([sp.family for sp in scal], [sp.s for sp in scal],
                     [sp.frac for sp in scal],
                     params=SketchParams(*zip(*(sp.params for sp in scal))))


def as_grid(spec: CompressorSpec, G: int) -> CompressorSpec:
    """A scalar spec broadcast to a [G] grid spec; a grid spec of G points
    as it is."""
    if is_grid(spec):
        if len(spec.family) != G:
            raise ValueError(f"grid spec of {len(spec.family)} points, "
                             f"expected {G}")
        return spec
    spec = fill_params(spec)
    return grid_spec((spec.family,) * G, [spec.s] * G, [spec.frac] * G,
                     params=SketchParams(*([v] * G for v in spec.params)))


def tile_spec(spec: CompressorSpec, reps: int) -> CompressorSpec:
    """A grid spec's points repeated ``reps`` times (point b·G + g is
    point g): ``jnp.tile`` of every leaf."""
    return grid_spec(spec.family * reps, np.tile(spec.s_host, reps),
                     np.tile(spec.frac_host, reps), spec.s.device,
                     SketchParams(*(np.tile(v, reps)
                                    for v in spec.params_host)))


def spec_point(spec: CompressorSpec, g: int) -> CompressorSpec:
    """Point g of a grid spec as a scalar spec (from the host copies)."""
    return CompressorSpec(spec.family[g], float(spec.s_host[g]),
                          float(spec.frac_host[g]),
                          params=SketchParams(*(float(v[g])
                                                for v in spec.params_host)))


def spec_to(spec: CompressorSpec, device) -> CompressorSpec:
    """A grid spec with its tensors on ``device`` (scalar specs hold no
    tensor)."""
    if not is_grid(spec):
        return spec
    return spec._replace(s=spec.s.to(device), frac=spec.frac.to(device),
                         params=SketchParams(*(v.to(device)
                                               for v in spec.params)))


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


def _select(spec: CompressorSpec, sel) -> CompressorSpec:
    """The points ``sel`` of a grid spec's device tensors (the host copies
    are not carried)."""
    return CompressorSpec(None, spec.s[sel].contiguous(),
                          spec.frac[sel].contiguous(),
                          params=SketchParams(*(v[sel].contiguous()
                                                for v in spec.params)))


# ---------------------------------------------------------------------------
# natural, count_sketch, minmax: plain PyTorch on either device
# ---------------------------------------------------------------------------

def _natural_rows(rows: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``_natural`` of each row of rows [R, L] with its key keys [R, 2]:
    lo = 2^⌊log2 |x|⌋, rounded up to 2·lo with probability (|x| - lo)/lo."""
    ax = rows.abs()
    lo = torch.where(ax > 0, torch.pow(2.0, torch.floor(torch.log2(
        torch.clamp(ax, min=1e-38)))), 0.0)
    p = torch.where(lo > 0, (ax - lo) / lo, 0.0)     # round to 2·lo w.p. p
    u = random.uniform(keys, rows.shape[1:])
    mag = torch.where(u < p, 2.0 * lo, lo)
    return sign(rows) * mag


def _l1(ax: torch.Tensor) -> torch.Tensor:
    """Each row's sum of ax [R, L] (>= 0), [R, 1] float32, summed in
    float64 and rounded once: in practice the float32 result does not
    depend on the order of the sum, so the card's reduction and the CPU's
    agree; where the float64 sum is inexact and lands next to a float32
    midpoint, two orders can round one ulp apart (a double rounding).  The
    reference's float32 sum rounds in XLA's order, an ulp or so from
    either."""
    return ax.sum(dim=1, keepdim=True, dtype=torch.float64).to(torch.float32)


def _minmax_rows(rows: torch.Tensor, keys: torch.Tensor,
                 frac: torch.Tensor) -> torch.Tensor:
    """``_minmax`` of each row of rows [R, L], frac [R, 1]: coordinate i
    kept with probability p_i = min(1, k|x_i|/||x||₁), k = ⌈frac·L⌉, and
    sent as x_i/p_i."""
    L = _f32(rows.shape[1])
    k = torch.clamp(torch.ceil(frac * L), 1.0, L)
    ax = rows.abs()
    p = torch.clamp(k * ax / torch.clamp(_l1(ax), min=1e-30), 0.0, 1.0)
    u = random.uniform(keys, rows.shape[1:])
    return torch.where(u < p, rows / torch.clamp(p, min=1e-30), 0.0)


def _sketch_hashes(keys: torch.Tensor, L: int, width: torch.Tensor):
    """Bucket [R, SKETCH_DEPTH_MAX, L] (int64) and sign (float32) hash
    tables of each row's key (``_sketch_hashes``): ``kb, ks = split(key)``,
    buckets ``randint(kb, (7, L), 0, 2**31 - 1) % clip(⌊width⌋, 1, L)``,
    signs ``rademacher(ks, (7, L))``."""
    kb, ks = random.split(keys, 2).unbind(dim=-2)
    wc = torch.clamp(torch.floor(width).to(torch.int64), 1, L)
    raw = random.randint(kb, (SKETCH_DEPTH_MAX, L), 0, 2**31 - 1)
    return raw % wc[:, None, None], random.rademacher(ks,
                                                      (SKETCH_DEPTH_MAX, L))


def count_sketch_encode(keys: torch.Tensor, rows: torch.Tensor,
                        width: torch.Tensor) -> torch.Tensor:
    """Each row of rows [R, L] sketched into its [SKETCH_DEPTH_MAX, L]
    table with its key's hashes (columns past the clipped width stay
    zero): the reference's ``table.at[rows, bucket].add(sign · x)``, a
    scatter-add, here summed in float64 and rounded once to float32, so
    in practice the table does not depend on the order of the sum (atomics
    on the card, a loop on the CPU), but for a double rounding one ulp
    apart where an inexact float64 sum lands next to a float32 midpoint;
    XLA's float32 sum rounds at every term, an ulp or so from it.  Linear
    in x for a fixed key."""
    bucket, sgn = _sketch_hashes(keys, rows.shape[1], width)
    table = torch.zeros(sgn.shape, dtype=torch.float64, device=rows.device)
    table.scatter_add_(2, bucket, (sgn * rows[:, None, :]).to(torch.float64))
    return table.to(torch.float32)


def count_sketch_decode(keys: torch.Tensor, table: torch.Tensor,
                        width: torch.Tensor, depth: torch.Tensor,
                        hh_frac: torch.Tensor) -> torch.Tensor:
    """Unsketch each row's table [R, SKETCH_DEPTH_MAX, L]: the estimates
    sign·table[row, bucket], their median over the first ⌊depth⌋ rows
    (the rest masked with +inf; rows (dep-1)//2 and dep//2 of the sorted
    estimates), then the heavy hitters: a top-k of the median at hh_frac
    [P] (R = P·n rows, point g's rows at its fraction), through
    ``fused_topk_grouped`` on the card."""
    R, _, L = table.shape
    bucket, sgn = _sketch_hashes(keys, L, width)
    est = sgn * torch.gather(table, 2, bucket)
    dep = torch.clamp(torch.floor(depth).to(torch.int64), 1,
                      SKETCH_DEPTH_MAX)[:, None, None]
    active = torch.arange(SKETCH_DEPTH_MAX, device=table.device)[
        None, :, None] < dep
    srt = torch.sort(torch.where(active, est, torch.inf), dim=1).values
    lo = torch.gather(srt, 1, ((dep - 1) // 2).expand(R, 1, L))[:, 0]
    hi = torch.gather(srt, 1, (dep // 2).expand(R, 1, L))[:, 0]
    med = 0.5 * (lo + hi)
    return ops.fused_topk_grouped(med.contiguous(), hh_frac)[0]


def _count_sketch_rows(rows, keys, params: SketchParams, n: int):
    """Q(x) = decode(encode(x)) of each row; ``params`` of the P points
    ([P] each, R = P·n rows, point g's rows [g·n, (g+1)·n))."""
    width = params.width.repeat_interleave(n)
    table = count_sketch_encode(keys, rows, width)
    return count_sketch_decode(keys, table, width,
                               params.depth.repeat_interleave(n),
                               params.hh_frac)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _plain_rows(family: int, rows, row_keys, sub: CompressorSpec, n: int):
    """natural, min-max or the count sketch of P points' rows [P·n, L]
    with one key a row [P·n, 2] and parameters ``sub`` ([P] tensors)."""
    if family == FAMILY_NATURAL:
        return _natural_rows(rows, row_keys)
    if family == FAMILY_MINMAX:
        return _minmax_rows(rows, row_keys,
                            sub.frac.repeat_interleave(n)[:, None])
    if family == FAMILY_COUNT_SKETCH:
        return _count_sketch_rows(rows, row_keys, sub.params, n)
    raise ValueError(f"unknown compressor family {family}")


def _compress_rows(family: int, rows, keys, sub: CompressorSpec, n: int):
    """One family's P points: rows [P·n, L], their parent keys [P, 2]
    (point g's row i takes ``split(keys[g], n)[i]``) and parameters ``sub``
    ([P] tensors) — one grouped launch on the card for the kernel
    families."""
    if family == FAMILY_IDENTITY:
        return rows
    if family == FAMILY_DITHER:
        return ops.fused_dither_keyed_grouped(rows, keys, sub.s)[0]
    if family == FAMILY_TOPK:
        return ops.fused_topk_grouped(rows, sub.frac)[0]
    return _plain_rows(family, rows, random.split(keys, n).reshape(-1, 2),
                       sub, n)


def _compress_split_grid(spec: CompressorSpec, keys: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """compress_split of each grid point: x [G, n, ...], keys [G, 2]."""
    G, n = x.shape[0], x.shape[1]
    if keys.shape != (G, 2):
        raise ValueError(f"grid compress_split: keys [{G}, 2] required, got "
                         f"{tuple(keys.shape)}")
    spec = fill_params(spec)
    rows = x.reshape(G * n, -1).contiguous()
    groups = _groups(spec.family, x.device)
    if len(groups) == 1:
        out = _compress_rows(groups[0][0], rows, keys.contiguous(), spec, n)
        return out.reshape(x.shape)
    L = rows.shape[1]
    out = rows.clone() if FAMILY_IDENTITY in spec.family else \
        torch.empty_like(rows)
    view = out.view(G, n, L)
    for fam, sel in groups:
        if fam == FAMILY_IDENTITY:
            continue
        sub = rows.view(G, n, L)[sel]
        res = _compress_rows(fam, sub.reshape(-1, L).contiguous(),
                             keys[sel].contiguous(), _select(spec, sel), n)
        view[sel] = res.view(-1, n, L)
    return out.reshape(x.shape)


def compress(spec: CompressorSpec, keys: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Q(x) for each row of x ``[n, ...]``: row i is one whole message,
    compressed with key ``keys[i]`` (``keys`` is ``[n, 2]``).  Returns a
    tensor shaped like x."""
    if spec.family == FAMILY_IDENTITY:
        return x
    spec = fill_params(spec)
    rows = x.reshape(x.shape[0], -1).contiguous()
    if spec.family == FAMILY_DITHER:
        u = random.uniform(keys, rows.shape[1:])     # == _dither's draw
        out = ops.fused_dither(rows, u, spec.s)[0]
    elif spec.family == FAMILY_TOPK:
        out = ops.fused_topk(rows, spec.frac)[0]
    else:                               # as the one point of a grid
        sub = grid_spec((spec.family,), [spec.s], [spec.frac], x.device,
                        spec.params)
        out = _plain_rows(spec.family, rows, keys, sub, rows.shape[0])
    return out.reshape(x.shape)


def compress_split(spec: CompressorSpec, key: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``compress(spec, random.split(key, n), x)`` for x ``[n, ...]``: row
    i is compressed with the i-th key split from ``key`` (``[2]``).  On a
    CUDA tensor the dither family launches the keyed kernel, which splits
    the key and draws the uniforms itself; on the CPU this is exactly that
    call.  Identity and top-k use no key, so they never split one.

    A grid spec of G points takes keys [G, 2] and x [G, n, ...]: point g's
    rows are compressed with ``split(keys[g], n)`` at its own parameters,
    one grouped launch per family of the grid, G = 1 included (identity
    points pass through)."""
    if is_grid(spec):
        return _compress_split_grid(spec, key, x)
    if spec.family in (FAMILY_IDENTITY, FAMILY_TOPK):
        return compress(spec, None, x)
    if spec.family == FAMILY_DITHER and x.device.type == "cuda":
        rows = x.reshape(x.shape[0], -1).contiguous()
        return ops.fused_dither_keyed(rows, key, spec.s)[0].reshape(x.shape)
    return compress(spec, random.split(key, x.shape[0]), x)


def _sketch_bits(width: torch.Tensor, depth: torch.Tensor, d):
    """32·clip(⌊depth⌋, 1, 7)·clip(⌊width⌋, 1, d) in float32, on the
    parameters' device."""
    dep = torch.clamp(torch.floor(depth), 1.0, float(SKETCH_DEPTH_MAX))
    wc = torch.clamp(torch.floor(width), 1.0, _f32(d))
    return 32.0 * dep * wc


def spec_bits(spec: CompressorSpec, d: int,
              device: torch.device) -> torch.Tensor:
    """Exact uplink payload bits of compressing a d-element message, as a
    float32 0-d tensor on ``device`` (the ledger stays on the device).

    identity: 32·d.  dither: ⌈log2(2s+1)⌉·d.  natural: 9·d.  top-k and
    min-max: ⌈frac·d⌉ values, each a 32-bit payload plus a ⌈log2 d⌉-bit
    index.  count sketch: 32·⌊depth⌋·⌊width⌋ counters (width clipped to
    d).  Dither, top-k and min-max are priced by the ledger kernels on a
    CUDA device (min-max by the top-k ledger: the same formula)."""
    spec = fill_params(spec)
    if spec.family in (FAMILY_IDENTITY, FAMILY_NATURAL):
        per = 32.0 if spec.family == FAMILY_IDENTITY else 9.0
        return torch.tensor(float(np.float32(per) * np.float32(d)),
                            dtype=torch.float32, device=device)
    if spec.family == FAMILY_COUNT_SKETCH:
        width, depth = (torch.tensor(v, dtype=torch.float32)
                        for v in spec.params[:2])
        return _sketch_bits(width, depth, d).to(device)
    if spec.family == FAMILY_DITHER:
        return ops.dither_bits(spec.s, d, device)
    if spec.family in (FAMILY_TOPK, FAMILY_MINMAX):
        return ops.topk_bits(spec.frac, d, device)
    raise ValueError(f"unknown compressor family {spec.family}")


def _bits_grid(family: int, sub: CompressorSpec, d, device) -> torch.Tensor:
    if family in (FAMILY_IDENTITY, FAMILY_NATURAL):
        per = 32.0 if family == FAMILY_IDENTITY else 9.0
        return torch.full(sub.s.shape, float(np.float32(per) * np.float32(d)),
                          dtype=torch.float32, device=device)
    if family == FAMILY_DITHER:
        return ops.dither_bits_grouped(sub.s, d)
    if family in (FAMILY_TOPK, FAMILY_MINMAX):
        return ops.topk_bits_grouped(sub.frac, d)
    if family == FAMILY_COUNT_SKETCH:
        return _sketch_bits(sub.params.width, sub.params.depth, d)
    raise ValueError(f"unknown compressor family {family}")


def spec_bits_many(spec: CompressorSpec, d, device=None) -> torch.Tensor:
    """:func:`spec_bits` of each point of a grid spec: float32 [G] on the
    spec's device, one grouped ledger launch per family of the grid, G = 1
    included.  A scalar spec passes straight through to :func:`spec_bits`
    on ``device``."""
    if not is_grid(spec):
        return spec_bits(spec, d, device)
    spec = fill_params(spec)
    dev = spec.s.device
    G = len(spec.family)
    groups = _groups(spec.family, dev)
    if len(groups) == 1:
        return _bits_grid(groups[0][0], spec, d, dev)
    out = torch.empty(G, dtype=torch.float32, device=dev)
    for fam, sel in groups:
        out[sel] = _bits_grid(fam, _select(spec, sel), d, dev)
    return out


def spec_bits_host(spec: CompressorSpec, d) -> np.ndarray:
    """:func:`spec_bits` (or :func:`spec_bits_many`) priced on the host:
    the plain ledger versions on CPU tensors built from the spec's host
    values, so no device value is read.  float32 [G] for a grid spec, 0-d
    for a scalar one.  Budget scan lengths are priced so."""
    if not is_grid(spec):
        return spec_bits(spec, d, "cpu").numpy()
    spec = fill_params(spec)
    return spec_bits_many(grid_spec(spec.family, spec.s_host,
                                     spec.frac_host,
                                     params=spec.params_host), d).numpy()


def _omega(family: int, s, frac, width, d) -> np.float32:
    d = np.float32(d)
    one = np.float32(1.0)
    if family == FAMILY_DITHER:
        return d / (np.float32(4.0) * np.float32(s) * np.float32(s))
    if family == FAMILY_NATURAL:
        return np.float32(1.0 / 8.0)
    if family == FAMILY_COUNT_SKETCH:
        return d / np.clip(np.floor(np.float32(width)), one, d)
    if family == FAMILY_MINMAX:
        return d / np.clip(np.ceil(np.float32(frac) * d), one, d)
    if family in (FAMILY_IDENTITY, FAMILY_TOPK):
        return np.float32(0.0)
    raise ValueError(f"unknown compressor family {family}")


def spec_omega(spec: CompressorSpec, d) -> torch.Tensor:
    """Variance bound ω of Definition 3, in float32 from the host values:
    0 for identity and for top-k (biased, not in U(ω)), d/(4s²) for
    dither, 1/8 for natural, d/⌊width⌋ for the count sketch (at hh_frac =
    1), d/⌈frac·d⌉ for min-max.  0-d for a scalar spec, [G] (CPU) for a
    grid spec."""
    spec = fill_params(spec)
    if not is_grid(spec):
        return torch.tensor(float(_omega(spec.family, spec.s, spec.frac,
                                         spec.params.width, d)))
    return torch.tensor([float(_omega(f, s, fr, w, d)) for f, s, fr, w in
                         zip(spec.family, spec.s_host, spec.frac_host,
                             spec.params_host.width)], dtype=torch.float32)


def spec_commutes_with_sum(spec: CompressorSpec):
    """Whether partial sums may be aggregated in the compressed domain
    (the encoding is linear): identity and the count sketch.  A bool, or
    a bool [G] tensor for a grid spec."""
    linear = (FAMILY_IDENTITY, FAMILY_COUNT_SKETCH)
    if not is_grid(spec):
        return spec.family in linear
    return torch.tensor([f in linear for f in spec.family])


# ---------------------------------------------------------------------------
# Static wrapper (the registry veneer over the spec entry points)
# ---------------------------------------------------------------------------

#: Families whose wire price is not linear in d (``bits_per_value``).
_DIM_DEPENDENT_FAMILIES = (FAMILY_TOPK, FAMILY_COUNT_SKETCH, FAMILY_MINMAX)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A named scalar spec; ``compress``, ``bits`` and ``omega`` go through
    the spec entry points, so a Compressor and its spec compute alike."""
    name: str
    spec: CompressorSpec
    unbiased: bool = True

    def compress(self, key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Q(x) of one whole message x with key ``key`` ([2])."""
        return compress(self.spec, key.unsqueeze(0), x.unsqueeze(0))[0]

    def bits(self, d) -> float:
        """Total payload bits of a d-element message (dimension-aware)."""
        return float(spec_bits(self.spec, d, "cpu"))

    @property
    def bits_per_value(self) -> float:
        """DEPRECATED per-element price, defined only for the families
        whose wire size is linear in d (identity, dither, natural)."""
        warnings.warn(
            "Compressor.bits_per_value is deprecated; .bits(d) is the "
            "single wire-price query (see the compressors module "
            "docstring)", DeprecationWarning, stacklevel=2)
        if int(self.spec.family) in _DIM_DEPENDENT_FAMILIES:
            raise ValueError(
                f"{self.name}: wire size is dimension-dependent "
                "(top-k/min-max pay (32 + ceil(log2 d)) bits per kept "
                "value; a count sketch pays its depth*width accumulator); "
                "use .bits(d)")
        return float(spec_bits(self.spec, 1, "cpu"))

    def omega(self, d: int) -> float:
        return float(spec_omega(self.spec, d))


def identity() -> Compressor:
    return Compressor("identity", identity_spec())


def random_dithering(s: int = 64) -> Compressor:
    """∞-norm random dithering with s levels; ω = d/(4s²)."""
    return Compressor(f"dither{s}", dither_spec(s))


def natural() -> Compressor:
    return Compressor("natural", natural_spec())


def top_k(frac: float = 0.1) -> Compressor:
    """Biased top-k contraction."""
    return Compressor(f"topk{frac}", topk_spec(frac), unbiased=False)


def count_sketch(width: int = 64, depth: int = 3,
                 hh_frac: float = 1.0) -> Compressor:
    """Linear count sketch; unbiased at hh_frac = 1."""
    return Compressor(f"count_sketch{width}",
                      count_sketch_spec(width, depth, hh_frac),
                      unbiased=hh_frac >= 1.0)


def min_max(frac: float = 0.1) -> Compressor:
    """Unbiased min-max sampling at kept fraction ``frac``."""
    return Compressor(f"minmax{frac}", minmax_spec(frac))


def get_compressor(name: str) -> Compressor:
    """DEPRECATED alias: a :class:`Compressor` from a registry name."""
    _warn_deprecated("get_compressor(name)",
                     "make_spec(name) or the Compressor factories")
    return Compressor(name, make_spec(name),
                      unbiased=not name.startswith("topk"))


def as_spec(c) -> CompressorSpec:
    """DEPRECATED alias of :func:`make_spec` (pass-through form)."""
    _warn_deprecated("as_spec(c)", "make_spec(c)")
    return make_spec(c)


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
