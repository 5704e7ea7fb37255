"""Two-tier hierarchical aggregation: edge aggregators under one server
(counterpart of ``repro.core.hierarchy``).

Clients report to ``n_edges`` edge aggregators (contiguous id blocks,
:func:`edge_of`); each round every edge forms the masked partial sum of its
active clients' (already worker-compressed) messages, re-compresses it with
the edge-tier ``CompressorSpec`` and ships one message to the server, which
sums the edges and normalizes by the global active count.  With an identity
edge spec that is the flat ``driver.masked_mean`` algebra up to the order
of the sums.

Billing is two-tier: ``bits_per_node`` keeps charging the uplink (client to
edge, priced by the worker compressor); the [n_edges] ``edge_bits`` ledger
(``driver.bits_dtype()``) charges the backhaul (edge to server,
:func:`edge_round_bits`).  An edge with no active client ships and pays
nothing.

The functions take a sweep's [G] grid: x [G, n, ...], mask [G, n], keys
[G, 2] and a grid edge spec (the reference ``vmap``s its per-point
functions), or the reference's unbatched arguments (x [n, ...], mask [n],
a key [2], a scalar spec), which run as a [1] grid.

Re-compression: the [G, E, ...] partial sums go through
``compressors.compress_split`` on the grid edge spec, point g's edge e
with ``split(keys[g], E)[e]`` (the grouped compressor entries on the card).
A point whose edge family is the count sketch (the reference's
``lax.cond``) encodes every edge with the point's one key, sums the
[depth, width] tables over its active edges and decodes once: that equals
flat compression of the summed message, since the encode is linear.

The sums — each edge's partial sum of its clients, and the server's sum of
the edges — are taken in float64 and rounded once to float32 (as
``count_sketch_encode``'s table), so the card's atomics and the CPU's loop
agree but for a double rounding next to a float32 midpoint, and two runs on
the card give the same bits.  XLA's float32 sums round at every term: the
reference is an ulp or so from either.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.compressors import (FAMILY_COUNT_SKETCH,
                                          FAMILY_IDENTITY, CompressorSpec,
                                          _groups, _select, as_grid,
                                          compress_split, grid_spec,
                                          count_sketch_decode,
                                          count_sketch_encode, fill_params,
                                          is_grid, spec_bits_many, spec_to)
from repro_torch.core.driver import bits_dtype

#: fold_in salt of the edge tier's compressor keys: backhaul randomness
#: never aliases the worker-tier draws (as ``driver.ASYNC_SALT`` and
#: ``driver.COHORT_SALT``).
EDGE_SALT = 0xED6E


@dataclasses.dataclass(frozen=True)
class HierarchyConfig:
    """The server tree's static shape: ``n_edges`` aggregators (dividing
    the worker count) and the default edge-tier compressor, which
    ``flecs.hparams_from_config`` uses where no ``edge_levels`` axis
    overrides it ("identity" bills the backhaul at full float width)."""
    n_edges: int
    edge_compressor: str = "identity"

    def __post_init__(self):
        if self.n_edges < 1:
            raise ValueError(f"n_edges must be >= 1, got {self.n_edges}")


def validate_hierarchy(hier: HierarchyConfig, n_workers: int) -> None:
    """Contiguous-block assignment needs n_edges | n_workers."""
    if n_workers % hier.n_edges:
        raise ValueError(
            f"n_edges={hier.n_edges} must divide the worker count "
            f"{n_workers} (clients are assigned to edges in contiguous "
            f"id blocks)")


def edge_of(ids: torch.Tensor, n_total: int, n_edges: int) -> torch.Tensor:
    """Client id -> edge id (contiguous blocks of n_total // n_edges),
    int64."""
    return torch.div(torch.as_tensor(ids).to(torch.int64),
                     n_total // n_edges, rounding_mode="floor")


def init_edge_bits(n_edges: int, device=None) -> torch.Tensor:
    """[n_edges] backhaul ledger, in the shared ledger dtype."""
    return torch.zeros((n_edges,), dtype=bits_dtype(), device=device)


def edge_round_bits(edge_spec: CompressorSpec, d: int, m: int,
                    device=None) -> torch.Tensor:
    """Backhaul bits one active edge ships in one FLECS round: the combined
    gradient [d], sketched-Hessian [d, m] and curvature [m, m] sums, each
    priced by the edge spec (dimension-aware), added in the reference's
    order.  [G] for a grid spec (the grouped ledger kernels on the card),
    0-d on ``device`` for a scalar one."""
    return (spec_bits_many(edge_spec, d, device)
            + spec_bits_many(edge_spec, d * m, device)
            + spec_bits_many(edge_spec, m * m, device))


def charge_edges(edge_bits: torch.Tensor, edge_active: torch.Tensor,
                 price) -> torch.Tensor:
    """Accumulate the backhaul ledger: an edge pays ``price`` iff at least
    one of its clients took part this round.  edge_bits and edge_active
    [..., E]; price a number, a 0-d tensor or [G] (one a grid point)."""
    price = torch.as_tensor(price, dtype=edge_bits.dtype,
                            device=edge_bits.device)
    if price.dim() == 1 and edge_bits.dim() == 2:
        price = price[:, None]
    return edge_bits + (edge_active > 0).to(edge_bits.dtype) * price


def _sum64(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` in float64, rounded once to float32."""
    return x.sum(dim=dim, dtype=torch.float64).to(torch.float32)


def _gate(edge_active: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return (edge_active > 0).reshape(edge_active.shape
                                     + (1,) * (like.dim() - 2))


def _sketch_sum(spec: CompressorSpec, keys: torch.Tensor,
                partial: torch.Tensor, edge_active: torch.Tensor):
    """The count-sketch points: each edge's partial [P, E, ...] encoded
    with its point's one key, the tables of the active edges summed, one
    decode a point."""
    P, E = partial.shape[:2]
    L = partial[0, 0].numel()
    rows = partial.reshape(P * E, L).contiguous()
    width = spec.params.width
    enc = count_sketch_encode(keys.repeat_interleave(E, dim=0), rows,
                              width.repeat_interleave(E))
    enc = enc.view(P, E, *enc.shape[1:])
    table = _sum64(torch.where(_gate(edge_active, enc), enc,
                               torch.zeros((), device=enc.device)), 1)
    dec = count_sketch_decode(keys, table, width, spec.params.depth,
                              spec.params.hh_frac)
    return dec.reshape((P,) + partial.shape[2:])


def _recompress(spec: CompressorSpec, keys: torch.Tensor,
                partial: torch.Tensor, edge_active: torch.Tensor):
    """Point g's edge e compressed with ``split(keys[g], E)[e]``, idle
    edges zeroed, the edges summed."""
    q = compress_split(spec, keys, partial)
    return _sum64(torch.where(_gate(edge_active, q), q,
                              torch.zeros((), device=q.device)), 1)


def _combine_compressed(edge_spec: CompressorSpec, keys: torch.Tensor,
                        partial: torch.Tensor,
                        edge_active: torch.Tensor) -> torch.Tensor:
    """The top tier over a [G] grid: re-compress the per-edge partial sums
    [G, E, ...], zero the idle edges (nothing was sent) and sum into the
    server total [G, ...]; the count-sketch points take the sketch-domain
    path.  In a grid mixing them, one ``compress_split`` of the whole grid
    serves the other points (the sketch points pass through it as
    identity), so each round's edge call covers every point."""
    spec = fill_params(edge_spec)
    if FAMILY_COUNT_SKETCH not in spec.family:
        return _recompress(spec, keys, partial, edge_active)
    if set(spec.family) == {FAMILY_COUNT_SKETCH}:
        return _sketch_sum(spec, keys, partial, edge_active)
    plain = grid_spec(tuple(FAMILY_IDENTITY if f == FAMILY_COUNT_SKETCH
                            else f for f in spec.family),
                      spec.s_host, spec.frac_host, spec.s.device,
                      spec.params_host)
    out = _recompress(plain, keys, partial, edge_active)
    sel = dict(_groups(spec.family, partial.device))[FAMILY_COUNT_SKETCH]
    out[sel] = _sketch_sum(_select(spec, sel), keys[sel], partial[sel],
                           edge_active[sel])
    return out


def _as_grid_call(fn, edge_spec, key, x, mask, *rest):
    """Run a grid function on the reference's unbatched arguments (a
    scalar spec, key [2], x [n, ...], mask [n]) as a [1] grid."""
    if is_grid(edge_spec):
        return fn(edge_spec, key, x, mask, *rest)
    rest = tuple(r.unsqueeze(0) if isinstance(r, torch.Tensor) else r
                 for r in rest)
    total, active = fn(spec_to(as_grid(edge_spec, 1), x.device),
                       key.unsqueeze(0),
                       x.unsqueeze(0), mask.unsqueeze(0), *rest)
    return total[0], active[0]


def edge_combine(edge_spec: CompressorSpec, keys: torch.Tensor,
                 x: torch.Tensor, mask: torch.Tensor, n_edges: int):
    """Two-tier masked sum over the full worker axis: x [G, n, ...], mask
    [G, n] -> (combined sum [G, ...], edge_active [G, E]).  Each contiguous
    block of n // n_edges clients masked-sums locally, the partial is
    edge-compressed, idle edges contribute exact zeros, and the server sums
    the edges.  Dividing by ``max(sum(mask), 1)`` (the caller's) gives the
    hierarchical mean."""
    return _as_grid_call(_edge_combine, edge_spec, keys, x, mask, n_edges)


def _edge_combine(edge_spec, keys, x, mask, n_edges):
    G, n = mask.shape
    blk = n // n_edges
    lead = mask.shape + (1,) * (x.dim() - 2)
    xm = (mask.reshape(lead) * x).reshape((G, n_edges, blk) + x.shape[2:])
    partial = _sum64(xm, 2)                                 # [G, E, ...]
    edge_active = torch.sum(mask.reshape(G, n_edges, blk), dim=-1)
    return (_combine_compressed(edge_spec, keys, partial, edge_active),
            edge_active)


def edge_combine_cohort(edge_spec: CompressorSpec, keys: torch.Tensor,
                        x: torch.Tensor, mask: torch.Tensor,
                        ids: torch.Tensor, n_total: int, n_edges: int):
    """Two-tier masked sum over a sampled cohort, O(cohort) + O(E): x
    [G, K, ...] are the cohort's rows and ``ids`` ([K] or [G, K]) their
    population ids; each row adds into its edge's partial (a float64
    ``index_add_``, rounded once: deterministic for any order of the
    adds), no [n_total] intermediate is made.  Same compression and zeroing
    tier as :func:`edge_combine`."""
    return _as_grid_call(_edge_combine_cohort, edge_spec, keys, x, mask,
                         ids, n_total, n_edges)


def _edge_combine_cohort(edge_spec, keys, x, mask, ids, n_total, n_edges):
    G, K = mask.shape
    eids = edge_of(ids, n_total, n_edges).expand(G, K)
    flat = (eids + n_edges * torch.arange(G, device=eids.device)[:, None]
            ).reshape(-1)
    lead = mask.shape + (1,) * (x.dim() - 2)
    rows = (mask.reshape(lead) * x).reshape(G * K, -1).to(torch.float64)
    partial = torch.zeros((G * n_edges, rows.shape[1]), dtype=torch.float64,
                          device=x.device).index_add_(0, flat, rows)
    partial = partial.to(torch.float32).reshape((G, n_edges) + x.shape[2:])
    edge_active = torch.zeros(G * n_edges, dtype=torch.float32,
                              device=x.device).index_add_(
        0, flat, mask.reshape(-1)).reshape(G, n_edges)
    return (_combine_compressed(edge_spec, keys, partial, edge_active),
            edge_active)
