"""Fixed-radius neighbour search: cell-hashed photon index + pair expansion.

Port of ``smallvcm_tpu/ops/hashgrid.py``. The reference HashGrid
(hashgrid.hxx:32-214) counting-sorts particle indices into per-cell CSR
ranges and probes the 2x2x2 cell neighbourhood nearest each query
(hashgrid.hxx:124-138). Here:

* :func:`build` keys every particle by its cell hash (invalid ones by the
  sentinel cell ``num_cells``) and ``torch.sort(stable=True)`` orders them;
  ties keep source order, which is the stable counting sort the reference
  builds imperatively (hashgrid.hxx:67-88). The JAX package's packed-radix
  argsort is not ported: a stable sort is one call here.
* :func:`query_cell_ranges` gives each query the (start, count) of its 8
  probed cells, and :func:`expand_pairs` turns those CSR ranges into an
  explicit (query, photon) candidate list whose length is the actual
  candidate count, not a padded cell capacity.

The pair-expansion merge (algorithms/vcm.py::merge_stage) is built from
:func:`build`, :func:`query_cell_ranges`, :func:`query_chunks` and
:func:`expand_pairs`; the cell merge (ops/merge.py) uses
:func:`sort_compact_planes`, and its plain version :func:`query_chunks` and
:func:`expand_pairs`.

Cell coordinates may be negative (queries just outside the photon bbox).
The JAX package casts them to uint32 and multiplies modulo 2**32; in int64
that is a mask after the cast and after each product.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF

# Pair expansion works in query-range chunks of at most this many candidate
# pairs (about 2 GB of int64/f32 pair arrays), as the JAX package's render
# loop bounds its pair arrays at 16M rows (render.py:419-424).
MAX_PAIRS = 1 << 24


def sort_compact_planes(keys, planes, cap: int):
    """Stable key-sort + compaction of a planar payload table in one shot.

    ``keys``: integer [M]; dead slots must carry a sentinel key strictly
    above every live key so they sort last (slicing the first ``cap``
    sorted slots IS the compaction). ``planes``: [P, M] payload.
    Returns ``(planes_sorted [P, cap], src [cap] int64)`` where ``src`` is
    the flat source index of each compacted slot. When ``cap > M`` the
    tail repeats the last sorted column (a dead slot whenever any slot is
    dead), as the JAX version pads.
    """
    m = keys.shape[0]
    _, src = torch.sort(keys, stable=True)
    if cap > m:
        src = torch.cat([src, src[m - 1:].expand(cap - m)])
    else:
        src = src[:cap]
    return planes[:, src], src


class HashGrid(NamedTuple):
    bbox_min_x: torch.Tensor
    bbox_min_y: torch.Tensor
    bbox_min_z: torch.Tensor
    bbox_max_x: torch.Tensor
    bbox_max_y: torch.Tensor
    bbox_max_z: torch.Tensor
    inv_cell_size: float         # 1 / (2 r), rounded in f32
    sorted_idx: torch.Tensor     # [M] particle index ordered by cell hash
    cell_start: torch.Tensor     # [C]
    cell_count: torch.Tensor     # [C]
    max_occupancy: torch.Tensor  # scalar (diagnostic)


def _hash_cell(cx, cy, cz, num_cells: int):
    """Spatial hash, same constants as hashgrid.hxx:179-187, on the uint32
    images of the (possibly negative) integer cell coordinates."""
    u = lambda c, k: ((c & _MASK) * k) & _MASK
    return (u(cx, 73856093) ^ u(cy, 19349663) ^ u(cz, 83492791)) % num_cells


def inv_cell_size(radius) -> float:
    """1 / (radius * 2) rounded in f32, as the JAX package computes it."""
    return float(np.float32(1.0)
                 / (np.float32(float(radius)) * np.float32(2.0)))


def build(pos, valid, radius, num_cells: int) -> HashGrid:
    """Build over V3-of-[M] positions with validity mask. Cell = 2*radius
    (hashgrid.hxx:64); invalid particles land in a sentinel cell."""
    big = 1e36
    mins = [torch.where(valid, a, big).min() for a in pos]
    maxs = [torch.where(valid, a, -big).max() for a in pos]
    inv_cell = inv_cell_size(radius)
    h = _hash_cell(*(torch.floor((a - mn) * inv_cell).long()
                     for a, mn in zip(pos, mins)), num_cells)
    h = torch.where(valid, h, num_cells)  # sentinel

    order = torch.sort(h, stable=True).indices
    counts = torch.bincount(h[valid], minlength=num_cells)
    start = torch.cumsum(counts, 0) - counts
    return HashGrid(
        bbox_min_x=mins[0], bbox_min_y=mins[1], bbox_min_z=mins[2],
        bbox_max_x=maxs[0], bbox_max_y=maxs[1], bbox_max_z=maxs[2],
        inv_cell_size=inv_cell,
        sorted_idx=order,
        cell_start=start,
        cell_count=counts,
        max_occupancy=counts.max(),
    )


# 22 bits for the sorted-array start + 10 bits for the per-cell count, as
# the JAX package packs them.
_COUNT_BITS = 10


def packed_ranges(grid: HashGrid):
    """(start << COUNT_BITS | count) per cell: one gather per probed cell
    in :func:`query_cell_ranges` instead of two."""
    count = grid.cell_count.clamp_max((1 << _COUNT_BITS) - 1)
    return (grid.cell_start << _COUNT_BITS) | count


def query_cell_ranges(grid: HashGrid, num_cells: int, qpos, packed=None):
    """Per-query (start, count) of the 8 probed cells.

    qpos: V3 of [Q]. Returns (starts [Q, 8], counts [Q, 8]). Queries outside
    the particle bbox padded by the search radius probe nothing
    (hashgrid.hxx:116-122; the pad keeps same-plane f32 hit points that sit
    ulps outside the tight bbox). Pass ``packed_ranges(grid)`` to fetch
    both values with one gather per cell.
    """
    pad = float(np.float32(0.5) / np.float32(grid.inv_cell_size))
    mins = (grid.bbox_min_x, grid.bbox_min_y, grid.bbox_min_z)
    maxs = (grid.bbox_max_x, grid.bbox_max_y, grid.bbox_max_z)
    in_bbox = torch.ones_like(qpos.x, dtype=torch.bool)
    for a, mn, mx in zip(qpos, mins, maxs):
        in_bbox = in_bbox & (a >= mn - pad) & (a <= mx + pad)
    rel = [(a - mn) * grid.inv_cell_size for a, mn in zip(qpos, mins)]
    base = [torch.floor(r).long() for r in rel]
    # Nearest 2x2x2 neighbourhood: the side of the cell centre each
    # coordinate lies on (hashgrid.hxx:124-138).
    side = [torch.where(r - torch.floor(r) < 0.5, -1, 1) for r in rel]

    starts, counts = [], []
    for bit in range(8):
        hc = _hash_cell(*(b + (s if bit & (1 << k) else 0)
                          for k, (b, s) in enumerate(zip(base, side))),
                        num_cells)
        if packed is not None:
            p = packed[hc]
            s = p >> _COUNT_BITS
            c = p & ((1 << _COUNT_BITS) - 1)
        else:
            s = grid.cell_start[hc]
            c = grid.cell_count[hc]
        starts.append(s)
        counts.append(torch.where(in_bbox, c, 0))
    return torch.stack(starts, dim=1), torch.stack(counts, dim=1)


def compact_indices(valid, cap: int):
    """Stream-compact a validity mask into source indices.

    Returns (idx [cap] — flat source index per compacted slot, zero beyond
    the live range; count scalar; overflow scalar)."""
    m = valid.shape[0]
    pos = torch.cumsum(valid.long(), 0) - 1
    count = valid.long().sum()
    dst = torch.where(valid & (pos < cap), pos, cap)  # dropped -> spare slot
    idx = torch.zeros((cap + 1,), dtype=torch.int64, device=valid.device)
    idx = idx.scatter(0, dst, torch.arange(m, device=valid.device))
    return idx[:cap], count, (count - cap).clamp_min(0)


def query_chunks(per_query, max_pairs: int = MAX_PAIRS):
    """Split the queries into consecutive ranges of at most ``max_pairs``
    candidate pairs (one host read; a query with more pairs than that is a
    chunk of its own).

    per_query: [Q] candidate count of each query. Returns the list of
    non-empty ``(q0, q1, c0, c1)``: queries [q0, q1) hold candidates
    [c0, c1) of the concatenated pair list.
    """
    dev = per_query.device
    cum = torch.cumsum(per_query, 0)
    total = int(cum[-1]) if cum.shape[0] else 0
    if total == 0:
        return []
    n_chunks = -(-total // max_pairs)
    ends = torch.searchsorted(
        cum, torch.arange(1, n_chunks, device=dev) * max_pairs, right=True)
    ends = torch.cat([ends, torch.full((1,), per_query.shape[0], device=dev)])
    cum0 = torch.cat([torch.zeros((1,), dtype=cum.dtype, device=dev), cum])
    q1s, c1s = torch.stack([ends, cum0[ends]]).tolist()
    return [c for c in zip([0, *q1s[:-1]], q1s, [0, *c1s[:-1]], c1s)
            if c[3] > c[2]]


def expand_pairs(starts, counts, pair_cap: int):
    """Expand per-(query, cell) CSR ranges into an explicit pair list.

    starts/counts: [Q, K] (K cells or cell ranges per query). Returns
    (qc_idx [pair_cap], photon_pos [pair_cap], pair_valid [pair_cap], total
    scalar, overflow scalar) where qc_idx indexes the flattened [Q*K]
    (query, cell) axis and photon_pos the grid's sorted order. Segment ids
    come from a scatter-max
    of each non-empty segment's id at its start offset carried forward by
    a cumulative max (empty segments never scatter; coinciding starts keep
    the max, whose preceding segments are empty there).
    """
    dev = counts.device
    qc = counts.reshape(-1)
    st = starts.reshape(-1)
    per_q = counts.sum(1)
    base = torch.cumsum(per_q, 0) - per_q
    prefix = torch.cumsum(counts, 1) - counts
    offs = (base[:, None] + prefix).reshape(-1)
    total = base[-1] + per_q[-1]
    overflow = (total - pair_cap).clamp_min(0)

    seg_id = torch.where(qc > 0, torch.arange(qc.shape[0], device=dev), 0)
    keep = offs < pair_cap
    seg_first = torch.zeros((pair_cap,), dtype=torch.int64, device=dev)
    seg_first = seg_first.scatter_reduce(0, offs[keep], seg_id[keep], "amax")
    qc_idx = torch.cummax(seg_first, 0).values

    p = torch.arange(pair_cap, device=dev)
    rank = p - offs[qc_idx]
    photon_pos = st[qc_idx] + rank
    pair_valid = (p < total) & (rank < qc[qc_idx]) & (rank >= 0)
    return qc_idx, photon_pos, pair_valid, total, overflow
