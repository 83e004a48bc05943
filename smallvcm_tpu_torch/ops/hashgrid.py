"""Fixed-radius neighbour search: cell-hashed photon index + pair expansion.

Port of the pieces of ``smallvcm_tpu/ops/hashgrid.py`` the merges use.
The reference HashGrid (hashgrid.hxx:32-214) counting-sorts particle
indices into per-cell CSR ranges and probes the 2x2x2 cell neighbourhood
nearest each query (hashgrid.hxx:124-138). Here:

* :func:`sort_compact_planes` orders a keyed table with
  ``torch.sort(stable=True)`` and keeps its first rows: ties keep source
  order, which is the stable counting sort the reference builds
  imperatively (hashgrid.hxx:67-88). The JAX package's packed-radix
  argsort is not ported: a stable sort is one call here.
* :func:`_hash_cell` is the reference's spatial hash; :func:`expand_pairs`
  turns per-query CSR ranges into an explicit (query, photon) candidate
  list, in query-range chunks (:func:`query_chunks`).

The pair merge (algorithms/vcm.py::merge_stage) hashes with
:func:`_hash_cell` and compacts with :func:`sort_compact_planes`; the cell
merge (ops/merge.py) compacts with :func:`sort_compact_planes` on the CPU
only (its preparation on a card is ``csrc/merge_prep.cu``, which sorts the
live slots' int32 keys itself), and its plain walk expands its ranges with
:func:`query_chunks` and :func:`expand_pairs`.

Cell coordinates may be negative (queries just outside the photon bbox).
The JAX package casts them to uint32 and multiplies modulo 2**32; in int64
that is a mask after the cast and after each product.
"""

from __future__ import annotations

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


def _hash_cell(cx, cy, cz, num_cells: int):
    """Spatial hash, same constants as hashgrid.hxx:179-187, on the uint32
    images of the (possibly negative) integer cell coordinates."""
    u = lambda c, k: ((c & _MASK) * k) & _MASK
    return (u(cx, 73856093) ^ u(cy, 19349663) ^ u(cz, 83492791)) % num_cells


def inv_cell_size(radius) -> float:
    """1 / (radius * 2) rounded in f32, as the JAX package computes it."""
    return float(np.float32(1.0)
                 / (np.float32(float(radius)) * np.float32(2.0)))


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
