"""Stable key-sort + compaction of planar payload tables.

Port of ``smallvcm_tpu/ops/hashgrid.py::sort_compact_planes``, the one
piece of the hash grid the photon merge uses. ``torch.sort(stable=True)``
on the key gives the same permutation as the JAX package's ``(key, iota)``
sort: ties keep source order, which is the stable counting sort the
reference builds imperatively (hashgrid.hxx:67-88).
"""

from __future__ import annotations

import torch


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
