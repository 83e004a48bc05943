"""Batched ray-scene intersection over planar (SoA) vectors.

Port of ``smallvcm_tpu/ops/intersect.py``. The closest-hit sweep itself is
:func:`.sweep.sweep`: the plain dense [N, P] sweep on every device, as
is :func:`occluded`.
Hit attributes (material, normal, light id) are resolved here from the
winning primitive index with small-table gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec3 import V3, normalize, v3_where
from ..scene.scene import SceneData
from .sweep import BIG_DIST, occluded_plain, occlusion_operands, sweep


class Hit(NamedTuple):
    hit: torch.Tensor       # [N] bool
    dist: torch.Tensor      # [N]
    mat_id: torch.Tensor    # [N] int64
    light_id: torch.Tensor  # [N] int64, -1 when the hit is not emissive
    normal: V3              # V3 of [N]


def intersect(scene: SceneData, org: V3, direction: V3) -> Hit:
    """Closest hit over all primitives; org/direction V3 of [N]."""
    best_t, best = sweep(scene, org, direction)
    return resolve_hit(scene, org, direction, best_t, best)


def resolve_hit(scene: SceneData, org: V3, direction: V3,
                best_t, best) -> Hit:
    """Closest-hit attribute resolution (material/normal/light) from the
    winning primitive index (tri-major, -1 or any index on a miss — every
    attribute is masked by ``hit``)."""
    hit = best_t < BIG_DIST

    num_tris = scene.tri_mat.shape[0]
    is_tri = best < num_tris
    tri_idx = best.clamp(0, num_tris - 1)

    mat_id = scene.tri_mat[tri_idx].long()
    normal = scene.tri_normal[tri_idx]

    if scene.sph_mat.shape[0] > 0:
        sph_idx = (best - num_tris).clamp(0, scene.sph_mat.shape[0] - 1)
        # Clamp miss-lane distances before forming the sphere normal:
        # squaring 1e36 overflows and normalize(0-ish) would NaN.
        t_safe = torch.where(hit, best_t, 1.0)
        hit_p = org + direction * t_safe
        normal_sph = normalize(hit_p - scene.sph_center[sph_idx])
        mat_id = torch.where(is_tri, mat_id, scene.sph_mat[sph_idx].long())
        normal = v3_where(is_tri, normal, normal_sph)

    light_id = torch.where(hit, scene.mat_to_light[mat_id].long(), -1)
    mat_id = torch.where(hit, mat_id, -1)
    return Hit(hit=hit, dist=best_t, mat_id=mat_id, light_id=light_id,
               normal=normal)


def occluded(scene: SceneData, point: V3, direction: V3, dist,
             active=None) -> torch.Tensor:
    """Shadow-ray test replicating scene.hxx:72-85 exactly: origin offset by
    EPS_RAY along the direction, max distance shortened by 2*EPS_RAY.

    ``nearest hit < tmax`` is the same predicate as the XLA sweep's
    ``any(t < tmax)`` over primitives. ``active`` (bool, None = every lane)
    is the caller's mask: the answer is ``active & blocked``, and the
    kernel tests nothing on an inactive lane. Operands broadcast; a point
    that is only broadcast along leading dimensions is not materialised.
    A boolean has no gradient, so the rays go in detached."""
    if active is None:
        active = torch.ones((), dtype=torch.bool, device=dist.device)
    shape, *flat = occlusion_operands(point, direction, dist, active)
    return occluded_plain(scene, *flat).reshape(shape)
