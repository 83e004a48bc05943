"""Ray sweeps, plain PyTorch only (closest hit, and any hit for shadow
rays): the benchmark's frozen copy of the port's plain versions, with the
packed scene block and the CUDA kernels taken out.

Port of ``smallvcm_tpu/ops/pallas_intersect.py``. Every ray tests every
primitive (SmallVCM has no acceleration structure, geometry.hxx:55-104):
triangles first with the two-sided three-sign test and
t = n.(p0 - o) / n.d, then spheres with the stable f32 quadratic. A strict
``t < best`` keeps the lowest primitive index on ties, which is also what
``argmin`` over the concatenated [N, T+S] distances picks.

:func:`sweep` takes the plain version on every device. Occlusion
(:func:`occluded_plain`) is the same sweep's ``min_k t_k < tmax`` on the
active lanes.
"""

from __future__ import annotations

import torch

from ..core.vec3 import V3, cross, dot
from ..core.vecmath import EPS_RAY

BIG_DIST = 1e36


# Capacity and layout of the packed scene block (csrc/intersect_sweep.cu:
# kMaxTri, kMaxSph, kTriFloats, kSphFloats): 12 floats per triangle (p0
# xyz | p1 xyz | p2 xyz | normal xyz), then 4 per sphere (centre xyz |
# radius). SmallVCM's four scenes have at most 20 triangles and 2 spheres.


# id of the first geometry tensor -> (weak references to all of them,
# packed block); the entry goes when that tensor does.


# ---------------------------------------------------------------------------
# Plain PyTorch version: dense [N, P] broadcasts (ops/intersect.py's sweep)
# ---------------------------------------------------------------------------


def tri_distances(scene, org: V3, direction: V3):
    """Per-(ray, triangle) hit distance, BIG_DIST when missed -> [N, T]."""
    o = org.expand(1)        # [N, 1]
    d = direction.expand(1)  # [N, 1]
    p0 = scene.tri_p0.expand(0)  # [1, T]
    p1 = scene.tri_p1.expand(0)
    p2 = scene.tri_p2.expand(0)
    n = scene.tri_normal.expand(0)

    ao = p0 - o
    bo = p1 - o
    co = p2 - o

    v0d = dot(cross(co, bo), d)
    v1d = dot(cross(bo, ao), d)
    v2d = dot(cross(ao, co), d)

    inside = ((v0d < 0.0) & (v1d < 0.0) & (v2d < 0.0)) | (
        (v0d >= 0.0) & (v1d >= 0.0) & (v2d >= 0.0)
    )

    denom = dot(n, d)
    # denom == 0 (parallel) is a miss in the reference too.
    distance = dot(n, ao) / torch.where(denom == 0.0, 1.0, denom)
    ok = inside & (denom != 0.0) & (distance > 0.0)
    return torch.where(ok, distance, BIG_DIST)


def sphere_distances(scene, org: V3, direction: V3):
    """Per-(ray, sphere) hit distance, BIG_DIST when missed -> [N, S]."""
    o = org.expand(1)
    d = direction.expand(1)
    c3 = scene.sph_center.expand(0)

    oc = o - c3  # [N, S]
    a = dot(d, d)
    bq = 2.0 * dot(d, oc)
    c = dot(oc, oc) - scene.sph_radius[None, :] * scene.sph_radius[None, :]

    disc = bq * bq - 4.0 * a * c
    valid = disc >= 0.0
    sqrt_disc = torch.sqrt(disc.clamp_min(1e-30))
    q = torch.where(bq < 0.0, (-bq - sqrt_disc) * 0.5, (-bq + sqrt_disc) * 0.5)

    safe_q = torch.where(q == 0.0, 1.0, q)
    t_a = q / a
    t_b = c / safe_q
    t0 = torch.minimum(t_a, t_b)
    t1 = torch.maximum(t_a, t_b)

    t0_ok = valid & (t0 > 0.0)
    t1_ok = valid & (t1 > 0.0)
    return torch.where(t0_ok, t0, torch.where(t1_ok, t1, BIG_DIST))


def sweep_plain(scene, org: V3, direction: V3):
    """Closest hit -> (dist [N] f32, BIG_DIST on a miss; prim [N] int64,
    -1 on a miss)."""
    all_t = torch.cat([tri_distances(scene, org, direction),
                       sphere_distances(scene, org, direction)], dim=1)
    # argmin returns the first minimum: the lowest index on ties, like the
    # kernel's strict t < best.
    best = torch.argmin(all_t, dim=1)
    best_t = torch.gather(all_t, 1, best[:, None])[:, 0]
    return best_t, torch.where(best_t < BIG_DIST, best, -1)


# ---------------------------------------------------------------------------
# Occlusion (shadow rays): any hit before tmax, on the active lanes only
# ---------------------------------------------------------------------------


def occlusion_operands(point: V3, direction: V3, dist, active):
    """Flatten occlusion operands of any broadcast shape -> (shape, point V3
    of [P], direction V3 of [M], dist [M], active [M] bool).

    Ray i's point is ``point[i % P]``: leading dimensions along which the
    point is only broadcast (an expanded view, or size 1) are dropped
    rather than materialised, so a camera vertex [N] shared by a window of
    [w, N] connections stays [N]."""
    shape = torch.broadcast_shapes(
        *(a.shape for a in (*point, *direction, dist, active)))
    flat = lambda a: a.detach().expand(shape).reshape(-1).contiguous()
    pe = [a.detach().expand(shape) for a in point]
    lead = 0
    while lead < len(shape) and shape[lead] > 0 and all(
            a.stride(lead) == 0 or shape[lead] == 1 for a in pe):
        lead += 1
    point = V3(*(a[(0,) * lead].reshape(-1).contiguous() for a in pe))
    return shape, point, V3(*map(flat, direction)), flat(dist), flat(active)


def occluded_plain(scene, point: V3, direction: V3, dist, active):
    """Any hit on flat operands (point [P],
    the rest [M]; ray i's point is ``point[i % P]``): the closest hit of
    the offset ray is nearer than tmax, and the lane is active."""
    m = dist.shape[0]
    reps = m // point.x.shape[0] if m else 0
    point = V3(*(a.repeat(reps) for a in point))
    org = point + direction * EPS_RAY
    tmax = dist - 2.0 * EPS_RAY
    return active & (sweep_plain(scene, org, direction)[0] < tmax)


def sweep(scene, org: V3, direction: V3):
    """Closest-hit sweep of rays of any (broadcast) shape -> (dist, prim)
    of that shape: the plain version, differentiable through its own
    autograd."""
    shape = torch.broadcast_shapes(*(a.shape for a in (*org, *direction)))
    flat = lambda v: V3(*(a.expand(shape).reshape(-1).contiguous()
                          for a in v))
    org, direction = flat(org), flat(direction)
    dist, prim = sweep_plain(scene, org, direction)
    return dist.reshape(shape), prim.reshape(shape)
