"""Closest-hit ray sweep: scene tables, the Hopper kernel and its plain version.

Port of ``smallvcm_tpu/ops/pallas_intersect.py``. Every ray tests every
primitive (SmallVCM has no acceleration structure, geometry.hxx:55-104):
triangles first with the two-sided three-sign test and
t = n.(p0 - o) / n.d, then spheres with the stable f32 quadratic. A strict
``t < best`` keeps the lowest primitive index on ties, which is also what
``argmin`` over the concatenated [N, T+S] distances picks.

:func:`sweep` takes the plain PyTorch version for CPU tensors and launches
``csrc/intersect_sweep.cu`` for CUDA tensors; it never falls back from the
kernel. Occlusion reuses the same sweep through a ``dist < tmax`` compare.
"""

from __future__ import annotations

import torch

from ..core.vec3 import V3, cross, dot
from . import _cuda

BIG_DIST = 1e36


def scene_tables(scene):
    """Pack primitives into planar f32 tables (the kernel's operands).

    tri [10, T]: p0 xyz | p1 xyz | p2 xyz | pad; tri_n [4, T]: normal xyz |
    material; sph [6, max(S, 1)]: center xyz | radius | material | valid.
    """
    tri = torch.stack([
        scene.tri_p0.x, scene.tri_p0.y, scene.tri_p0.z,
        scene.tri_p1.x, scene.tri_p1.y, scene.tri_p1.z,
        scene.tri_p2.x, scene.tri_p2.y, scene.tri_p2.z,
        torch.zeros_like(scene.tri_p0.x),
    ])
    tri_n = torch.stack([
        scene.tri_normal.x, scene.tri_normal.y, scene.tri_normal.z,
        scene.tri_mat.to(torch.float32),
    ])
    if scene.sph_mat.shape[0]:
        sph = torch.stack([
            scene.sph_center.x, scene.sph_center.y, scene.sph_center.z,
            scene.sph_radius,
            scene.sph_mat.to(torch.float32),
            torch.ones_like(scene.sph_radius),
        ])
    else:
        sph = torch.zeros((6, 1), dtype=torch.float32, device=scene.device)
    return tri, tri_n, sph


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
# Hopper kernel (csrc/intersect_sweep.cu)
# ---------------------------------------------------------------------------


def sweep_kernel(tables, n_tri: int, n_sph: int, org: V3, direction: V3):
    """Launch the CUDA sweep -> (dist [N] f32, prim [N] int64, -1 on a miss)."""
    tri, tri_n, sph = tables
    rays = (*org, *direction)
    n = rays[0].shape[0]
    dev = rays[0].device
    req = _cuda.require
    req(dev.type == "cuda", "sweep_kernel needs CUDA tensors")
    for t in (tri, tri_n, sph, *rays):
        req(t.device == dev, "sweep_kernel: all tensors on one device")
        req(t.dtype == torch.float32, "sweep_kernel: float32 tensors only")
        req(t.is_contiguous(), "sweep_kernel: contiguous tensors only")
        req(not t.requires_grad, "sweep_kernel is forward-only")
    for r in rays:
        req(r.shape == (n,), "sweep_kernel: rays are six [N] tensors")
    req(tri.shape == (10, n_tri) and tri_n.shape == (4, n_tri),
        "sweep_kernel: bad triangle tables")
    req(sph.shape == (6, max(n_sph, 1)), "sweep_kernel: bad sphere table")
    req(n_tri >= 1 and n < 2 ** 31, "sweep_kernel: bad sizes")

    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return dist, prim
    lib = _cuda.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.svcm_intersect_sweep(
        tri.data_ptr(), tri_n.data_ptr(), sph.data_ptr(), n_tri, n_sph,
        *(r.data_ptr() for r in rays), dist.data_ptr(), prim.data_ptr(), n,
        stream,
    )
    _cuda.check(status, "svcm_intersect_sweep")
    sweep_kernel.launches += 1
    return dist, prim


sweep_kernel.launches = 0


# ---------------------------------------------------------------------------
# Gradient of the closest hit: the kernel forward, a plain [N]-lane backward
# ---------------------------------------------------------------------------


def winner_distance(scene, org: V3, direction: V3, prim):
    """Distance to the given primitive of each ray [N] (0 where prim is
    -1), by the plain sweep's formulas: triangles t = n.(p0 - o) / n.d,
    spheres the stable quadratic's nearest positive root. Differentiable in
    the rays and the scene; masked lanes stay NaN-free (guarded divisions
    and a strictly positive sqrt argument, as in the dense sweep)."""
    n_tri = scene.tri_mat.shape[0]
    hit = prim >= 0
    tri = prim.clamp(0, n_tri - 1)
    n = scene.tri_normal[tri]
    denom = dot(n, direction)
    t = dot(n, scene.tri_p0[tri] - org) / torch.where(denom == 0.0, 1.0,
                                                       denom)
    if scene.sph_mat.shape[0]:
        sph = (prim - n_tri).clamp(0, scene.sph_mat.shape[0] - 1)
        oc = org - scene.sph_center[sph]
        a = dot(direction, direction)
        bq = 2.0 * dot(direction, oc)
        r = scene.sph_radius[sph]
        c = dot(oc, oc) - r * r
        sqrt_disc = torch.sqrt((bq * bq - 4.0 * a * c).clamp_min(1e-30))
        q = torch.where(bq < 0.0, (-bq - sqrt_disc) * 0.5,
                        (-bq + sqrt_disc) * 0.5)
        t_a = q / a
        t_b = c / torch.where(q == 0.0, 1.0, q)
        t0 = torch.minimum(t_a, t_b)
        t_sph = torch.where(t0 > 0.0, t0, torch.maximum(t_a, t_b))
        t = torch.where(prim < n_tri, t, t_sph)
    return torch.where(hit, t, 0.0)


class _SweepKernelFn(torch.autograd.Function):
    """The sweep kernel with a gradient: forward launches
    csrc/intersect_sweep.cu; backward differentiates the winning
    primitive's distance (:func:`winner_distance`) on [N] lanes. This is
    the gradient of the dense sweep's min (the JAX package differentiates
    its XLA sweep), which flows to the winning primitive only; the ray
    parameters get it, the primitive index gets none."""

    @staticmethod
    def forward(ctx, scene, tables, ox, oy, oz, dx, dy, dz):
        rays = [a.detach() for a in (ox, oy, oz, dx, dy, dz)]
        dist, prim = sweep_kernel(tables, scene.tri_mat.shape[0],
                                  scene.sph_mat.shape[0], V3(*rays[:3]),
                                  V3(*rays[3:]))
        ctx.scene = scene
        ctx.save_for_backward(*rays, prim)
        ctx.mark_non_differentiable(prim)
        return dist, prim

    @staticmethod
    def backward(ctx, g_dist, _g_prim):
        *rays, prim = ctx.saved_tensors
        with torch.enable_grad():
            rays = [a.detach().requires_grad_(need) for a, need in
                    zip(rays, ctx.needs_input_grad[2:])]
            t = winner_distance(ctx.scene, V3(*rays[:3]), V3(*rays[3:]),
                                prim)
            live = [a for a in rays if a.requires_grad]
            grads = iter(torch.autograd.grad(t, live, g_dist))
        return (None, None, *(next(grads) if a.requires_grad else None
                              for a in rays))


def sweep(scene, org: V3, direction: V3):
    """Closest-hit sweep of rays of any (broadcast) shape -> (dist, prim)
    of that shape: the plain version on CPU (differentiable through its
    own autograd), the kernel on CUDA (through :class:`_SweepKernelFn`
    when a ray needs a gradient)."""
    shape = torch.broadcast_shapes(*(a.shape for a in (*org, *direction)))
    flat = lambda v: V3(*(a.expand(shape).reshape(-1).contiguous()
                          for a in v))
    org, direction = flat(org), flat(direction)
    if org.x.device.type == "cpu":
        dist, prim = sweep_plain(scene, org, direction)
    elif torch.is_grad_enabled() and any(
            a.requires_grad for a in (*org, *direction)):
        dist, prim = _SweepKernelFn.apply(scene, scene_tables(scene), *org,
                                          *direction)
    else:
        dist, prim = sweep_kernel(scene_tables(scene), scene.tri_mat.shape[0],
                                  scene.sph_mat.shape[0], org, direction)
    return dist.reshape(shape), prim.reshape(shape)
