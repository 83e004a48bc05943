"""Ray sweeps: the packed scene block, the Hopper kernels and their plain
versions (closest hit, and any hit for shadow rays).

Port of ``smallvcm_tpu/ops/pallas_intersect.py``. Every ray tests every
primitive (SmallVCM has no acceleration structure, geometry.hxx:55-104):
triangles first with the two-sided three-sign test and
t = n.(p0 - o) / n.d, then spheres with the stable f32 quadratic. A strict
``t < best`` keeps the lowest primitive index on ties, which is also what
``argmin`` over the concatenated [N, T+S] distances picks.

:func:`sweep` takes the plain PyTorch version for CPU tensors and launches
``csrc/intersect_sweep.cu`` for CUDA tensors; it never falls back from the
kernel. Occlusion (:func:`occluded_plain`, :func:`occluded_kernel`) is
the same sweep's ``min_k t_k < tmax`` on the active lanes, which the
kernel computes as an any-hit test that stops at the first blocker.
"""

from __future__ import annotations

import functools
import weakref
from typing import NamedTuple

import torch

from ..core.vec3 import V3, cross, dot
from ..core.vecmath import EPS_RAY
from . import _cuda

BIG_DIST = 1e36


# Capacity and layout of the packed scene block (csrc/intersect_sweep.cu:
# kMaxTri, kMaxSph, kTriFloats, kSphFloats): 12 floats per triangle (p0
# xyz | p1 xyz | p2 xyz | normal xyz), then 4 per sphere (centre xyz |
# radius). SmallVCM's four scenes have at most 20 triangles and 2 spheres.
MAX_TRI = 32
MAX_SPH = 4
TRI_FLOATS = 12
SPH_FLOATS = 4
BLOCK_FLOATS = MAX_TRI * TRI_FLOATS + MAX_SPH * SPH_FLOATS


class SceneBlock(NamedTuple):
    data: torch.Tensor  # [BLOCK_FLOATS] f32 on the host
    n_tri: int
    n_sph: int


def pack_scene(scene) -> SceneBlock:
    """Pack the primitives into the kernels' host-side scene block (zeros
    past the counts); raises ValueError above the block's capacity."""
    n_tri, n_sph = scene.tri_mat.shape[0], scene.sph_mat.shape[0]
    _cuda.require(1 <= n_tri <= MAX_TRI and n_sph <= MAX_SPH,
                  f"sweep kernels take 1-{MAX_TRI} triangles and at most "
                  f"{MAX_SPH} spheres (scene capacity), not {n_tri} and "
                  f"{n_sph}")
    tri = torch.stack([*scene.tri_p0, *scene.tri_p1, *scene.tri_p2,
                       *scene.tri_normal], dim=1)
    sph = torch.stack([*scene.sph_center, scene.sph_radius], dim=1)
    data = torch.zeros(BLOCK_FLOATS, dtype=torch.float32)
    data[:n_tri * TRI_FLOATS] = tri.detach().reshape(-1).cpu()
    off = MAX_TRI * TRI_FLOATS
    data[off:off + n_sph * SPH_FLOATS] = sph.detach().reshape(-1).cpu()
    return SceneBlock(data, n_tri, n_sph)


def _geometry(scene):
    """The tensors :func:`pack_scene` reads."""
    return (*scene.tri_p0, *scene.tri_p1, *scene.tri_p2, *scene.tri_normal,
            *scene.sph_center, scene.sph_radius)


# id of the first geometry tensor -> (weak references to all of them,
# packed block); the entry goes when that tensor does.
_BLOCKS: dict = {}


def scene_block(scene) -> SceneBlock:
    """The packed block of the scene's geometry, built once per set of
    geometry tensors: a SceneData that shares them (a
    ``dataclasses.replace`` of materials or lights, as
    ``diff.apply_params`` makes each iteration) reuses it without a host
    copy; a new geometry tensor packs anew."""
    geo = _geometry(scene)
    key = id(geo[0])
    kept = _BLOCKS.get(key)
    if kept is not None and all(r() is g for r, g in zip(kept[0], geo)):
        return kept[1]
    block = pack_scene(scene)
    if kept is None:
        weakref.finalize(geo[0], _BLOCKS.pop, key, None)
    _BLOCKS[key] = (tuple(map(weakref.ref, geo)), block)
    return block


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


def _check_operands(name: str, tensors, sizes, dev) -> None:
    """The wrappers' checks: f32, contiguous, forward-only, one CUDA
    device, each tensor of its [size]."""
    req = _cuda.require
    req(dev.type == "cuda", f"{name} needs CUDA tensors")
    for t, size in zip(tensors, sizes):
        req(t.device == dev, f"{name}: all tensors on one device")
        req(t.dtype == torch.float32, f"{name}: float32 tensors only")
        req(t.is_contiguous(), f"{name}: contiguous tensors only")
        req(not t.requires_grad, f"{name} is forward-only")
        req(t.shape == (size,), f"{name}: operands are [{size}] tensors")
    req(max(sizes, default=0) < 2 ** 31, f"{name}: too many rays")


def sweep_kernel(scene, org: V3, direction: V3):
    """Launch the CUDA closest-hit sweep -> (dist [N] f32, prim [N] int64,
    -1 on a miss). Raises ValueError above the scene block's capacity."""
    block = scene_block(scene)
    rays = (*org, *direction)
    n = rays[0].shape[0]
    dev = rays[0].device
    _check_operands("sweep_kernel", rays, [n] * 6, dev)

    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return dist, prim
    lib = _cuda.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.svcm_intersect_sweep(
        block.data.data_ptr(), block.n_tri, block.n_sph,
        *(r.data_ptr() for r in rays), dist.data_ptr(), prim.data_ptr(), n,
        stream,
    )
    _cuda.check(status, "svcm_intersect_sweep")
    sweep_kernel.launches += 1
    return dist, prim


# Kernel launches on the device. A CUDA graph's capture runs this wrapper
# but launches nothing: graphs.py takes its increment back and adds it at
# every replay instead.
sweep_kernel.launches = 0


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
    """Plain version of :func:`occluded_kernel` on flat operands (point [P],
    the rest [M]; ray i's point is ``point[i % P]``): the closest hit of
    the offset ray is nearer than tmax, and the lane is active."""
    m = dist.shape[0]
    reps = m // point.x.shape[0] if m else 0
    point = V3(*(a.repeat(reps) for a in point))
    org = point + direction * EPS_RAY
    tmax = dist - 2.0 * EPS_RAY
    return active & (sweep_plain(scene, org, direction)[0] < tmax)


# The any-hit kernel's launch plan (csrc/intersect_sweep.cu:
# occluded_sweep_kernel): a block of OCCLUDED_BLOCK threads takes a window
# of OCCLUDED_BLOCK * V lanes, V = 1, 2 or 4 (MAX_LANES_PER_THREAD, the
# kernel's kMaxLanes); the plan takes the widest window that still gives
# MIN_BLOCKS_PER_SM blocks to every SM. Wider windows pack sparse masks
# into fewer part-empty warps, but leave a call whose lanes are all live
# too few blocks to balance.
OCCLUDED_BLOCK = 256
MAX_LANES_PER_THREAD = 4
MIN_BLOCKS_PER_SM = 3


def occluded_plan(m: int, n_sm: int) -> tuple[int, int]:
    """(lanes a thread V, blocks) of the any-hit launch over ``m`` lanes on
    a card of ``n_sm`` SMs: the largest V whose grid of
    ceil(m / (OCCLUDED_BLOCK * V)) blocks keeps MIN_BLOCKS_PER_SM blocks an
    SM (V = 1 where even that grid is smaller)."""
    _cuda.require(m >= 0 and n_sm >= 1, "occluded_plan: m >= 0, n_sm >= 1")
    blocks = lambda v: -(-m // (OCCLUDED_BLOCK * v))
    v = 1
    while v < MAX_LANES_PER_THREAD and \
            blocks(2 * v) >= MIN_BLOCKS_PER_SM * n_sm:
        v *= 2
    return v, blocks(v)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def occluded_kernel(scene, point: V3, direction: V3, dist, active):
    """Launch the CUDA any-hit sweep -> bool [M]: ray i from
    ``point[i % P] + direction[i] * EPS_RAY`` meets a primitive before
    ``dist[i] - 2 * EPS_RAY``; false, untested, where ``active`` is false.
    Raises ValueError above the scene block's capacity."""
    block = scene_block(scene)
    n_point, m = point.x.shape[0], dist.shape[0]
    dev = dist.device
    _check_operands("occluded_kernel", (*point, *direction, dist),
                    [n_point] * 3 + [m] * 4, dev)
    req = _cuda.require
    req(n_point >= 1 and m % n_point == 0,
        "occluded_kernel: the ray count is not a multiple of the points'")
    req(active.device == dev and active.dtype == torch.bool
        and active.shape == (m,) and active.is_contiguous(),
        "occluded_kernel: active is a contiguous bool [M] on the device")

    out = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return out
    lib = _cuda.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lanes, _ = occluded_plan(m, _sm_count(
        dev.index if dev.index is not None else torch.cuda.current_device()))
    status = lib.svcm_occluded_sweep(
        block.data.data_ptr(), block.n_tri, block.n_sph,
        *(a.data_ptr() for a in point), n_point,
        *(a.data_ptr() for a in direction), dist.data_ptr(),
        active.data_ptr(), out.data_ptr(), m, lanes, stream,
    )
    _cuda.check(status, "svcm_occluded_sweep")
    occluded_kernel.launches += 1
    return out


# Launches on the device, replays included (see sweep_kernel.launches).
occluded_kernel.launches = 0


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
    def forward(ctx, scene, ox, oy, oz, dx, dy, dz):
        rays = [a.detach() for a in (ox, oy, oz, dx, dy, dz)]
        dist, prim = sweep_kernel(scene, V3(*rays[:3]), V3(*rays[3:]))
        ctx.scene = scene
        ctx.save_for_backward(*rays, prim)
        ctx.mark_non_differentiable(prim)
        return dist, prim

    @staticmethod
    def backward(ctx, g_dist, _g_prim):
        *rays, prim = ctx.saved_tensors
        with torch.enable_grad():
            rays = [a.detach().requires_grad_(need) for a, need in
                    zip(rays, ctx.needs_input_grad[1:])]
            t = winner_distance(ctx.scene, V3(*rays[:3]), V3(*rays[3:]),
                                prim)
            live = [a for a in rays if a.requires_grad]
            grads = iter(torch.autograd.grad(t, live, g_dist))
        return (None, *(next(grads) if a.requires_grad else None
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
        dist, prim = _SweepKernelFn.apply(scene, *org, *direction)
    else:
        dist, prim = sweep_kernel(scene, org, direction)
    return dist.reshape(shape), prim.reshape(shape)
