"""Wavefront Vertex Connection and Merging (lt / ppm / bpm / bpt / vcm).

Port of ``smallvcm_tpu/algorithms/vcm.py`` (the reference's ``VertexCM``,
vertexcm.hxx:61-1031): the five-algorithm family switched by the
(use_vc, use_vm, light_trace_only, ppm) flags, as a wavefront pipeline
over component-planar tensors. One iteration is

  1. the light stage: all N light sub-paths advance one bounce per step;
     non-delta vertices land in fixed per-path slots ``[maxL, N]`` and the
     camera connections are recorded, then splatted once
     (io/framebuffer.py::splat_colors);
  2. the camera stage: camera sub-paths do hit-light radiance, NEE and
     same-index light-vertex connections with the dVCM/dVC/dVM MIS
     recursion per lane, and record merge queries;
  3. the deferred merge, additive and walk-independent, so deferring it
     is equivalent to the reference's inline loop: the cell merge
     (ops/merge.py, the CUDA kernel on a card) or the differentiable
     pair-expansion :func:`merge_stage`;
  4. framebuffer accumulation on each path's own pixel.

The JAX ``lax.fori_loop`` bounce loops are Python loops here, and the
camera loop is the JAX package's *unrolled* form: bounce i connects to the
static window of w_i = min(maxL, maxPath - 2 - i) light slots, which is
the only part of the vertex table its path lengths can reach.

On a card, :func:`render_block_with_stats` (the JAX package's
``render_block_with_stats``) runs each iteration as ONE CUDA graph
(graphs.py): :func:`iteration_stage` holds the light walk
(:func:`light_walk`), the splat flush, the camera stage
(:func:`camera_walk`), the merge at static caps (the cell merge,
ops/merge.py, or the pair merge, :func:`merge_stage`) and the framebuffer
sums. It takes the iteration, the radius, r^2, the vm normalization and
the two MIS weights as 0-dim device tensors, filled before each replay
from :func:`compute_misc`'s host floats, so no value of one iteration is
frozen into the capture, and it makes no host read: overflow and merge
stats stay on the device until the block's end.
:func:`render_iteration_core` is the per-stage form, for sharded ranks
(the exchange sits between the stages) and gradients: there the light walk
and the camera stage are each one graph (eager under autograd) and the
rest runs eagerly between them.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import graphs, trace
from ..core import rng
from ..core.vec3 import V3, dot, len_sqr, max_gt_zero, v3_where
from ..core.vecmath import EPS_RAY, PI_F, pdf_w_to_a, sqr
from ..io.framebuffer import (add_color_at_pix, deterministic_index_add,
                              new_fb_planes, splat_colors, total_luminance)
from ..ops import bsdf as bsdf_ops
from ..ops import hashgrid as grid_ops
from ..ops import lights as light_ops
from ..ops import merge as cell_merge
from ..ops.intersect import intersect, occluded
from ..parallel import comm
from ..scene.camera import check_raster, generate_ray, world_to_raster
from ..scene.scene import SceneData


def _safe_div(a, b):
    return a / torch.where(b == 0.0, 1.0, b)


def _mis(pdf):
    """Balance heuristic power (vertexcm.hxx:552-557)."""
    return pdf


class SubPathState(NamedTuple):
    """vertexcm.hxx:64-76 as SoA."""

    origin: V3
    direction: V3
    throughput: V3
    is_finite_light: torch.Tensor  # [N] bool
    specular_path: torch.Tensor    # [N] bool
    d_vcm: torch.Tensor            # [N]
    d_vc: torch.Tensor             # [N]
    d_vm: torch.Tensor             # [N]
    alive: torch.Tensor            # [N] bool


class StoredVertices(NamedTuple):
    """Fixed-slot vertex storage [L, N] (PathVertex, vertexcm.hxx:79-98).

    The vertex BSDF is reconstructed from (in_dir, normal, mat_id) at use
    time: Setup is deterministic, so this is exact.
    """

    position: V3             # V3 of [L, N]
    throughput: V3
    in_dir: V3               # ray direction arriving at the vertex
    normal: V3
    mat_id: torch.Tensor     # [L, N]
    d_vcm: torch.Tensor
    d_vc: torch.Tensor       # light: dVC; camera queries: unused
    d_vm: torch.Tensor
    valid: torch.Tensor      # [L, N] bool; slot i holds pathLength == i+1


class VcmMisc(NamedTuple):
    """Per-iteration constants (vertexcm.hxx:294-308), as Python floats
    rounded in f32 exactly as the JAX package computes them."""

    radius: float
    radius_sqr: float
    vm_normalization: float
    mis_vm_weight: float
    mis_vc_weight: float
    light_sub_path_count: float


class StageMisc(NamedTuple):
    """The MIS constants the trace stages read. The two weights change
    with the iteration (through the radius) and are 0-dim float32 tensors
    on the stage's device, the graphs' scalar inputs: they only add and
    multiply, where a tensor and a Python float holding the same float32
    round alike. The light path count is fixed for a render and stays a
    Python float: it divides, and a CUDA division by a host scalar
    multiplies by its reciprocal, which a device scalar would not."""

    mis_vm_weight: torch.Tensor
    mis_vc_weight: torch.Tensor
    light_sub_path_count: float


def _empty_vertices(max_l: int, n: int, device) -> StoredVertices:
    zf = lambda: torch.zeros((max_l, n), dtype=torch.float32, device=device)
    zv = lambda: V3(zf(), zf(), zf())
    return StoredVertices(
        position=zv(), throughput=zv(), in_dir=zv(), normal=zv(),
        mat_id=torch.zeros((max_l, n), dtype=torch.int64, device=device),
        d_vcm=zf(), d_vc=zf(), d_vm=zf(),
        valid=torch.zeros((max_l, n), dtype=torch.bool, device=device),
    )


def _store_slot(verts: StoredVertices, i: int, **fields) -> None:
    """Write slot i of every field in place (the tables are fresh per
    iteration, so nothing else holds them)."""
    for name, dst in zip(StoredVertices._fields, verts):
        val = fields[name]
        if isinstance(dst, V3):
            for d, v in zip(dst, val):
                d[i] = v
        else:
            dst[i] = val


# id of a scene sphere's radius tensor -> (weak reference, its value); the
# entry goes with the tensor.
_RADII: dict = {}


def _scene_radius(scene: SceneData) -> float:
    """The scene sphere's radius as a host float, read from the device once
    per tensor: compute_misc runs before every iteration of a block, whose
    one host read is at its end."""
    t = scene.scene_sphere.radius
    kept = _RADII.get(id(t))
    if kept is not None and kept[0]() is t:
        return kept[1]
    value = float(t)
    if kept is None:
        weakref.finalize(t, _RADII.pop, id(t), None)
    _RADII[id(t)] = (weakref.ref(t), value)
    return value


def compute_misc(
    scene: SceneData, iteration: int, n_light_paths: int, radius_factor,
    radius_alpha, use_vc: bool, use_vm: bool,
) -> VcmMisc:
    f = np.float32
    base_radius = f(radius_factor) * f(_scene_radius(scene))
    radius = base_radius / np.power(
        f(iteration) + f(1.0), f(0.5 * (1.0 - radius_alpha))
    )
    radius = max(radius, f(1e-7))
    radius_sqr = radius * radius
    count = f(n_light_paths)
    eta_vcm = f(PI_F) * radius_sqr * count
    return VcmMisc(
        radius=float(radius),
        radius_sqr=float(radius_sqr),
        vm_normalization=float(f(1.0) / (radius_sqr * f(PI_F) * count)),
        mis_vm_weight=float(_mis(eta_vcm)) if use_vm else 0.0,
        mis_vc_weight=float(_mis(f(1.0) / eta_vcm)) if use_vc else 0.0,
        light_sub_path_count=float(count),
    )


# ---------------------------------------------------------------------------
# Light stage
# ---------------------------------------------------------------------------


def generate_light_sample(
    scene: SceneData, misc: StageMisc, pix, iteration, base_seed: int,
    rng_kind: str = "threefry",
) -> SubPathState:
    """GenerateLightSample (vertexcm.hxx:816-858). ``iteration``: a Python
    int or a 0-dim int64 tensor (core/rng.py)."""
    n = pix.shape[0]
    light_count = scene.lights.kind.shape[0]
    pick_prob = 1.0 / light_count

    u = rng.uniform_slots(
        base_seed, rng.make_stream(iteration, rng.STAGE_LIGHT_EMIT), pix, 5,
        rng_kind,
    )
    light_id = (u[:, 0] * light_count).long().clamp_max(light_count - 1)
    em = light_ops.emit(
        scene.lights, light_id, scene.scene_sphere,
        u[:, 1], u[:, 2], u[:, 3], u[:, 4],
    )
    emission_pdf = em.emission_pdf_w * pick_prob
    direct_pdf = em.direct_pdf_a * pick_prob

    throughput = em.energy * _safe_div(1.0, emission_pdf)

    d_vcm = _mis(_safe_div(direct_pdf, emission_pdf))
    used_cos = torch.where(em.is_finite, em.cos_theta_light, 1.0)
    d_vc = torch.where(em.is_delta, 0.0,
                       _mis(_safe_div(used_cos, emission_pdf)))
    d_vm = d_vc * misc.mis_vc_weight

    return SubPathState(
        origin=em.position,
        direction=em.direction,
        throughput=throughput,
        is_finite_light=em.is_finite,
        specular_path=torch.ones((n,), dtype=torch.bool, device=pix.device),
        d_vcm=d_vcm, d_vc=d_vc, d_vm=d_vm,
        alive=emission_pdf > 0.0,
    )


def connect_to_camera(
    scene: SceneData, misc: StageMisc, state: SubPathState, hit_point: V3,
    b: bsdf_ops.BsdfState, enabled_mask, light_trace_only: bool,
):
    """ConnectToCamera (vertexcm.hxx:862-933) -> (raster_x, raster_y,
    contrib V3, cast bool)."""
    cam = scene.camera
    dir_to_cam_raw = cam.position - hit_point
    in_front = dot(cam.forward, -dir_to_cam_raw) > 0.0

    rx, ry = world_to_raster(cam, hit_point)
    on_screen = check_raster(cam, rx, ry)

    dist_eye2 = len_sqr(dir_to_cam_raw).clamp_min(1e-30)
    distance = torch.sqrt(dist_eye2)
    dir_to_cam = dir_to_cam_raw * (1.0 / distance)

    factor, cos_to_cam, _, rev_pdf_w = bsdf_ops.evaluate(
        scene.materials, b, dir_to_cam
    )
    nonzero = max_gt_zero(factor)
    rev_pdf_w = rev_pdf_w * b.cont_prob

    cos_at_cam = dot(cam.forward, -dir_to_cam)
    img_to_cam_dist = _safe_div(cam.image_plane_dist, cos_at_cam)
    img_to_solid_angle = _safe_div(sqr(img_to_cam_dist), cos_at_cam)
    img_to_surface = img_to_solid_angle * torch.abs(cos_to_cam) / dist_eye2
    camera_pdf_a = img_to_surface

    # [tech. rep. (46)]
    w_light = _mis(camera_pdf_a / misc.light_sub_path_count) * (
        misc.mis_vm_weight + state.d_vcm + state.d_vc * _mis(rev_pdf_w)
    )
    mis_weight = (torch.ones_like(w_light) if light_trace_only
                  else 1.0 / (w_light + 1.0))

    surface_to_img = _safe_div(1.0, img_to_surface)
    scale = mis_weight * _safe_div(
        1.0, misc.light_sub_path_count * surface_to_img
    )
    contrib = state.throughput * factor * scale

    ok = enabled_mask & in_front & on_screen & nonzero & max_gt_zero(contrib)
    shadowed = occluded(scene, hit_point, dir_to_cam, distance, ok)
    ok = ok & ~shadowed
    return rx, ry, v3_where(ok, contrib, 0.0), ok


def sample_scattering(
    scene: SceneData, misc: StageMisc, state: SubPathState, hit_point: V3,
    b: bsdf_ops.BsdfState, u, fix_is_light: bool,
) -> SubPathState:
    """SampleScattering (vertexcm.hxx:937-1006) — masked wavefront version."""
    factor, new_dir, dir_pdf_w, cos_out, event, keep = bsdf_ops.sample(
        scene.materials, b, u[:, 0], u[:, 1], u[:, 2],
        fix_is_light=fix_is_light,
    )
    alive = state.alive & keep

    specular = (event & bsdf_ops.EV_SPECULAR) != 0
    _, rev_reverse = bsdf_ops.pdf(scene.materials, b, new_dir)
    rev_pdf_w = torch.where(specular, dir_pdf_w, rev_reverse)

    cont = b.cont_prob
    alive = alive & (u[:, 3] <= cont)
    dir_pdf_w = dir_pdf_w * cont
    rev_pdf_w = rev_pdf_w * cont

    inv_dir_pdf = _safe_div(1.0, dir_pdf_w)
    cos_over_pdf = cos_out * inv_dir_pdf

    # Specular [tech. rep. (53)-(55)] / non-specular [(34)-(36)].
    d_vcm = torch.where(specular, 0.0, _mis(inv_dir_pdf))
    d_vc = torch.where(
        specular,
        state.d_vc * _mis(cos_out),
        _mis(cos_over_pdf)
        * (state.d_vc * _mis(rev_pdf_w) + state.d_vcm + misc.mis_vm_weight),
    )
    d_vm = torch.where(
        specular,
        state.d_vm * _mis(cos_out),
        _mis(cos_over_pdf)
        * (state.d_vm * _mis(rev_pdf_w) + state.d_vcm * misc.mis_vc_weight
           + 1.0),
    )
    specular_path = state.specular_path & specular

    throughput = state.throughput * factor * cos_over_pdf

    sel = lambda new, old: torch.where(alive, new, old)
    selv = lambda new, old: v3_where(alive, new, old)
    return SubPathState(
        origin=selv(hit_point, state.origin),
        direction=selv(new_dir, state.direction),
        throughput=selv(throughput, state.throughput),
        is_finite_light=state.is_finite_light,
        specular_path=sel(specular_path, state.specular_path),
        d_vcm=sel(d_vcm, state.d_vcm),
        d_vc=sel(d_vc, state.d_vc),
        d_vm=sel(d_vm, state.d_vm),
        alive=alive,
    )


def trace_light_paths(
    scene: SceneData, misc: VcmMisc, pix, iteration: int, fb,
    base_seed: int, max_path_length: int, min_path_length: int,
    use_vc: bool, use_vm: bool, light_trace_only: bool,
    rng_kind: str = "threefry",
):
    """Light stage (vertexcm.hxx:321-396) -> (vertices, fb, ray_count):
    :func:`light_walk` as one graph (graphs.stage), then the eager flush of
    its camera splats into ``fb``."""
    res_y, res_x = fb.x.shape
    verts, splat_pix, splat_rgb, rays = graphs.stage(
        light_walk, scene, (pix,),
        (iteration, misc.mis_vm_weight, misc.mis_vc_weight),
        (misc.light_sub_path_count, res_x, res_y, base_seed,
         max_path_length, min_path_length, use_vc, use_vm, light_trace_only,
         rng_kind))
    if splat_pix is not None:
        fb = splat_colors(fb, splat_pix, splat_rgb)
    trace.stamp("splat_flush")
    return verts, fb, rays


def light_walk(
    scene: SceneData, pix, iteration, mis_vm_weight, mis_vc_weight,
    light_sub_path_count: float, res_x_fb: int, res_y_fb: int,
    base_seed: int, max_path_length: int, min_path_length: int,
    use_vc: bool, use_vm: bool, light_trace_only: bool,
    rng_kind: str = "threefry",
):
    """Emission and the light bounce loop -> (vertices, splat pixels
    [maxL, N] or None, splat colours V3 of [maxL, N] or None, ray_count).

    ``iteration`` and the two MIS weights are 0-dim device tensors
    (:class:`StageMisc`); the function makes no host read, so it runs as
    one CUDA graph (graphs.py). The camera splats are recorded per bounce
    for :func:`trace_light_paths` to flush; dead or off-screen rows carry
    the sentinel ``res_x_fb * res_y_fb``."""
    n = pix.shape[0]
    dev = pix.device
    misc = StageMisc(mis_vm_weight, mis_vc_weight, light_sub_path_count)
    max_l = max(1, max_path_length - 1)
    store_vertices = use_vc or use_vm
    connect_cam = use_vc or light_trace_only

    state = generate_light_sample(scene, misc, pix, iteration, base_seed,
                                  rng_kind)
    verts = _empty_vertices(max_l, n, dev)
    # Deferred camera-connection splats: each bounce records (pixel, rgb)
    # rows and one deterministic scatter flushes them after the walk.
    pix_sentinel = res_x_fb * res_y_fb
    splat_pix = splat_rgb = None
    if connect_cam:
        splat_pix = torch.full((max_l, n), pix_sentinel, dtype=torch.int64,
                               device=dev)
        splat_rgb = V3(*(torch.zeros((max_l, n), dtype=torch.float32,
                                     device=dev) for _ in range(3)))
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    trace.stamp("light.sample")

    for i in range(max_l):
        path_length = i + 1

        live = state.alive.sum()
        rays = rays + live
        org = state.origin + state.direction * EPS_RAY
        hit = intersect(scene, org, state.direction)
        alive = state.alive & hit.hit
        dist_safe = torch.where(hit.hit, hit.dist, 1.0)
        hit_point = org + state.direction * dist_safe
        isect_dist = dist_safe + EPS_RAY

        b = bsdf_ops.setup(
            scene.materials, state.direction, hit.normal, hit.mat_id, hit.hit
        )
        alive = alive & b.valid

        # MIS completion after tracing (vertexcm.hxx:351-360), masked by
        # alive so dead lanes can't overflow/NaN.
        d_vcm = state.d_vcm * _mis(sqr(isect_dist))
        if path_length == 1:  # infinite lights skip the distance term
            d_vcm = torch.where(~state.is_finite_light, state.d_vcm, d_vcm)
        abs_cos = torch.abs(b.cos_theta_fix())
        inv_cos = _safe_div(1.0, _mis(abs_cos))
        state = state._replace(
            d_vcm=torch.where(alive, d_vcm * inv_cos, state.d_vcm),
            d_vc=torch.where(alive, state.d_vc * inv_cos, state.d_vc),
            d_vm=torch.where(alive, state.d_vm * inv_cos, state.d_vm),
            alive=alive,
        )

        # Store vertex (vertexcm.hxx:364-377).
        if store_vertices:
            _store_slot(
                verts, i,
                position=hit_point, throughput=state.throughput,
                in_dir=state.direction, normal=hit.normal,
                mat_id=hit.mat_id, d_vcm=state.d_vcm, d_vc=state.d_vc,
                d_vm=state.d_vm, valid=alive & ~b.is_delta,
            )

        # Connect to camera (vertexcm.hxx:380-384).
        if connect_cam:
            enabled = alive & ~b.is_delta
            if path_length + 1 < min_path_length:
                enabled = torch.zeros_like(enabled)
            rx, ry, contrib, cast = connect_to_camera(
                scene, misc, state, hit_point, b, enabled, light_trace_only
            )
            # AddColor's floor/drop semantics (framebuffer.hxx:43-57) via
            # the sentinel for any dead/OOB row (cast implies on-screen).
            px_i = torch.floor(rx).long()
            py_i = torch.floor(ry).long()
            splat_pix[i] = torch.where(
                cast & (rx >= 0) & (ry >= 0) & (px_i < res_x_fb)
                & (py_i < res_y_fb),
                py_i * res_x_fb + px_i, pix_sentinel,
            )
            splat_rgb.x[i] = contrib.x
            splat_rgb.y[i] = contrib.y
            splat_rgb.z[i] = contrib.z
            rays = rays + enabled.sum()  # shadow rays

        # Path-too-long termination (vertexcm.hxx:387).
        if path_length + 2 > max_path_length:
            state = state._replace(alive=torch.zeros_like(alive))

        u = rng.uniform_slots(
            base_seed, rng.make_stream(iteration, rng.STAGE_LIGHT_WALK, i),
            pix, 4, rng_kind,
        )
        state = sample_scattering(
            scene, misc, state, hit_point, b, u, fix_is_light=True
        )
        trace.stamp(f"light.b{i}", count=live)

    trace.stamp("light_walk")
    return verts, splat_pix, splat_rgb, rays


# ---------------------------------------------------------------------------
# Camera stage helpers
# ---------------------------------------------------------------------------


def generate_camera_sample(
    scene: SceneData, misc: StageMisc, pix, res_x: int, iteration,
    base_seed: int, rng_kind: str = "threefry",
):
    """GenerateCameraSample (vertexcm.hxx:564-606)."""
    n = pix.shape[0]
    dev = pix.device
    cam = scene.camera
    x = torch.remainder(pix, res_x).to(torch.float32)
    y = torch.div(pix, res_x, rounding_mode="floor").to(torch.float32)
    jitter = rng.uniform_slots(
        base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_JITTER), pix, 2,
        rng_kind,
    )
    sx = x + jitter[:, 0]
    sy = y + jitter[:, 1]

    org, direction = generate_ray(cam, sx, sy)
    cos_at_cam = dot(cam.forward, direction)
    img_to_cam_dist = cam.image_plane_dist / cos_at_cam
    camera_pdf_w = sqr(img_to_cam_dist) / cos_at_cam

    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    state = SubPathState(
        origin=org,
        direction=direction,
        throughput=V3(ones, ones, ones),
        is_finite_light=torch.zeros((n,), dtype=torch.bool, device=dev),
        specular_path=torch.ones((n,), dtype=torch.bool, device=dev),
        d_vcm=_mis(misc.light_sub_path_count / camera_pdf_w),
        d_vc=zeros,
        d_vm=zeros,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    return sx, sy, state


def get_light_radiance_weighted(
    scene: SceneData, state: SubPathState, light_id, ray_dir: V3,
    path_length: int, use_vc: bool, use_vm: bool,
) -> V3:
    """GetLightRadiance (vertexcm.hxx:617-658): radiance * MIS weight."""
    light_count = scene.lights.kind.shape[0]
    pick_prob = 1.0 / light_count

    lr = light_ops.get_radiance(
        scene.lights, light_id, scene.scene_sphere, ray_dir
    )
    nonzero = max_gt_zero(lr.radiance)

    direct_pdf = lr.direct_pdf_a * pick_prob
    emission_pdf = lr.emission_pdf_w * pick_prob

    # [tech. rep. (42)-(43)]
    w_camera = _mis(direct_pdf) * state.d_vcm + _mis(emission_pdf) * state.d_vc
    mis_weight = 1.0 / (1.0 + w_camera)

    if path_length == 1:
        weighted = lr.radiance
    elif use_vm and not use_vc:  # merging-only: purely specular paths only
        weighted = v3_where(state.specular_path, lr.radiance, 0.0)
    else:
        weighted = lr.radiance * mis_weight
    return v3_where(nonzero, weighted, 0.0)


def direct_illumination(
    scene: SceneData, misc: StageMisc, state: SubPathState, hit_point: V3,
    b: bsdf_ops.BsdfState, u3, active,
) -> V3:
    """DirectIllumination (vertexcm.hxx:663-738): NEE contribution.
    ``active`` is the caller's mask on the result: shadow rays are traced
    only where it holds (elsewhere the caller discards the value)."""
    light_count = scene.lights.kind.shape[0]
    pick_prob = 1.0 / light_count

    light_id = (u3[:, 0] * light_count).long().clamp_max(light_count - 1)
    ill = light_ops.illuminate(
        scene.lights, light_id, scene.scene_sphere, hit_point,
        u3[:, 1], u3[:, 2],
    )
    ok = max_gt_zero(ill.radiance)

    factor, cos_to_light, dir_pdf_w, rev_pdf_w = bsdf_ops.evaluate(
        scene.materials, b, ill.dir_to_light
    )
    ok = ok & max_gt_zero(factor)

    cont = b.cont_prob
    light_is_delta = scene.lights.is_delta[light_id.clamp(0, light_count - 1)]
    dir_pdf_w = torch.where(light_is_delta, 0.0, dir_pdf_w * cont)
    rev_pdf_w = rev_pdf_w * cont

    # [tech. rep. (44)]
    w_light = _mis(_safe_div(dir_pdf_w, pick_prob * ill.direct_pdf_w))
    # [tech. rep. (45)]
    ratio = _safe_div(
        ill.emission_pdf_w * cos_to_light,
        ill.direct_pdf_w * ill.cos_at_light,
    )
    w_camera = _mis(ratio) * (
        misc.mis_vm_weight + state.d_vcm + state.d_vc * _mis(rev_pdf_w)
    )
    mis_weight = 1.0 / (w_light + 1.0 + w_camera)

    contrib = (ill.radiance * factor) * (
        mis_weight * cos_to_light * _safe_div(
            1.0, pick_prob * ill.direct_pdf_w
        )
    )

    ok = ok & max_gt_zero(contrib)
    shadowed = occluded(scene, hit_point, ill.dir_to_light, ill.distance,
                        ok & active)
    return v3_where(ok & ~shadowed, contrib, 0.0)


def connect_vertices(
    scene: SceneData, misc: StageMisc, cam_d_vcm, cam_d_vc, cam_hit: V3,
    cam_b: bsdf_ops.BsdfState, lv_pos: V3, lv_in_dir: V3, lv_normal: V3,
    lv_mat, lv_d_vcm, lv_d_vc, lv_valid,
) -> V3:
    """ConnectVertices (vertexcm.hxx:743-809): contribution (without the
    camera/light throughputs, which the caller multiplies).

    Operands broadcast: the camera stage passes every (camera vertex,
    stored light vertex) pair of a bounce as [w, N] (camera fields as
    expanded views), so one occlusion sweep and one pair of BSDF
    evaluations serve the whole window."""
    direction_raw = lv_pos - cam_hit
    dist2 = len_sqr(direction_raw).clamp_min(1e-30)
    distance = torch.sqrt(dist2)
    direction = direction_raw * (1.0 / distance)

    cam_factor, cos_camera, cam_dir_pdf_w, cam_rev_pdf_w = bsdf_ops.evaluate(
        scene.materials, cam_b, direction
    )
    ok = max_gt_zero(cam_factor)

    cam_cont = cam_b.cont_prob
    cam_dir_pdf_w = cam_dir_pdf_w * cam_cont
    cam_rev_pdf_w = cam_rev_pdf_w * cam_cont

    # Reconstruct the light vertex BSDF (deterministic Setup re-run).
    lb = bsdf_ops.setup(scene.materials, lv_in_dir, lv_normal, lv_mat,
                        lv_valid)
    light_factor, cos_light, light_dir_pdf_w, light_rev_pdf_w = (
        bsdf_ops.evaluate(scene.materials, lb, -direction)
    )
    ok = ok & max_gt_zero(light_factor)

    light_cont = lb.cont_prob
    light_dir_pdf_w = light_dir_pdf_w * light_cont
    light_rev_pdf_w = light_rev_pdf_w * light_cont

    geometry_term = cos_light * cos_camera / dist2
    ok = ok & (geometry_term >= 0.0)

    cam_dir_pdf_a = pdf_w_to_a(cam_dir_pdf_w, distance, cos_light)
    light_dir_pdf_a = pdf_w_to_a(light_dir_pdf_w, distance, cos_camera)

    # [tech. rep. (40)-(41)]
    w_light = _mis(cam_dir_pdf_a) * (
        misc.mis_vm_weight + lv_d_vcm + lv_d_vc * _mis(light_rev_pdf_w)
    )
    w_camera = _mis(light_dir_pdf_a) * (
        misc.mis_vm_weight + cam_d_vcm
        + cam_d_vc * _mis(cam_rev_pdf_w)
    )
    mis_weight = 1.0 / (w_light + 1.0 + w_camera)

    contrib = cam_factor * light_factor * (mis_weight * geometry_term)
    ok = ok & max_gt_zero(contrib) & lv_valid
    shadowed = occluded(scene, cam_hit, direction, distance, ok)
    return v3_where(ok & ~shadowed, contrib, 0.0)


# ---------------------------------------------------------------------------
# Camera stage + merge + the iteration
# ---------------------------------------------------------------------------


def _camera_stage(
    scene, misc, verts, pix, iteration: int, res_x: int, base_seed: int,
    max_path_length: int, min_path_length: int, use_vc: bool, use_vm: bool,
    ppm: bool, rng_kind: str = "threefry",
):
    """Camera sub-paths -> (color V3 [N], queries, ray_count):
    :func:`camera_walk` as one graph (graphs.stage)."""
    return graphs.stage(
        camera_walk, scene, (verts, pix),
        (iteration, misc.mis_vm_weight, misc.mis_vc_weight),
        (misc.light_sub_path_count, res_x, base_seed, max_path_length,
         min_path_length, use_vc, use_vm, ppm, rng_kind))


def camera_walk(
    scene, verts, pix, iteration, mis_vm_weight, mis_vc_weight,
    light_sub_path_count: float, res_x: int, base_seed: int,
    max_path_length: int, min_path_length: int, use_vc: bool, use_vm: bool,
    ppm: bool, rng_kind: str = "threefry",
):
    """The camera stage -> (color V3 [N], queries or None, ray_count), with
    the iteration and the MIS weights as 0-dim device tensors and no host
    read, as :func:`light_walk`."""
    n = pix.shape[0]
    dev = pix.device
    misc = StageMisc(mis_vm_weight, mis_vc_weight, light_sub_path_count)
    sx, sy, state = generate_camera_sample(
        scene, misc, pix, res_x, iteration, base_seed, rng_kind
    )
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    color = V3(zero, zero, zero)
    has_background = scene.background_idx >= 0
    max_l = verts.valid.shape[0]
    queries = _empty_vertices(max_path_length, n, dev) if use_vm else None
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    trace.stamp("camera.sample")

    for i in range(max_path_length):
        path_length = i + 1
        # Static connection window: full_len = (j+1) + 1 + path_length
        # <= max_path_length bounds the reachable light slot j.
        w_conn = min(max_l, max(0, max_path_length - 1 - (i + 1)))

        live = state.alive.sum()
        rays = rays + live
        org = state.origin + state.direction * EPS_RAY
        hit = intersect(scene, org, state.direction)
        dist_safe = torch.where(hit.hit, hit.dist, 1.0)
        hit_point = org + state.direction * dist_safe
        isect_dist = dist_safe + EPS_RAY

        # Miss -> background radiance, PRE-update MIS (vertexcm.hxx:434-447).
        if has_background and path_length >= min_path_length:
            bg_contrib = get_light_radiance_weighted(
                scene, state,
                torch.full((n,), scene.background_idx, dtype=torch.int64,
                           device=dev),
                state.direction, path_length, use_vc, use_vm,
            )
            take_bg = state.alive & ~hit.hit
            color = color + v3_where(take_bg, state.throughput * bg_contrib,
                                     0.0)

        alive = state.alive & hit.hit
        b = bsdf_ops.setup(
            scene.materials, state.direction, hit.normal, hit.mat_id, hit.hit
        )
        alive = alive & b.valid

        # MIS update (vertexcm.hxx:459-464), masked by alive.
        abs_cos = torch.abs(b.cos_theta_fix())
        inv_cos = _safe_div(1.0, _mis(abs_cos))
        state = state._replace(
            d_vcm=torch.where(
                alive, state.d_vcm * _mis(sqr(isect_dist)) * inv_cos,
                state.d_vcm,
            ),
            d_vc=torch.where(alive, state.d_vc * inv_cos, state.d_vc),
            d_vm=torch.where(alive, state.d_vm * inv_cos, state.d_vm),
        )

        # Hit a light source (vertexcm.hxx:468-479).
        hit_light = alive & (hit.light_id >= 0)
        if path_length >= min_path_length:
            light_contrib = get_light_radiance_weighted(
                scene, state, hit.light_id, state.direction, path_length,
                use_vc, use_vm,
            )
            color = color + v3_where(
                hit_light, state.throughput * light_contrib, 0.0
            )
        alive = alive & ~hit_light

        # Too long for connections/merging (vertexcm.hxx:482-483).
        if path_length >= max_path_length:
            alive = torch.zeros_like(alive)
        state = state._replace(alive=alive)

        # VC: connect to a light source — NEE (vertexcm.hxx:487-494).
        if use_vc:
            u3 = rng.uniform_slots(
                base_seed,
                rng.make_stream(iteration, rng.STAGE_CAMERA_NEE, i), pix, 3,
                rng_kind,
            )
            nee_on = alive & ~b.is_delta
            if path_length + 1 < min_path_length:
                nee_on = torch.zeros_like(nee_on)
            nee = direct_illumination(scene, misc, state, hit_point, b, u3,
                                      nee_on)
            color = color + v3_where(nee_on, state.throughput * nee, 0.0)
            rays = rays + nee_on.sum()

        # VC: connect to this path's light vertices (vertexcm.hxx:498-526),
        # the w_conn reachable slots at once as [w_conn, N].
        if use_vc and w_conn > 0:
            bro = lambda a: a.unsqueeze(0).expand(w_conn, n)
            brov = lambda v: V3(bro(v.x), bro(v.y), bro(v.z))
            fl = lambda a: a[:w_conn]
            flv = lambda v: V3(fl(v.x), fl(v.y), fl(v.z))

            # Slot j's full path length, formed on the device: a host
            # list copied to the card would not replay from a graph.
            full_len = torch.arange(w_conn, device=dev) + (2 + path_length)
            in_range = ((full_len >= min_path_length)
                        & (full_len <= max_path_length))[:, None]
            lv_valid = fl(verts.valid) & bro(alive & ~b.is_delta) & in_range

            cam_b_t = bsdf_ops.BsdfState(*(
                brov(f) if isinstance(f, V3) else bro(f) for f in b
            ))
            c = connect_vertices(
                scene, misc, bro(state.d_vcm), bro(state.d_vc),
                brov(hit_point), cam_b_t,
                flv(verts.position), flv(verts.in_dir), flv(verts.normal),
                fl(verts.mat_id), fl(verts.d_vcm), fl(verts.d_vc), lv_valid,
            )
            contrib = v3_where(
                lv_valid, brov(state.throughput) * flv(verts.throughput) * c,
                0.0,
            )
            color = color + V3(contrib.x.sum(dim=0), contrib.y.sum(dim=0),
                               contrib.z.sum(dim=0))
            rays = rays + lv_valid.sum()

        # VM: record a merge query at this vertex (processed in the deferred
        # merge stage — merging is additive and walk-independent).
        if use_vm:
            _store_slot(
                queries, i,
                position=hit_point, throughput=state.throughput,
                in_dir=state.direction, normal=hit.normal,
                mat_id=hit.mat_id, d_vcm=state.d_vcm, d_vc=state.d_vc,
                d_vm=state.d_vm, valid=alive & ~b.is_delta,
            )
            if ppm:  # PPM ends the camera path at the first non-delta hit
                state = state._replace(alive=alive & b.is_delta)

        u = rng.uniform_slots(
            base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_WALK, i),
            pix, 4, rng_kind,
        )
        state = sample_scattering(
            scene, misc, state, hit_point, b, u, fix_is_light=False
        )
        trace.stamp(f"camera.b{i}", count=live)
    trace.stamp("camera_walk")
    return color, queries, rays


def _pad_mult(x: int, m: int) -> int:
    """Round x up to a multiple of m (query caps must split into chunks)."""
    return -(-x // m) * m


class _PhotonGrid(NamedTuple):
    """The photons' bbox, cell size and full-width cell hashes (dead slots
    in the sentinel cell ``num_cells``) with their per-cell counts."""
    mins: list            # 3 x 0-dim f32
    maxs: list
    inv_cell: torch.Tensor
    hashes: torch.Tensor  # [M] int64
    count: torch.Tensor   # [num_cells] int64


def _photon_grid(light_verts: StoredVertices, radius, num_cells: int):
    """Hash every photon slot into cells of 2r (hashgrid.hxx:64) at full
    width, positions detached (the JAX merge's stop_gradient), with no
    host read: ``radius`` may be a 0-dim device tensor, and the cell size
    is its reciprocal in f32, as the JAX package rounds it."""
    flat = lambda a: a.reshape(-1)
    pvalid = flat(light_verts.valid)
    pos = [flat(c).detach() for c in light_verts.position]
    big = 1e36
    mins = [torch.where(pvalid, a, big).min() for a in pos]
    maxs = [torch.where(pvalid, a, -big).max() for a in pos]
    inv_cell = torch.reciprocal(radius * 2.0)
    h = grid_ops._hash_cell(*(torch.floor((a - mn) * inv_cell).long()
                              for a, mn in zip(pos, mins)), num_cells)
    # Dead slots add 0 at their own position mod num_cells, not 1 at the
    # sentinel: most slots are dead, and one hot counter serializes.
    spread = torch.remainder(torch.arange(h.shape[0], device=h.device),
                             num_cells)
    count = torch.zeros((num_cells,), dtype=torch.int64,
                        device=h.device).scatter_add_(
        0, torch.where(pvalid, h, spread), pvalid.long())
    return _PhotonGrid(mins, maxs, inv_cell,
                       torch.where(pvalid, h, num_cells), count)


def _probe_cells(grid: _PhotonGrid, radius, qpos, live, num_cells: int):
    """The 8 probed cells of each query -> hashes [8, Q]: the query's cell
    and its neighbours on the side of the cell centre it lies on
    (hashgrid.hxx:124-138). ``live`` (the caller's) is narrowed to the
    queries within r of the photon bbox (hashgrid.hxx:116-122, padded by
    the radius: same-plane f32 hit points sit ulps outside the tight
    bbox) -> (hashes, live)."""
    for a, mn, mx in zip(qpos, grid.mins, grid.maxs):
        live = live & (a >= mn - radius) & (a <= mx + radius)
    rel = [(a - mn) * grid.inv_cell for a, mn in zip(qpos, grid.mins)]
    base = [torch.floor(r).long() for r in rel]
    side = [torch.where(r - torch.floor(r) < 0.5, -1, 1) for r in rel]
    cells = [grid_ops._hash_cell(*(b + (s if bit & (1 << k) else 0)
                                   for k, (b, s) in enumerate(zip(base,
                                                                  side))),
                                 num_cells) for bit in range(8)]
    return torch.stack(cells), live


def merge_stage(
    scene: SceneData, misc: VcmMisc, queries: StoredVertices,
    light_verts: StoredVertices, num_cells: int, pair_cap: int, ppm: bool,
    max_path_length: int, min_path_length: int, photon_cap: int,
    query_cap: int, n_paths: int, merge_chunks: int = 1,
):
    """Vertex merging by (query, photon) pair expansion at static caps ->
    (color_add V3 [n_paths], overflow int64, stats int64 [candidate
    pairs, live photons, live queries]): the JAX package's XLA merge
    (vcm.py::merge_stage), stage for stage, with no host read, so it runs
    inside the iteration's CUDA graph (graphs.py).

    RangeQuery::Process (vertexcm.hxx:130-169): every light vertex within
    the merge radius of a camera vertex contributes mis * f_s(camera,
    -photon.in_dir) * photon throughput [tech. rep. (38)-(39)] (mis = 1 for
    ppm), summed per query and scaled by the vm normalization and the
    camera throughput.

    1. Photons are hashed at full width into ``num_cells`` cells of 2r
       (dead slots in a sentinel cell) and sort-compacted by cell into
       ``photon_cap`` rows; the per-cell counts come from the full-width
       hashes. Two probe cells of one query that share a hash bucket
       visit its photons twice, as in the reference's grid.
    2. Queries are compacted by a stable sort on the validity bit into
       ``query_cap`` rows; each live query within r of the photon bbox
       probes its 2x2x2 cells, and 20 int32 fields a query hold its
       position bits, path length and per-cell boundaries.
    3. Per chunk of ``query_cap / merge_chunks`` queries, pairs are
       expanded into ``pair_cap_c`` rows (pair_cap / merge_chunks, with
       1.5x slack when chunked: pairs do not split evenly) by a segment
       carry, tested for the exact r^2 and the path-length window
       (vertexcm.hxx:132-135), and the survivors compacted into
       ``surv_cap`` rows by one sort on flag | pair id.
    4. The survivors' BSDF and MIS weights, summed per query and routed to
       the owning path (framebuffer.deterministic_index_add).

    Every truncation is JAX's: the first ``photon_cap`` photons in cell
    order, the first ``query_cap`` queries, the first ``pair_cap_c`` pairs
    and ``surv_cap`` survivors of a chunk; each one counts in
    ``overflow``, and the caller renders again at grown caps for an exact
    image. Indices past a cap land in a dump row, never outside a tensor.
    The pair count is exact unless the photon or query cap overflowed.
    ``n_paths`` is the query tables' column count; the photon table may
    have more columns (the sharded all-gather): each side's path lengths
    come from its own column count. The per-iteration scalars of ``misc``
    may be Python floats or 0-dim float32 device tensors.

    Differentiable in the vertex payload (in_dir, normal, throughput,
    d_vcm, d_vm) and the materials; positions enter only the detached cell
    and distance tests, as the JAX merge's stop_gradient keeps them."""
    n = queries.valid.shape[1]
    n_ph = light_verts.valid.shape[1]
    if n != n_paths:
        raise ValueError(f"merge_stage: {n} query columns, n_paths {n_paths}")
    if query_cap % merge_chunks:
        raise ValueError(f"query_cap {query_cap} is not a multiple of "
                         f"merge_chunks {merge_chunks}")
    dev = queries.valid.device
    flat = lambda a: a.reshape(-1)
    gather = lambda v, idx: V3(*(flat(c)[idx] for c in v))
    i32 = torch.int32
    f2i = lambda a: a.contiguous().view(i32)
    radius = cell_merge._dev_scalar(misc.radius, dev)
    radius_sqr = cell_merge._dev_scalar(misc.radius_sqr, dev)

    # ---- 1. Photons: full-width hashes, one sort-compaction. ---------------
    grid = _photon_grid(light_verts, radius, num_cells)
    n_p = flat(light_verts.valid).sum()
    ovf_p = (n_p - photon_cap).clamp_min(0)
    ppos_s, src_p = grid_ops.sort_compact_planes(
        grid.hashes, torch.stack([flat(c).detach()
                                  for c in light_verts.position]),
        photon_cap)
    p_len = torch.div(src_p, n_ph, rounding_mode="floor") + 1
    cell_start = torch.cumsum(grid.count, 0) - grid.count
    # A pair's photon fields: position bits and path length, planar [4,
    # photon_cap] (a gather by pair then reads each field contiguously).
    p1 = torch.stack([f2i(ppos_s[0]), f2i(ppos_s[1]), f2i(ppos_s[2]),
                      p_len.to(i32)])

    # ---- 2. Queries: compaction, probe, 20 int32 fields a query. --------
    qvalid = flat(queries.valid)
    n_q = qvalid.sum()
    ovf_q = (n_q - query_cap).clamp_min(0)
    qpos, idx_q = grid_ops.sort_compact_planes(
        (~qvalid).to(torch.int64),
        torch.stack([flat(c).detach() for c in queries.position]), query_cap)
    qvalid_c = torch.arange(query_cap, device=dev) < n_q
    q_len = torch.div(idx_q, n, rounding_mode="floor") + 1
    q_path = torch.remainder(idx_q, n)
    cells, live = _probe_cells(grid, radius, list(qpos), qvalid_c,
                               num_cells)
    starts8 = cell_start[cells]                           # [8, query_cap]
    counts8 = torch.where(live, grid.count[cells], 0)
    per_q = counts8.sum(0)
    # Inclusive per-cell boundaries b1..b8 and start-minus-prefix, so a
    # pair finds its photon row as adj_j + rank by arithmetic alone.
    incl = torch.cumsum(counts8, 0)
    adj = starts8 - (incl - counts8)
    # [xbits ybits zbits | len | b1..b8 | adj0..adj7], planar [20,
    # query_cap]; the chunk's pair offset field goes in front below.
    qrow20 = torch.cat([f2i(qpos[0])[None], f2i(qpos[1])[None],
                        f2i(qpos[2])[None], q_len.to(i32)[None],
                        incl.to(i32), adj.to(i32)])

    # ---- 3+4. Per query chunk: expand, test, compact, evaluate, sum. -----
    qc_n = query_cap // merge_chunks
    pair_cap_c = max(pair_cap // merge_chunks
                     + (pair_cap // (2 * merge_chunks)
                        if merge_chunks > 1 else 0), 1024)
    surv_cap = min(pair_cap_c, max(pair_cap_c // 4, 1024))
    # Survivor keys hold the pair id below a flag bit at 2^30.
    if pair_cap_c >= 1 << 30:
        raise ValueError(f"{pair_cap_c} pair rows a chunk: at most 2^30 - 1 "
                         f"(raise merge_chunks)")
    p_iota = torch.arange(pair_cap_c, device=dev)
    p32 = p_iota.to(i32)
    mats = scene.materials
    ovf_pe = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    acc = []
    for c in range(merge_chunks):
        base = c * qc_n
        per_q_ch = per_q[base:base + qc_n]
        incl_q = torch.cumsum(per_q_ch, 0)
        offs = incl_q - per_q_ch
        total = incl_q[-1]
        ovf_pe = ovf_pe + (total - pair_cap_c).clamp_min(0)
        pairs = pairs + total
        qrow = torch.cat([offs.to(i32)[None],
                          qrow20[:, base:base + qc_n]])   # [21, qc_n]
        # Segment carry, JAX's scatter-max of each non-empty query's id at
        # its first pair and running max, in the form of two cumsums (a
        # CUDA cummax is one slow generic scan): a pair's query is the
        # r-th non-empty one (0 before the first), r the heads at or
        # before it. Non-empty queries' offsets are distinct and rise with
        # their ids; empty queries and offsets past the cap write to dump
        # rows.
        nonempty = per_q_ch > 0
        ids = torch.zeros((qc_n + 2,), dtype=torch.int64, device=dev)
        ids[torch.where(nonempty, torch.cumsum(nonempty, 0), qc_n + 1)] = \
            torch.arange(qc_n, device=dev)
        head = torch.zeros((pair_cap_c + 1,), dtype=i32, device=dev)
        head.scatter_(0, torch.where(nonempty, offs, pair_cap_c).clamp_max(
            pair_cap_c), 1)
        qseg = ids[torch.cumsum(head[:pair_cap_c], 0, dtype=i32)]
        qr = qrow[:, qseg]                                # [21, pair_cap_c]
        rank = p_iota - qr[0]
        ok = (p_iota < total) & (rank >= 0) & (rank < qr[12])
        # Cell pick: the smallest j with rank < b_{j+1}.
        php = qr[20]
        for j in range(6, -1, -1):
            php = torch.where(rank < qr[5 + j], qr[13 + j], php)
        php = (php + rank).clamp(0, photon_cap - 1)
        pr = p1[:, php]                                   # [4, pair_cap_c]
        d = [pr[k].view(torch.float32) - qr[1 + k].view(torch.float32)
             for k in range(3)]
        tlen = pr[3] + qr[4]
        ok = (ok & (d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= radius_sqr)
              & (tlen <= max_path_length) & (tlen >= min_path_length))

        # Survivors, in pair order, by one sort of (flag | pair id) keys.
        key = torch.where(ok, p32, p32 | (1 << 30))
        p_c = (torch.sort(key).values[:surv_cap] & ((1 << 30) - 1)).long()
        n_surv = ok.sum()
        ovf_pe = ovf_pe + (n_surv - surv_cap).clamp_min(0)
        ok2 = torch.arange(surv_cap, device=dev) < n_surv
        qs = qseg[p_c]                                    # chunk's query
        q_src = idx_q[qs + base]
        p_src = src_p[php[p_c]]

        cam_b = bsdf_ops.setup(
            mats, gather(queries.in_dir, q_src),
            gather(queries.normal, q_src), flat(queries.mat_id)[q_src], ok2)
        ph_in = gather(light_verts.in_dir, p_src)
        # The light vertex's continuation probability: its BSDF setup.
        ph_b = bsdf_ops.setup(
            mats, ph_in, gather(light_verts.normal, p_src),
            flat(light_verts.mat_id)[p_src], ok2)
        factor, _, dir_pdf_w, rev_pdf_w = bsdf_ops.evaluate(
            mats, cam_b, -ph_in)
        ok2 = ok2 & max_gt_zero(factor)
        dir_pdf_w = dir_pdf_w * cam_b.cont_prob
        rev_pdf_w = rev_pdf_w * ph_b.cont_prob
        if ppm:
            mis = torch.ones_like(dir_pdf_w)
        else:
            w_light = (flat(light_verts.d_vcm)[p_src] * misc.mis_vc_weight
                       + flat(light_verts.d_vm)[p_src] * _mis(dir_pdf_w))
            w_camera = (flat(queries.d_vcm)[q_src] * misc.mis_vc_weight
                        + flat(queries.d_vm)[q_src] * _mis(rev_pdf_w))
            mis = 1.0 / (w_light + 1.0 + w_camera)
        contrib = v3_where(
            ok2, factor * gather(light_verts.throughput, p_src) * mis, 0.0)
        # Each query lies in one chunk: its sum is this chunk's alone.
        acc.append(deterministic_index_add(
            qc_n, torch.where(ok2, qs, qc_n), contrib.to_array()))

    # Scale by the camera throughput and the vm normalization; route each
    # query to its path.
    acc = torch.cat(acc) * gather(queries.throughput, idx_q).to_array() \
        * misc.vm_normalization
    z = deterministic_index_add(n_paths, torch.where(qvalid_c, q_path,
                                                     n_paths), acc)
    out = (V3(z[:, 0], z[:, 1], z[:, 2]), ovf_p + ovf_q + ovf_pe,
           torch.stack([pairs, n_p, n_q]))
    trace.stamp("merge_kernel")
    return out


MERGE_BACKENDS = ("auto", "pallas", "xla")
VM_EXCHANGES = ("allgather", "ring")


def pack_vertices(v: StoredVertices) -> torch.Tensor:
    """StoredVertices -> one [17, L, N] f32 table for the cross-rank photon
    exchange, so one collective moves every field: the 15 float fields,
    then mat_id and valid (small integers and 0/1, exact in f32).
    Differentiable in the float fields."""
    return torch.stack([*v.position, *v.throughput, *v.in_dir, *v.normal,
                        v.d_vcm, v.d_vc, v.d_vm,
                        v.mat_id.to(torch.float32), v.valid.to(torch.float32)])


def unpack_vertices(t: torch.Tensor) -> StoredVertices:
    """Inverse of :func:`pack_vertices` (views of ``t``)."""
    return StoredVertices(
        position=V3(t[0], t[1], t[2]), throughput=V3(t[3], t[4], t[5]),
        in_dir=V3(t[6], t[7], t[8]), normal=V3(t[9], t[10], t[11]),
        d_vcm=t[12], d_vc=t[13], d_vm=t[14], mat_id=t[15].long(),
        valid=t[16] > 0.0,
    )


def merge_chunks_for(pair_factor: float, n: int) -> int:
    """Query chunks of the pair merge for ``n`` paths: one per ~16M pair
    rows (about 1.4 GB of int32 rows), the JAX package's rule
    (render.py:419-424)."""
    return max(1, -(-int(pair_factor * n) // (16 << 20)))


def _merge(scene, misc, queries, verts, ppm: bool, max_path_length: int,
           min_path_length: int, n_paths_global: int, merge_backend: str,
           vm_exchange: str, group, pair_factor: float = 24.0,
           photon_factor: float | None = None,
           query_factor: float | None = None, merge_chunks: int = 1):
    """The deferred merge of this process's queries -> (color_add V3 [n],
    overflow int64, stats int64 [candidate pairs, live photons, live
    queries]), with no host read.

    The pair merge (``merge_backend="xla"``) runs at the JAX package's
    static caps (vcm.py:1335-1344): ``8 * n_paths_global`` hash cells,
    ``pair_factor * n`` pair rows, photon rows ``photon_factor`` times
    the global paths (all-gather, single process) or this rank's (each
    ring hop), query rows ``query_factor * n`` (factors None: 3.0, the
    JAX defaults), in ``merge_chunks`` query chunks; a truncation counts
    in the overflow. The cell merge takes the same photon and query rows
    (:func:`merge_caps` of the factors over the global paths or a hop's,
    and this process's queries), in a single process and under
    ``group`` alike: a live count above a cap counts in the overflow,
    which the sharded callers sum over ranks, so every rank grows to the
    same caps (render.py). With factors None its tables are the slot
    counts, which nothing overflows.

    Single process: against its own photons. With ``group``, against every
    rank's: "allgather" gathers the packed tables in rank order, so the
    merge sees the single-process table element for element; "ring" keeps
    them resident and passes each rank's table on to rank + 1 between
    hops, W merges and W - 1 shifts (merging is additive over photons;
    pairs are summed over hops, photon and query counts maxed, as the JAX
    package does)."""
    n = queries.valid.shape[1]
    if merge_backend == "xla":
        pf = 3.0 if photon_factor is None else photon_factor
        qf = 3.0 if query_factor is None else query_factor
        query_cap = _pad_mult(int(qf * n), 8 * merge_chunks)

        def merge(lv, photon_cap):
            return merge_stage(
                scene, misc, queries, lv, 8 * n_paths_global,
                int(pair_factor * n), ppm, max_path_length, min_path_length,
                _pad_mult(photon_cap, 8), query_cap, n, merge_chunks)

        one = lambda lv: merge(lv, int(pf * n_paths_global))
        hop = lambda lv: merge(lv, int(pf * n))
    else:
        def cells(lv, photons):
            caps = ((None, None) if photon_factor is None else (
                merge_caps(photon_factor, query_factor, photons)[0],
                merge_caps(photon_factor, query_factor, n)[1]))
            return cell_merge.merge_stage(
                scene, misc, queries, lv, ppm, max_path_length,
                min_path_length, n, *caps, with_stats=True)

        one = lambda lv: cells(lv, n_paths_global)
        hop = lambda lv: cells(lv, n)
    if group is None:
        return one(verts)
    if vm_exchange == "allgather":
        gathered = unpack_vertices(
            comm.all_gather_columns(pack_vertices(verts), group))
        trace.stamp("exchange")
        return one(gathered)
    # The hops' merges and shifts interleave: one stage clock, "ring".
    with trace.paused():
        color, overflow, stats = hop(verts)
        visiting = pack_vertices(verts)
        for _ in range(comm.world_size(group) - 1):
            visiting = comm.ring_shift(visiting, group)
            c, o, st = hop(unpack_vertices(visiting))
            color = color + c
            overflow = overflow + o
            stats = torch.stack([stats[0] + st[0],
                                 torch.maximum(stats[1], st[1]),
                                 torch.maximum(stats[2], st[2])])
    trace.stamp("ring")
    return color, overflow, stats


def render_iteration_core(
    scene: SceneData,
    iteration: int,
    pix,
    res_x: int,
    res_y: int,
    n_paths_global: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    rng_kind: str = "threefry",
    merge_backend: str = "auto",
    vm_exchange: str = "allgather",
    group=None,
    pair_factor: float = 24.0,
    photon_factor: float | None = None,
    query_factor: float | None = None,
    merge_chunks: int = 1,
):
    """One VCM-family iteration over the path ids ``pix``, stage by stage
    -> (this process's image [resY, resX, 3] f32, ray_count, merge
    overflow int64, merge stats int64 [candidate pairs, live photons,
    live queries]).

    ``pix`` holds *global* path/pixel ids: RNG streams and the camera pixel
    mapping depend only on them, so any partition of
    ``arange(n_paths_global)`` over processes reproduces the
    single-process paths. The MIS constants use the *global* light path
    count (vertexcm.hxx:303-308). With ``group`` (a torch.distributed
    process group, parallel/sharding.py) the merge sees every rank's
    photons through ``vm_exchange`` (see :func:`_merge`); light-tracing
    splats land anywhere in the full frame, so the image is this process's
    share, summed over ranks by the caller.

    ``merge_backend``: "auto" and "pallas" take the cell merge
    (ops/merge.py: the Hopper kernel on CUDA, its plain version on the
    CPU), the port of the JAX package's Pallas merge; "xla" takes the
    differentiable pair merge :func:`merge_stage`, the JAX package's XLA
    merge. The caps: see :func:`_merge`.

    The ray count is path segments plus enabled shadow/connection rays,
    the reference-comparable work metric (bench.py's count)."""
    if merge_backend not in MERGE_BACKENDS:
        raise ValueError(f"merge_backend must be one of {MERGE_BACKENDS}, "
                         f"not {merge_backend!r}")
    if vm_exchange not in VM_EXCHANGES:
        raise ValueError(f"vm_exchange must be one of {VM_EXCHANGES}, "
                         f"not {vm_exchange!r}")
    dev = scene.device
    trace.stamp("start", iteration)
    misc = compute_misc(scene, iteration, n_paths_global, radius_factor,
                        radius_alpha, use_vc, use_vm)
    fb = new_fb_planes(res_x, res_y, dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    stats = torch.zeros((3,), dtype=torch.int64, device=dev)

    # ---- Stage 1: light sub-paths.
    verts, fb, ray_count = trace_light_paths(
        scene, misc, pix, iteration, fb, base_seed, max_path_length,
        min_path_length, use_vc, use_vm, light_trace_only, rng_kind,
    )
    if light_trace_only:
        img = fb.to_array()
        trace.stamp("finish")
        return img, ray_count, overflow, stats

    # ---- Stage 2: camera sub-paths.
    color, queries, cam_rays = _camera_stage(
        scene, misc, verts, pix, iteration, res_x, base_seed,
        max_path_length, min_path_length, use_vc, use_vm, ppm, rng_kind,
    )

    # ---- Stage 3: deferred merging.
    if use_vm:
        mc, overflow, stats = _merge(
            scene, misc, queries, verts, ppm, max_path_length,
            min_path_length, n_paths_global, merge_backend, vm_exchange,
            group, pair_factor, photon_factor, query_factor, merge_chunks)
        color = color + mc

    # Camera contributions always land on the path's own pixel.
    img = add_color_at_pix(fb, pix, color).to_array()
    trace.stamp("finish")
    return img, ray_count + cam_rays, overflow, stats


def render_iteration(
    scene: SceneData,
    iteration: int,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    rng_kind: str = "threefry",
    merge_backend: str = "auto",
    pair_factor: float = 24.0,
    photon_factor: float | None = None,
    query_factor: float | None = None,
    merge_chunks: int = 1,
):
    """One VCM-family iteration over every pixel of the frame on the
    scene's device -> (image [resY, resX, 3] f32, ray_count int64 tensor):
    :func:`render_iteration_core` over ``arange(res_x * res_y)``, stage by
    stage. The cell merge's tables are its slot counts (nothing
    overflows); the pair merge runs at the factors' caps (the JAX
    defaults 24 / 3 / 3), truncating as the JAX package's does."""
    n = res_x * res_y
    pix = torch.arange(n, dtype=torch.int64, device=scene.device)
    img, rays, _, _ = render_iteration_core(
        scene, iteration, pix, res_x, res_y, n, base_seed, max_path_length,
        min_path_length, radius_factor, radius_alpha, use_vc, use_vm,
        light_trace_only, ppm, rng_kind, merge_backend,
        pair_factor=pair_factor, photon_factor=photon_factor,
        query_factor=query_factor, merge_chunks=merge_chunks)
    return img, rays


# ---------------------------------------------------------------------------
# The whole iteration as one device program; blocks of iterations.
# ---------------------------------------------------------------------------


def merge_caps(photon_factor: float, query_factor: float,
               n: int) -> tuple[int, int]:
    """(photon_cap, query_cap) rows of the cell merge's tables for ``n``
    paths: the factors' share of the paths, as the JAX package sizes them
    (without its TPU tile padding)."""
    return max(1, int(photon_factor * n)), max(1, int(query_factor * n))


def iteration_static(res_x: int, res_y: int, base_seed: int,
                     max_path_length: int, min_path_length: int,
                     use_vc: bool, use_vm: bool, light_trace_only: bool,
                     ppm: bool, rng_kind: str, photon_factor: float,
                     query_factor: float, merge_backend: str = "auto",
                     pair_factor: float = 24.0,
                     merge_chunks: int = 1) -> tuple:
    """The static arguments of :func:`iteration_stage` (its graph key's
    static part; render.py drops the graph of outgrown caps by it). The
    merge's backend and caps are normalized: factors a merge does not read
    are 0, so they neither split nor drop its graphs."""
    merging = use_vm and not light_trace_only
    pair = merging and merge_backend == "xla"
    return (float(np.float32(res_x * res_y)), res_x, res_y, base_seed,
            max_path_length, min_path_length, use_vc, use_vm,
            light_trace_only, ppm, rng_kind,
            "xla" if pair else "auto",
            float(pair_factor) if pair else 0.0,
            float(photon_factor) if merging else 0.0,
            float(query_factor) if merging else 0.0,
            merge_chunks if pair else 1)


def _iteration_body(
    scene: SceneData, pix, n_paths_global: int, iteration, radius,
    radius_sqr, vm_normalization, mis_vm_weight, mis_vc_weight,
    light_sub_path_count: float, res_x: int, res_y: int, base_seed: int,
    max_path_length: int, min_path_length: int, use_vc: bool, use_vm: bool,
    light_trace_only: bool, ppm: bool, rng_kind: str, merge_backend: str,
    pair_factor: float, photon_factor: float, query_factor: float,
    merge_chunks: int, vm_exchange: str, group,
):
    """The stages of one iteration over the path ids ``pix`` -> (this
    process's image, ray_count, merge overflow, merge stats), with the
    per-iteration scalars as 0-dim device tensors: light walk, splat
    flush, camera stage, the merge at its static caps (:func:`_merge`,
    with ``group`` through ``vm_exchange``), own-pixel accumulation. The
    operations, and their order, of :func:`render_iteration_core`."""
    dev = scene.device
    trace.stamp("start", iteration)
    misc = VcmMisc(radius, radius_sqr, vm_normalization, mis_vm_weight,
                   mis_vc_weight, light_sub_path_count)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    stats = torch.zeros((3,), dtype=torch.int64, device=dev)
    verts, splat_pix, splat_rgb, rays = light_walk(
        scene, pix, iteration, mis_vm_weight, mis_vc_weight,
        light_sub_path_count, res_x, res_y, base_seed, max_path_length,
        min_path_length, use_vc, use_vm, light_trace_only, rng_kind)
    fb = new_fb_planes(res_x, res_y, dev)
    if splat_pix is not None:
        fb = splat_colors(fb, splat_pix, splat_rgb)
    trace.stamp("splat_flush")
    if light_trace_only:
        return fb.to_array(), rays, overflow, stats
    color, queries, cam_rays = camera_walk(
        scene, verts, pix, iteration, mis_vm_weight, mis_vc_weight,
        light_sub_path_count, res_x, base_seed, max_path_length,
        min_path_length, use_vc, use_vm, ppm, rng_kind)
    if use_vm:
        mc, overflow, stats = _merge(
            scene, misc, queries, verts, ppm, max_path_length,
            min_path_length, n_paths_global, merge_backend, vm_exchange,
            group, pair_factor, photon_factor, query_factor, merge_chunks)
        color = color + mc
    fb = add_color_at_pix(fb, pix, color)
    return fb.to_array(), rays + cam_rays, overflow, stats


def iteration_stage(
    scene: SceneData, iteration, radius, radius_sqr, vm_normalization,
    mis_vm_weight, mis_vc_weight, light_sub_path_count: float, res_x: int,
    res_y: int, base_seed: int, max_path_length: int, min_path_length: int,
    use_vc: bool, use_vm: bool, light_trace_only: bool, ppm: bool,
    rng_kind: str, merge_backend: str, pair_factor: float,
    photon_factor: float, query_factor: float, merge_chunks: int,
):
    """One whole VCM-family iteration over every pixel -> (image [resY,
    resX, 3] f32, ray_count, merge overflow int64, merge stats int64 [3]),
    all on the device: light walk, splat flush, camera stage, the merge at
    its static caps (the cell merge, or the pair merge for
    ``merge_backend="xla"``; :func:`_merge`), own-pixel accumulation.

    ``iteration`` and the five per-iteration scalars are 0-dim device
    tensors (graphs.stage fills them before each replay; compute_misc's
    floats, exactly); nothing here reads the host, so on a card the whole
    function is one CUDA graph. Same operations, in the same order, as
    :func:`render_iteration_core` at the same caps: the same bits."""
    n = res_x * res_y
    pix = torch.arange(n, dtype=torch.int64, device=scene.device)
    out = _iteration_body(
        scene, pix, n, iteration, radius, radius_sqr, vm_normalization,
        mis_vm_weight, mis_vc_weight, light_sub_path_count, res_x, res_y,
        base_seed, max_path_length, min_path_length, use_vc, use_vm,
        light_trace_only, ppm, rng_kind, merge_backend, pair_factor,
        photon_factor, query_factor, merge_chunks, "allgather", None)
    trace.stamp("finish")
    return out


def sharded_static(static: tuple, vm_exchange: str, group) -> tuple:
    """The static arguments of :func:`sharded_iteration_stage`:
    :func:`iteration_static`'s, then the photon exchange, the group's size,
    this rank and the group itself (by identity), so that graphs of other
    groups and exchanges stay apart."""
    return (*static, vm_exchange, comm.world_size(group), comm.rank(group),
            group)


def sharded_iteration_stage(
    scene: SceneData, iteration, radius, radius_sqr, vm_normalization,
    mis_vm_weight, mis_vc_weight, light_sub_path_count: float, res_x: int,
    res_y: int, base_seed: int, max_path_length: int, min_path_length: int,
    use_vc: bool, use_vm: bool, light_trace_only: bool, ppm: bool,
    rng_kind: str, merge_backend: str, pair_factor: float,
    photon_factor: float, query_factor: float, merge_chunks: int,
    vm_exchange: str, world: int, rank: int, group,
):
    """One whole VCM-family iteration on this rank's path shard ``[rank *
    n / W, (rank + 1) * n / W)`` of ``group`` -> (image summed over the
    ranks, ray_count, overflow, stats [3]), every output summed over the
    ranks and replicated: the counterpart of the JAX package's
    ``_vcm_program`` (sharding.py:144-191), whose ``psum``s
    (vcm.py:1387-1391) are :func:`comm.framebuffer_sum` of the image and
    one :func:`comm.all_reduce_sum` of [rays, overflow, stats].

    The stages of :func:`iteration_stage` on the shard, with the photon
    exchange inside: the all-gather, or W merges and W - 1 ring shifts in
    a static loop (:func:`_merge`), the merges at their static caps. The
    same operations, in the same order, as the stage-by-stage
    ``parallel/sharding.py::sharded_render_iteration_with_stats`` at the
    same caps: the same bits. Nothing here reads the host, so on an NCCL
    group's card the whole function, collectives included, is one CUDA
    graph (graphs.stage; the key's :func:`sharded_static` part holds the
    exchange, W, the rank and the group)."""
    n = res_x * res_y
    m = n // world
    pix = torch.arange(rank * m, (rank + 1) * m, dtype=torch.int64,
                       device=scene.device)
    img, rays, overflow, stats = _iteration_body(
        scene, pix, n, iteration, radius, radius_sqr, vm_normalization,
        mis_vm_weight, mis_vc_weight, light_sub_path_count, res_x, res_y,
        base_seed, max_path_length, min_path_length, use_vc, use_vm,
        light_trace_only, ppm, rng_kind, merge_backend, pair_factor,
        photon_factor, query_factor, merge_chunks, vm_exchange, group)
    counts = comm.all_reduce_sum(
        torch.cat([rays.reshape(1), overflow.reshape(1), stats]), group)
    img = comm.framebuffer_sum(img, group)
    trace.stamp("finish")
    return img, counts[0], counts[1], counts[2:]


def render_block_with_stats(
    scene: SceneData,
    start_iteration: int,
    res_x: int,
    res_y: int,
    block: int = 1,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
    rng_kind: str = "threefry",
    accum=None,
    pair_factor: float = 24.0,
    merge_chunks: int = 1,
    merge_backend: str = "auto",
    group=None,
    vm_exchange: str = "allgather",
):
    """``block`` consecutive iterations, each one replay of the
    :func:`iteration_stage` graph on a card (with ``group``, of the
    :func:`sharded_iteration_stage` graph of this rank, the photon
    exchange ``vm_exchange`` and the sums over ranks inside it) ->
    (image sum [resY, resX, 3],
    ray_count, overflow_sum, stats_max, luminance), all device tensors:
    the counterpart of the JAX package's ``render_block_with_stats``
    (vcm.py:1647-1715). Overflow is summed so that any overflowing
    iteration shows; stats are maxed, for cap sizing.

    The image sum starts at ``accum`` (default zeros, the JAX function's
    block sum) and adds the iterations one by one: render.py passes its
    running accumulator, so a render's bits do not depend on how its
    iterations were cut into blocks. ``merge_backend``: "auto" (the
    port's default) and "pallas" take the cell merge at
    :func:`merge_caps` of the factors, "xla" the pair merge at
    ``pair_factor`` and the factors, in ``merge_chunks`` query chunks;
    the luminance is framebuffer.hxx:89-102's of the sum. With
    ``group`` every rank calls this alike and every output is the
    group's, replicated; the group must be capturable on a card (NCCL:
    ``comm.capturable``), since a gloo group's collectives stage through
    host memory (render.py runs those ranks stage by stage)."""
    if merge_backend not in MERGE_BACKENDS:
        raise ValueError(f"merge_backend must be one of {MERGE_BACKENDS}, "
                         f"not {merge_backend!r}")
    if vm_exchange not in VM_EXCHANGES:
        raise ValueError(f"vm_exchange must be one of {VM_EXCHANGES}, "
                         f"not {vm_exchange!r}")
    n = res_x * res_y
    dev = scene.device
    static = iteration_static(res_x, res_y, base_seed, max_path_length,
                              min_path_length, use_vc, use_vm,
                              light_trace_only, ppm, rng_kind, photon_factor,
                              query_factor, merge_backend, pair_factor,
                              merge_chunks)
    fn = iteration_stage
    if group is not None:
        if dev.type == "cuda" and not comm.capturable(group):
            raise ValueError(
                "a gloo group's collectives stage through host memory and "
                "cannot run inside a CUDA graph: render its iterations "
                "stage by stage (parallel/sharding.py)")
        w = comm.world_size(group)
        if n % w != 0:
            raise ValueError(f"path count {n} not divisible by {w} devices")
        fn, static = sharded_iteration_stage, sharded_static(
            static, vm_exchange, group)
    acc = (torch.zeros((res_y, res_x, 3), dtype=torch.float32, device=dev)
           if accum is None else accum)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    stats = torch.zeros((3,), dtype=torch.int64, device=dev)
    for j in range(block):
        it = start_iteration + j
        m = compute_misc(scene, it, n, radius_factor, radius_alpha, use_vc,
                         use_vm)
        img, r, o, st = graphs.stage(
            fn, scene, (),
            (it, m.radius, m.radius_sqr, m.vm_normalization,
             m.mis_vm_weight, m.mis_vc_weight), static)
        acc = acc + img
        rays = rays + r
        overflow = overflow + o
        stats = torch.maximum(stats, st)
    return acc, rays, overflow, stats, total_luminance(acc)


def trace_iteration(
    scene: SceneData, iteration: int, res_x: int, res_y: int,
    base_seed: int = 1234, max_path_length: int = 10,
    min_path_length: int = 0, radius_factor: float = 0.003,
    radius_alpha: float = 0.75, use_vc: bool = True, ppm: bool = False,
    rng_kind: str = "threefry",
) -> tuple[StoredVertices, StoredVertices]:
    """The light vertices and merge queries of one merging iteration ->
    (vertices, queries), outside any graph: the light walk and the camera
    stage run eagerly (the JAX package's ``trace_iteration``)."""
    n = res_x * res_y
    dev = scene.device
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    m = compute_misc(scene, iteration, n, radius_factor, radius_alpha, use_vc,
                     True)
    it, vm_w, vc_w = (graphs._scalar(v, dev) for v in (
        iteration, m.mis_vm_weight, m.mis_vc_weight))
    verts, _, _, _ = light_walk(
        scene, pix, it, vm_w, vc_w, m.light_sub_path_count, res_x, res_y,
        base_seed, max_path_length, min_path_length, use_vc, True, False,
        rng_kind)
    _, queries, _ = camera_walk(
        scene, verts, pix, it, vm_w, vc_w, m.light_sub_path_count, res_x,
        base_seed, max_path_length, min_path_length, use_vc, True, ppm,
        rng_kind)
    return verts, queries


def merge_demand_iteration(
    scene: SceneData, iteration: int, traced, res_x: int, res_y: int,
    radius_factor: float = 0.003, radius_alpha: float = 0.75,
) -> torch.Tensor:
    """The exact demand of the pair merge on a traced iteration
    (:func:`trace_iteration`) -> int64 [candidate pairs, live photons,
    live queries] on the device: the JAX package's
    ``merge_demand_iteration`` (vcm.py:1718-1795). No caps and no sort:
    the same hash cells and 2x2x2 probe as :func:`merge_stage` (collisions
    included), so the pairs equal ``stats[0]`` of an uncapped merge."""
    verts, queries = traced
    n = res_x * res_y
    flat = lambda a: a.reshape(-1)
    num_cells = 8 * n  # _merge's hash-cell count
    m = compute_misc(scene, iteration, n, radius_factor, radius_alpha, True,
                     True)
    radius = cell_merge._dev_scalar(m.radius, scene.device)
    grid = _photon_grid(verts, radius, num_cells)
    qv = flat(queries.valid)
    cells, live = _probe_cells(
        grid, radius, [flat(c).detach() for c in queries.position], qv,
        num_cells)
    pairs = torch.where(live, grid.count[cells], 0).sum()
    return torch.stack([pairs, flat(verts.valid).sum(), qv.sum()])


def merge_measure_iteration(
    scene: SceneData, iteration: int, res_x: int, res_y: int,
    base_seed: int = 1234, max_path_length: int = 10,
    min_path_length: int = 0, radius_factor: float = 0.003,
    radius_alpha: float = 0.75, use_vc: bool = True, ppm: bool = False,
    rng_kind: str = "threefry",
) -> tuple[int, int, int]:
    """The merge demand of one merging iteration -> (candidate pairs of
    the pair merge, live photons, live queries), from one host read:
    :func:`trace_iteration` and :func:`merge_demand_iteration`, whose
    counts size the caps (render.py::_ensure_merge_caps); vertex counts
    do not depend on the caps or the radius."""
    traced = trace_iteration(scene, iteration, res_x, res_y, base_seed,
                             max_path_length, min_path_length, radius_factor,
                             radius_alpha, use_vc, ppm, rng_kind)
    pairs, n_p, n_q = merge_demand_iteration(
        scene, iteration, traced, res_x, res_y, radius_factor,
        radius_alpha).tolist()
    merge_measure_iteration.calls += 1
    return pairs, n_p, n_q


# Calls in this process (chip_smoke.py: a cached run measures nothing).
merge_measure_iteration.calls = 0
