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
     is equivalent to the reference's inline loop: the tile merge
     (ops/merge.py, the CUDA kernel on a card) or the differentiable
     pair-expansion :func:`merge_stage`;
  4. framebuffer accumulation on each path's own pixel.

The JAX ``lax.fori_loop`` bounce loops are Python loops here, and the
camera loop is the JAX package's *unrolled* form: bounce i connects to the
static window of w_i = min(maxL, maxPath - 2 - i) light slots, which is
the only part of the vertex table its path lengths can reach.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.vec3 import V3, dot, len_sqr, max_gt_zero, v3_where
from ..core.vecmath import EPS_RAY, PI_F, pdf_w_to_a, sqr
from ..io.framebuffer import (add_color_at_pix, deterministic_index_add,
                              new_fb_planes, splat_colors)
from ..ops import bsdf as bsdf_ops
from ..ops import hashgrid as grid_ops
from ..ops import lights as light_ops
from ..ops import merge as tile_merge
from ..ops.intersect import intersect, occluded
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


def compute_misc(
    scene: SceneData, iteration: int, n_light_paths: int, radius_factor,
    radius_alpha, use_vc: bool, use_vm: bool,
) -> VcmMisc:
    f = np.float32
    base_radius = f(radius_factor) * f(float(scene.scene_sphere.radius))
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
    scene: SceneData, misc: VcmMisc, pix, iteration: int, base_seed: int,
    rng_kind: str = "threefry",
) -> SubPathState:
    """GenerateLightSample (vertexcm.hxx:816-858)."""
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
    scene: SceneData, misc: VcmMisc, state: SubPathState, hit_point: V3,
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
    shadowed = occluded(scene, hit_point, dir_to_cam, distance)
    ok = ok & ~shadowed
    return rx, ry, v3_where(ok, contrib, 0.0), ok


def sample_scattering(
    scene: SceneData, misc: VcmMisc, state: SubPathState, hit_point: V3,
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
    """Light stage (vertexcm.hxx:321-396) -> (vertices, fb, ray_count)."""
    n = pix.shape[0]
    dev = pix.device
    max_l = max(1, max_path_length - 1)
    store_vertices = use_vc or use_vm
    connect_cam = use_vc or light_trace_only

    state = generate_light_sample(scene, misc, pix, iteration, base_seed,
                                  rng_kind)
    verts = _empty_vertices(max_l, n, dev)
    # Deferred camera-connection splats: each bounce records (pixel, rgb)
    # rows and one deterministic scatter flushes them after the walk.
    res_y_fb, res_x_fb = fb.x.shape
    pix_sentinel = res_x_fb * res_y_fb
    if connect_cam:
        splat_pix = torch.full((max_l, n), pix_sentinel, dtype=torch.int64,
                               device=dev)
        splat_rgb = V3(*(torch.zeros((max_l, n), dtype=torch.float32,
                                     device=dev) for _ in range(3)))
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(max_l):
        path_length = i + 1

        rays = rays + state.alive.sum()
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

    if connect_cam:
        fb = splat_colors(fb, splat_pix, splat_rgb)
    return verts, fb, rays


# ---------------------------------------------------------------------------
# Camera stage helpers
# ---------------------------------------------------------------------------


def generate_camera_sample(
    scene: SceneData, misc: VcmMisc, pix, res_x: int, iteration: int,
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
    scene: SceneData, misc: VcmMisc, state: SubPathState, hit_point: V3,
    b: bsdf_ops.BsdfState, u3,
) -> V3:
    """DirectIllumination (vertexcm.hxx:663-738): NEE contribution."""
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
    shadowed = occluded(scene, hit_point, ill.dir_to_light, ill.distance)
    return v3_where(ok & ~shadowed, contrib, 0.0)


def connect_vertices(
    scene: SceneData, misc: VcmMisc, cam_d_vcm, cam_d_vc, cam_hit: V3,
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
    shadowed = occluded(scene, cam_hit, direction, distance)
    return v3_where(ok & ~shadowed, contrib, 0.0)


# ---------------------------------------------------------------------------
# Camera stage + merge + the iteration
# ---------------------------------------------------------------------------


def _camera_stage(
    scene, misc, verts, pix, iteration: int, res_x: int, base_seed: int,
    max_path_length: int, min_path_length: int, use_vc: bool, use_vm: bool,
    ppm: bool, rng_kind: str = "threefry",
):
    """Camera sub-paths -> (color V3 [N], queries, ray_count)."""
    n = pix.shape[0]
    dev = pix.device
    sx, sy, state = generate_camera_sample(
        scene, misc, pix, res_x, iteration, base_seed, rng_kind
    )
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    color = V3(zero, zero, zero)
    has_background = scene.background_idx >= 0
    max_l = verts.valid.shape[0]
    queries = _empty_vertices(max_path_length, n, dev) if use_vm else None
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(max_path_length):
        path_length = i + 1
        # Static connection window: full_len = (j+1) + 1 + path_length
        # <= max_path_length bounds the reachable light slot j.
        w_conn = min(max_l, max(0, max_path_length - 1 - (i + 1)))

        rays = rays + state.alive.sum()
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
            nee = direct_illumination(scene, misc, state, hit_point, b, u3)
            nee_on = alive & ~b.is_delta
            if path_length + 1 < min_path_length:
                nee_on = torch.zeros_like(nee_on)
            color = color + v3_where(nee_on, state.throughput * nee, 0.0)
            rays = rays + nee_on.sum()

        # VC: connect to this path's light vertices (vertexcm.hxx:498-526),
        # the w_conn reachable slots at once as [w_conn, N].
        if use_vc and w_conn > 0:
            bro = lambda a: a.unsqueeze(0).expand(w_conn, n)
            brov = lambda v: V3(bro(v.x), bro(v.y), bro(v.z))
            fl = lambda a: a[:w_conn]
            flv = lambda v: V3(fl(v.x), fl(v.y), fl(v.z))

            full_len = [j + 2 + path_length for j in range(w_conn)]
            in_range = torch.tensor(
                [min_path_length <= f <= max_path_length for f in full_len],
                dtype=torch.bool, device=dev,
            )[:, None]
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
    return color, queries, rays


# Pair-expansion merge: chunks hold at most this many candidate pairs
# (about 2 GB of int64/f32 pair arrays), as the JAX package's render loop
# bounds its pair arrays at 16M rows (render.py:419-424).
MAX_PAIRS = 1 << 24


def merge_stage(
    scene: SceneData, misc: VcmMisc, queries: StoredVertices,
    light_verts: StoredVertices, ppm: bool, max_path_length: int,
    min_path_length: int, n_paths: int, num_cells: int | None = None,
    max_pairs: int = MAX_PAIRS,
) -> V3:
    """Vertex merging by exact (query, photon) pair expansion -> color_add
    V3 [n_paths]: the per-path merge radiance, scaled by the camera
    throughput and the vm normalization.

    Port of the JAX package's XLA merge (RangeQuery::Process,
    vertexcm.hxx:130-169): photons are hashed into cells of 2r
    (``num_cells`` buckets, default 8 per path as in the JAX render loop;
    two probe cells of one query that share a bucket visit its photons
    twice, as in the reference's grid) and stably sorted by cell; every live
    query probes its nearest 2x2x2 cells, the candidates are expanded into
    an explicit pair list (hashgrid.expand_pairs), filtered by the exact r^2
    test and the path-length window (vertexcm.hxx:132-135), and the
    survivors get the camera BSDF toward -photon.in_dir and the MIS weight
    1/(w_light + 1 + w_camera) [tech. rep. (38)-(39)] (1 for ppm).

    Differentiable in the vertex payload (in_dir, normal, throughput,
    d_vcm, d_vm) and the materials; positions enter only the detached cell
    and distance tests, as the JAX merge's stop_gradient keeps them.
    Compaction sizes come from the live counts (host reads), so nothing can
    overflow; candidate pairs are processed in query-range chunks of at
    most ``max_pairs``.
    """
    dev = queries.valid.device
    n = queries.valid.shape[1]
    n_ph = light_verts.valid.shape[1]
    num_cells = 8 * n_paths if num_cells is None else num_cells
    flat = lambda a: a.reshape(-1)
    gather = lambda v, idx: V3(*(flat(c)[idx] for c in v))
    zero = torch.zeros((n_paths,), dtype=torch.float32, device=dev)

    pvalid = flat(light_verts.valid)
    qvalid = flat(queries.valid)
    n_p, n_q = (int(v) for v in torch.stack([pvalid.sum(),
                                             qvalid.sum()]).tolist())
    if n_p == 0 or n_q == 0:
        return V3(zero, zero, zero)

    # ---- 1. Photons: the cell-hashed grid (positions detached). ----------
    grid = grid_ops.build(V3(*(flat(c).detach() for c in light_verts.position)),
                          pvalid, misc.radius, num_cells)
    order = grid.sorted_idx[:n_p]                     # live, cell order
    ppos = [flat(c).detach()[order] for c in light_verts.position]
    p_len = torch.div(order, n_ph, rounding_mode="floor") + 1

    # ---- 2. Queries: compact, probe the 2x2x2 neighbourhood. -------------
    idx_q = torch.nonzero(qvalid).flatten()           # source order
    q_len = torch.div(idx_q, n, rounding_mode="floor") + 1
    q_path = torch.remainder(idx_q, n)
    qpos = [flat(c).detach()[idx_q] for c in queries.position]
    starts8, counts8 = grid_ops.query_cell_ranges(grid, num_cells, V3(*qpos))

    # Query-range chunks of at most max_pairs candidates (one host read).
    cum = torch.cumsum(counts8.sum(1), 0)
    n_chunks = -(-int(cum[-1]) // max_pairs)
    ends = torch.searchsorted(
        cum, torch.arange(1, n_chunks, device=dev) * max_pairs, right=True)
    ends = torch.cat([ends, torch.full((1,), n_q, device=dev)])
    cum0 = torch.cat([torch.zeros((1,), dtype=cum.dtype, device=dev), cum])
    bounds = torch.stack([ends, cum0[ends]]).tolist()

    # ---- 3+4. Expand, filter, evaluate, sum per query. ---------------------
    mats = scene.materials
    acc = torch.zeros((n_q, 3), dtype=torch.float32, device=dev)
    q0, c0 = 0, 0
    for q1, c1 in zip(*bounds):
        if c1 > c0:
            qc_idx, php, pair_ok, _, _ = grid_ops.expand_pairs(
                starts8[q0:q1], counts8[q0:q1], c1 - c0)
            qs = torch.div(qc_idx, 8, rounding_mode="floor") + q0
            dx, dy, dz = (p[php] - q[qs] for p, q in zip(ppos, qpos))
            tlen = p_len[php] + q_len[qs]
            pair_ok = (pair_ok & (dx * dx + dy * dy + dz * dz
                                  <= misc.radius_sqr)
                       & (tlen <= max_path_length)
                       & (tlen >= min_path_length))
            sel = torch.nonzero(pair_ok).flatten()
            qs = qs[sel]
            q_src = idx_q[qs]
            p_src = order[php[sel]]
            ones = torch.ones_like(qs, dtype=torch.bool)
            cam_b = bsdf_ops.setup(
                mats, gather(queries.in_dir, q_src),
                gather(queries.normal, q_src), flat(queries.mat_id)[q_src],
                ones)
            ph_in = gather(light_verts.in_dir, p_src)
            ph_b = bsdf_ops.setup(
                mats, ph_in, gather(light_verts.normal, p_src),
                flat(light_verts.mat_id)[p_src], ones)
            factor, _, dir_pdf_w, rev_pdf_w = bsdf_ops.evaluate(
                mats, cam_b, -ph_in)
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
                max_gt_zero(factor),
                factor * gather(light_verts.throughput, p_src) * mis, 0.0)
            acc = acc + deterministic_index_add(n_q, qs, contrib.to_array())
        q0, c0 = q1, c1

    # Scale by the camera throughput and the vm normalization; route each
    # query to its path.
    thr = gather(queries.throughput, idx_q).to_array()
    acc = acc * thr * misc.vm_normalization
    z = deterministic_index_add(n_paths, q_path, acc)
    return V3(z[:, 0], z[:, 1], z[:, 2])


MERGE_BACKENDS = ("auto", "pallas", "xla")


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
):
    """One VCM-family iteration over every pixel of the frame on the
    scene's device -> (image [resY, resX, 3] f32, ray_count int64 tensor).

    ``merge_backend``: "auto" and "pallas" take the tile merge
    (ops/merge.py: the Hopper kernel on CUDA, its plain version on the
    CPU), the JAX package's Pallas design; "xla" takes the differentiable
    pair-expansion :func:`merge_stage`, the JAX package's XLA merge.

    The ray count is path segments plus enabled shadow/connection rays,
    the reference-comparable work metric (bench.py's count)."""
    if merge_backend not in MERGE_BACKENDS:
        raise ValueError(f"merge_backend must be one of {MERGE_BACKENDS}, "
                         f"not {merge_backend!r}")
    dev = scene.device
    n = res_x * res_y
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    misc = compute_misc(scene, iteration, n, radius_factor, radius_alpha,
                        use_vc, use_vm)
    fb = new_fb_planes(res_x, res_y, dev)

    # ---- Stage 1: light sub-paths.
    verts, fb, ray_count = trace_light_paths(
        scene, misc, pix, iteration, fb, base_seed, max_path_length,
        min_path_length, use_vc, use_vm, light_trace_only, rng_kind,
    )
    if light_trace_only:
        return fb.to_array(), ray_count

    # ---- Stage 2: camera sub-paths.
    color, queries, cam_rays = _camera_stage(
        scene, misc, verts, pix, iteration, res_x, base_seed,
        max_path_length, min_path_length, use_vc, use_vm, ppm, rng_kind,
    )

    # ---- Stage 3: deferred merging.
    if use_vm:
        merge = merge_stage if merge_backend == "xla" else \
            tile_merge.merge_stage
        color = color + merge(
            scene, misc, queries, verts, ppm, max_path_length,
            min_path_length, n,
        )

    # Camera contributions always land on the path's own pixel.
    fb = add_color_at_pix(fb, pix, color)
    return fb.to_array(), ray_count + cam_rays
