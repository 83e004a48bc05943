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
     is equivalent to the reference's inline loop: the plain cell merge
     (ops/merge.py);
  4. framebuffer accumulation on each path's own pixel.

The JAX ``lax.fori_loop`` bounce loops are Python loops here, and the
camera loop is the JAX package's *unrolled* form: bounce i connects to the
static window of w_i = min(maxL, maxPath - 2 - i) light slots, which is
the only part of the vertex table its path lengths can reach.

In this copy every stage runs eagerly (graphs.py) and the merge is the
plain cell merge: what the port runs as one CUDA graph an iteration, at
static caps, under a process group or in blocks is left out.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..core import rng
from ..core.vec3 import V3, dot, len_sqr, max_gt_zero, v3_where
from ..core.vecmath import EPS_RAY, PI_F, pdf_w_to_a, sqr
from ..io.framebuffer import add_color_at_pix, new_fb_planes, splat_colors
from ..ops import bsdf as bsdf_ops
from ..ops import lights as light_ops
from ..ops import merge as cell_merge
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


def _scene_radius(scene: SceneData) -> float:
    """The scene sphere's radius as a host float."""
    return float(scene.scene_sphere.radius)


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
    :func:`light_walk` through graphs.stage (the port's one graph, called
    eagerly here), then the flush of its camera splats into ``fb``."""
    res_y, res_x = fb.x.shape
    verts, splat_pix, splat_rgb, rays = graphs.stage(
        light_walk, scene, (pix,),
        (iteration, misc.mis_vm_weight, misc.mis_vc_weight),
        (misc.light_sub_path_count, res_x, res_y, base_seed,
         max_path_length, min_path_length, use_vc, use_vm, light_trace_only,
         rng_kind))
    if splat_pix is not None:
        fb = splat_colors(fb, splat_pix, splat_rgb)
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
    (:class:`StageMisc`), as in the port, where the function runs as one
    CUDA graph. The camera splats are recorded per bounce
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
    :func:`camera_walk` through graphs.stage (the port's one graph, called
    eagerly here)."""
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
    return color, queries, rays


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
):
    """One VCM-family iteration over every pixel of the frame on the
    scene's device, stage by stage -> (image [resY, resX, 3] f32,
    ray_count int64 tensor).

    Path ``p`` is pixel ``p``: RNG streams and the camera pixel mapping
    depend only on it. The MIS constants use the light path count
    (vertexcm.hxx:303-308). The merge is the plain cell merge
    (ops/merge.py) against every photon of the iteration, its tables at
    the slot counts, which nothing overflows.

    The ray count is path segments plus enabled shadow/connection rays,
    the reference-comparable work metric (bench.py's count)."""
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
        color = color + cell_merge.merge_stage(
            scene, misc, queries, verts, ppm, max_path_length,
            min_path_length, n)

    # Camera contributions always land on the path's own pixel.
    fb = add_color_at_pix(fb, pix, color)
    return fb.to_array(), ray_count + cam_rays
