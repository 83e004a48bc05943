"""Wavefront unidirectional path tracer with NEE and 2-pdf balance MIS.

Port of ``smallvcm_tpu/algorithms/pathtracer.py`` (the reference's
recursive per-pixel loop, pathtracer.hxx:45-215, as fixed-depth masked
iteration): the whole image's paths advance one bounce per step of a
Python loop; the reference's early ``break``s are ``alive``-mask updates
and contributions are accumulated where-masked. Every ``_safe_div`` and the
miss-lane ``dist_safe`` clamp of the JAX version is kept: they keep masked
lanes free of inf/NaN, which would otherwise poison backward passes
through ``0 * inf``. The port runs the whole pass (:func:`render_pass`) as
one CUDA graph; here graphs.stage calls it eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..core import rng
from ..core.vec3 import V3, max_gt_zero, v3_where
from ..core.vecmath import EPS_RAY, pdf_a_to_w
from ..io.framebuffer import add_color_at_pix, new_fb_planes
from ..ops import bsdf as bsdf_ops
from ..ops import lights as light_ops
from ..ops.intersect import intersect, occluded
from ..scene.camera import generate_ray
from ..scene.scene import SceneData


def _safe_div(a, b):
    return a / torch.where(b == 0.0, 1.0, b)


def _mis2(sample_pdf, other_pdf):
    """Balance heuristic for 2 pdfs (pathtracer.hxx:226-231)."""
    return _safe_div(sample_pdf, sample_pdf + other_pdf)


class _PtState(NamedTuple):
    org: V3
    direction: V3
    weight: V3
    color: V3
    last_specular: torch.Tensor  # [N] bool
    last_pdf_w: torch.Tensor     # [N]
    alive: torch.Tensor          # [N] bool


def render_iteration(
    scene: SceneData,
    iteration: int,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    rng_kind: str = "threefry",
):
    """One PT pass over every pixel -> (image [resY, resX, 3], ray_count):
    :func:`render_core` over ``arange(res_x * res_y)``."""
    pix = torch.arange(res_x * res_y, dtype=torch.int64, device=scene.device)
    return render_core(scene, iteration, pix, res_x, res_y, base_seed,
                       max_path_length, min_path_length, rng_kind)


def render_core(
    scene: SceneData,
    iteration: int,
    pix,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    rng_kind: str = "threefry",
):
    """One PT pass over the global pixel ids ``pix`` -> (full-frame image
    [resY, resX, 3] holding those pixels, ray_count).

    RNG streams key off global pixel ids, as in the JAX package, so any
    partition of the pixels over processes renders the same paths. The ray
    count is path segments plus the shadow rays of enabled NEE connections
    (the VCM family's count).

    :func:`render_pass` through graphs.stage, eagerly."""
    return graphs.stage(render_pass, scene, (pix,), (iteration,),
                        (res_x, res_y, base_seed, max_path_length,
                         min_path_length, rng_kind))


def render_pass(scene: SceneData, pix, iteration, res_x: int, res_y: int,
                base_seed: int, max_path_length: int, min_path_length: int,
                rng_kind: str):
    """The body of :func:`render_core`, with the iteration a 0-dim int64
    device tensor and no host read (in the port, a CUDA graph's body)."""
    dev = scene.device
    n = pix.shape[0]
    x = torch.remainder(pix, res_x).to(torch.float32)
    y = torch.div(pix, res_x, rounding_mode="floor").to(torch.float32)

    light_count = scene.lights.kind.shape[0]
    light_pick_prob = 1.0 / light_count
    has_background = scene.background_idx >= 0

    jitter = rng.uniform_slots(
        base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_JITTER), pix, 2,
        rng_kind,
    )
    org, direction = generate_ray(scene.camera, x + jitter[:, 0],
                                  y + jitter[:, 1])

    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    state = _PtState(
        org=org,
        direction=direction,
        weight=V3(ones, ones, ones),
        color=V3(zeros, zeros, zeros),
        last_specular=torch.ones((n,), dtype=torch.bool, device=dev),
        last_pdf_w=ones,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
    )
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(max_path_length):
        path_length = i + 1  # reference pathLength counter
        rays = rays + state.alive.sum()
        hit = intersect(scene, state.org, state.direction)
        # Clamp miss-lane distances (1e36): masked lanes must not mint
        # inf/NaN (would poison reverse-mode gradients via 0*inf).
        dist_safe = torch.where(hit.hit, hit.dist, 1.0)
        hit_point = state.org + state.direction * dist_safe
        isect_dist = dist_safe + EPS_RAY

        color = state.color
        mis_ok = path_length > 1  # the first hit is never MIS-weighted

        # --- Miss: background radiance (pathtracer.hxx:73-97).
        if has_background and path_length >= min_path_length:
            bg = light_ops.get_radiance(
                scene.lights,
                torch.full((n,), scene.background_idx, dtype=torch.int64,
                           device=dev),
                scene.scene_sphere,
                state.direction,
            )
            # For the background GetRadiance "cheats": directPdfA is W.
            mis = _mis2(state.last_pdf_w, bg.direct_pdf_a * light_pick_prob)
            mis = torch.where(~state.last_specular, mis, 1.0) if mis_ok \
                else torch.ones_like(mis)
            take_bg = state.alive & ~hit.hit & max_gt_zero(bg.radiance)
            color = color + v3_where(take_bg, state.weight * bg.radiance * mis,
                                     0.0)

        alive = state.alive & hit.hit

        b = bsdf_ops.setup(
            scene.materials, state.direction, hit.normal, hit.mat_id, hit.hit
        )
        alive = alive & b.valid

        # --- Direct light hit (pathtracer.hxx:107-129).
        hit_light = alive & (hit.light_id >= 0)
        if path_length >= min_path_length:
            lr = light_ops.get_radiance(
                scene.lights, hit.light_id, scene.scene_sphere,
                state.direction
            )
            direct_pdf_w = pdf_a_to_w(
                lr.direct_pdf_a, isect_dist, b.cos_theta_fix()
            )
            mis_l = _mis2(state.last_pdf_w, direct_pdf_w * light_pick_prob)
            mis_l = torch.where(~state.last_specular, mis_l, 1.0) if mis_ok \
                else torch.ones_like(mis_l)
            take_l = hit_light & max_gt_zero(lr.radiance)
            color = color + v3_where(take_l, state.weight * lr.radiance * mis_l,
                                     0.0)
        alive = alive & ~hit_light  # lights do not reflect

        alive = alive & (b.cont_prob > 0.0)
        if path_length >= max_path_length:
            alive = torch.zeros_like(alive)

        # --- Next event estimation (pathtracer.hxx:138-173).
        u = rng.uniform_slots(
            base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_NEE, i),
            pix, 3, rng_kind,
        )
        light_id = (u[:, 0] * light_count).long().clamp_max(light_count - 1)
        ill = light_ops.illuminate(
            scene.lights, light_id, scene.scene_sphere, hit_point,
            u[:, 1], u[:, 2],
        )
        factor, cos_out, bsdf_pdf_w, _ = bsdf_ops.evaluate(
            scene.materials, b, ill.dir_to_light
        )
        light_is_delta = scene.lights.is_delta[
            light_id.clamp(0, light_count - 1)]
        nee_weight = torch.where(
            light_is_delta,
            1.0,
            _mis2(ill.direct_pdf_w * light_pick_prob, bsdf_pdf_w * b.cont_prob),
        )
        contrib = (ill.radiance * factor) * (
            nee_weight * cos_out * _safe_div(
                1.0, light_pick_prob * ill.direct_pdf_w
            )
        )
        nee_ok = (
            alive
            & ~b.is_delta
            & max_gt_zero(ill.radiance)
            & max_gt_zero(factor)
            & max_gt_zero(contrib)
        )
        if path_length + 1 < min_path_length:
            nee_ok = torch.zeros_like(nee_ok)
        shadowed = occluded(scene, hit_point, ill.dir_to_light, ill.distance,
                            nee_ok)
        color = color + v3_where(nee_ok & ~shadowed, state.weight * contrib,
                                 0.0)
        rays = rays + nee_ok.sum()  # shadow rays

        # --- Continue random walk (pathtracer.hxx:176-209).
        w = rng.uniform_slots(
            base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_WALK, i),
            pix, 4, rng_kind,
        )
        s_factor, s_dir, s_pdf, s_cos, s_event, s_keep = bsdf_ops.sample(
            scene.materials, b, w[:, 0], w[:, 1], w[:, 2], fix_is_light=False
        )
        alive = alive & s_keep

        cont_prob = b.cont_prob
        last_specular = (s_event & bsdf_ops.EV_SPECULAR) != 0
        last_pdf_w = s_pdf * cont_prob

        rr_kill = (cont_prob < 1.0) & (w[:, 3] > cont_prob)
        alive = alive & ~rr_kill
        s_pdf = torch.where(cont_prob < 1.0, s_pdf * cont_prob, s_pdf)

        new_weight = state.weight * s_factor * _safe_div(s_cos, s_pdf)
        new_org = hit_point + s_dir * EPS_RAY

        state = _PtState(
            org=v3_where(alive, new_org, state.org),
            direction=v3_where(alive, s_dir, state.direction),
            weight=v3_where(alive, new_weight, state.weight),
            color=color,
            last_specular=torch.where(alive, last_specular,
                                      state.last_specular),
            last_pdf_w=torch.where(alive, last_pdf_w, state.last_pdf_w),
            alive=alive,
        )

    # Own-pixel accumulate: floor(x + jitter) == x (jitter in [0, 1)).
    fb = add_color_at_pix(new_fb_planes(res_x, res_y, dev), pix, state.color)
    return fb.to_array(), rays
