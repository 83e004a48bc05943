"""Batched light sampling/evaluation for the four light types (SoA vectors).

Port of ``smallvcm_tpu/ops/lights.py``: every lane gathers its picked
light's unified parameter record, all four type formulas are computed and
the result is selected by the type code (lights.hxx:112-514, including the
background light's "pdf lies in area measure" convention, :469-471).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.vec3 import V3, dot, len_sqr, v3_where
from ..core.vecmath import (
    EPS_COSINE,
    INV_PI_F,
    concentric_disc_pdf_a,
    cos_hemisphere_pdf_w,
    frame_set_from_z,
    sample_concentric_disc,
    sample_cos_hemisphere_w,
    sample_uniform_sphere_w,
    sample_uniform_triangle,
    uniform_sphere_pdf_w,
)
from ..scene.scene import (
    LIGHT_AREA,
    LIGHT_BACKGROUND,
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    Lights,
    SceneSphere,
)


class IlluminateResult(NamedTuple):
    radiance: V3                 # zero => sample invalid
    dir_to_light: V3
    distance: torch.Tensor
    direct_pdf_w: torch.Tensor
    emission_pdf_w: torch.Tensor
    cos_at_light: torch.Tensor


class EmitResult(NamedTuple):
    energy: V3
    position: V3
    direction: V3
    emission_pdf_w: torch.Tensor
    direct_pdf_a: torch.Tensor
    cos_theta_light: torch.Tensor
    is_finite: torch.Tensor
    is_delta: torch.Tensor


class RadianceResult(NamedTuple):
    radiance: V3
    direct_pdf_a: torch.Tensor
    emission_pdf_w: torch.Tensor


def _gather(lights: Lights, idx):
    safe = idx.long().clamp(0, lights.kind.shape[0] - 1)
    g = lambda a: a[safe]
    return (
        g(lights.kind), g(lights.p0), g(lights.e1), g(lights.e2),
        g(lights.frame_x), g(lights.frame_y), g(lights.frame_z),
        g(lights.intensity), g(lights.inv_area),
        g(lights.is_finite), g(lights.is_delta),
    )


def _safe(x):
    return torch.where(x == 0.0, 1.0, x)


def _pick4(kind, a, d, p, b):
    is_area = kind == LIGHT_AREA
    is_dir = kind == LIGHT_DIRECTIONAL
    is_point = kind == LIGHT_POINT
    if isinstance(a, V3):
        return v3_where(
            is_area, a, v3_where(is_dir, d, v3_where(is_point, p, b))
        )
    return torch.where(
        is_area, a, torch.where(is_dir, d, torch.where(is_point, p, b))
    )


def illuminate(
    lights: Lights, idx, sphere: SceneSphere, recv_pos: V3, u1, u2
) -> IlluminateResult:
    """AbstractLight::Illuminate for every lane's picked light."""
    kind, p0, e1, e2, fx, fy, fz, intensity, inv_area, _, _ = _gather(
        lights, idx
    )

    # --- Area light (lights.hxx:131-166).
    uv0, uv1 = sample_uniform_triangle(u1, u2)
    lp = p0 + e1 * uv0 + e2 * uv1
    to_l = lp - recv_pos
    dist_sqr = len_sqr(to_l).clamp_min(1e-30)
    a_dist = torch.sqrt(dist_sqr)
    a_dir = to_l * (1.0 / a_dist)
    cos_normal_dir = dot(fz, -a_dir)
    a_ok = cos_normal_dir >= EPS_COSINE
    safe_cos = _safe(torch.where(a_ok, cos_normal_dir, 0.0))
    a_direct_pdf = inv_area * dist_sqr / safe_cos
    a_emission_pdf = inv_area * cos_normal_dir * INV_PI_F
    a_radiance = v3_where(a_ok, intensity, 0.0)

    # --- Directional (lights.hxx:244-265).
    d_dir = -fz
    d_direct_pdf = torch.ones_like(inv_area)
    d_emission_pdf = concentric_disc_pdf_a() * sphere.inv_radius_sqr

    # --- Point (lights.hxx:329-352).
    p_to_l = p0 - recv_pos
    p_dist_sqr = len_sqr(p_to_l).clamp_min(1e-30)
    p_dist = torch.sqrt(p_dist_sqr)
    p_dir = p_to_l * (1.0 / p_dist)
    p_direct_pdf = p_dist_sqr
    p_emission_pdf = torch.full_like(inv_area, uniform_sphere_pdf_w())

    # --- Background (lights.hxx:410-436).
    b_dir, b_direct_pdf = sample_uniform_sphere_w(u1, u2)
    b_emission_pdf = (
        b_direct_pdf * concentric_disc_pdf_a() * sphere.inv_radius_sqr
    )

    big = torch.full_like(inv_area, 1e36)
    one = torch.ones_like(inv_area)
    d_e = torch.broadcast_to(d_emission_pdf, inv_area.shape)
    return IlluminateResult(
        radiance=_pick4(kind, a_radiance, intensity, intensity, intensity),
        dir_to_light=_pick4(kind, a_dir, d_dir, p_dir, b_dir),
        distance=_pick4(kind, a_dist, big, p_dist, big),
        direct_pdf_w=_pick4(kind, a_direct_pdf, d_direct_pdf, p_direct_pdf,
                            b_direct_pdf),
        emission_pdf_w=_pick4(kind, a_emission_pdf, d_e, p_emission_pdf,
                              b_emission_pdf),
        cos_at_light=_pick4(
            kind, torch.where(a_ok, cos_normal_dir, 1.0), one, one, one
        ),
    )


def emit(
    lights: Lights, idx, sphere: SceneSphere, ud1, ud2, up1, up2
) -> EmitResult:
    """AbstractLight::Emit for every lane's picked light.

    ud* = direction random pair, up* = position random pair.
    """
    kind, p0, e1, e2, fx, fy, fz, intensity, inv_area, is_finite, is_delta = (
        _gather(lights, idx)
    )

    # --- Area (lights.hxx:168-196).
    uv0, uv1 = sample_uniform_triangle(up1, up2)
    a_pos = p0 + e1 * uv0 + e2 * uv1
    local_dir, cos_pdf = sample_cos_hemisphere_w(ud1, ud2)
    a_emission_pdf = cos_pdf * inv_area
    local_z = local_dir.z.clamp_min(EPS_COSINE)
    a_dir = fx * local_dir.x + fy * local_dir.y + fz * local_z
    a_energy = intensity * local_z

    # --- Directional (lights.hxx:267-294).
    disc_x, disc_y = sample_concentric_disc(up1, up2)
    d_pos = sphere.center + (-fz + fx * disc_x + fy * disc_y) * sphere.radius
    d_dir = fz
    d_emission_pdf = concentric_disc_pdf_a() * sphere.inv_radius_sqr

    # --- Point (lights.hxx:354-375).
    p_dir, p_emission_pdf = sample_uniform_sphere_w(ud1, ud2)

    # --- Background (lights.hxx:438-478).
    b_dir, b_direct_pdf = sample_uniform_sphere_w(ud1, ud2)
    bfx, bfy, _ = frame_set_from_z(b_dir)
    b_pos = sphere.center + (-b_dir + bfx * disc_x + bfy * disc_y) * sphere.radius
    b_emission_pdf = (
        b_direct_pdf * concentric_disc_pdf_a() * sphere.inv_radius_sqr
    )

    one = torch.ones_like(inv_area)
    d_e = torch.broadcast_to(d_emission_pdf, inv_area.shape)
    return EmitResult(
        energy=_pick4(kind, a_energy, intensity, intensity, intensity),
        position=_pick4(kind, a_pos, d_pos, p0, b_pos),
        direction=_pick4(kind, a_dir, d_dir, p_dir, b_dir),
        emission_pdf_w=_pick4(kind, a_emission_pdf, d_e, p_emission_pdf,
                              b_emission_pdf),
        direct_pdf_a=_pick4(kind, inv_area, one, one, b_direct_pdf),
        cos_theta_light=_pick4(kind, local_z, one, one, one),
        is_finite=is_finite,
        is_delta=is_delta,
    )


def get_radiance(
    lights: Lights, idx, sphere: SceneSphere, ray_dir: V3
) -> RadianceResult:
    """AbstractLight::GetRadiance for lights hit by a random ray."""
    kind, _, _, _, _, _, fz, intensity, inv_area, _, _ = _gather(lights, idx)

    # --- Area (lights.hxx:198-220).
    cos_out = dot(fz, -ray_dir).clamp_min(0.0)
    a_ok = cos_out > 0.0
    a_radiance = v3_where(a_ok, intensity, 0.0)
    a_emission_pdf = cos_hemisphere_pdf_w(fz, -ray_dir) * inv_area

    # --- Background (lights.hxx:480-502).
    b_direct_pdf = uniform_sphere_pdf_w()
    b_emission_pdf = (
        b_direct_pdf * concentric_disc_pdf_a() * sphere.inv_radius_sqr
    )

    is_area = kind == LIGHT_AREA
    is_bg = kind == LIGHT_BACKGROUND
    zero = torch.zeros_like(inv_area)

    radiance = v3_where(is_area, a_radiance, v3_where(is_bg, intensity, 0.0))
    direct_pdf = torch.where(is_area, inv_area,
                             torch.where(is_bg, b_direct_pdf, zero))
    emission_pdf = torch.where(
        is_area, a_emission_pdf,
        torch.where(is_bg, torch.broadcast_to(b_emission_pdf, zero.shape),
                    zero),
    )
    return RadianceResult(
        radiance=radiance, direct_pdf_a=direct_pdf, emission_pdf_w=emission_pdf
    )
