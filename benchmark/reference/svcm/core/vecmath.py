"""Batched sampling/shading math over planar (SoA) vectors.

Port of ``smallvcm_tpu/core/vecmath.py``: the same formulas, clamps and
evaluation order, over torch tensors. Masked-off wavefront lanes evaluate
everything, so every sqrt/pow/division that could hit sqrt(0), pow(0, p)
or x/0 is clamped where the clamp cannot move real data.
"""

from __future__ import annotations

import torch

from .vec3 import V3, cross, dot, normalize

PI_F = 3.14159265358979
INV_PI_F = 1.0 / PI_F

# Epsilons, identical to the reference (utils.hxx:32-33, bsdf.hxx:59).
EPS_COSINE = 1e-6
EPS_RAY = 1e-3
EPS_PHONG = 1e-3


def sqr(x):
    return x * x


def pdf_w_to_a(pdf_w, dist, cos_there):
    """Solid-angle pdf -> area pdf (utils.hxx:245-251)."""
    return pdf_w * torch.abs(cos_there) / sqr(dist)


def pdf_a_to_w(pdf_a, dist, cos_there):
    """Area pdf -> solid-angle pdf (utils.hxx:253-259)."""
    return pdf_a * sqr(dist) / torch.abs(cos_there).clamp_min(1e-35)


# ---------------------------------------------------------------------------
# Orthonormal shading frame (frame.hxx)
# ---------------------------------------------------------------------------


def frame_set_from_z(z: V3):
    """ONB from a (possibly unnormalized) z axis (frame.hxx:53-59)."""
    nz = normalize(z)
    use_y = torch.abs(nz.x) > 0.99
    zero = torch.zeros_like(nz.x)
    one = torch.ones_like(nz.x)
    tmp_x = V3(torch.where(use_y, zero, one), torch.where(use_y, one, zero),
               zero)
    y = normalize(cross(nz, tmp_x))
    x = cross(y, nz)
    return x, y, nz


def frame_to_world(fx: V3, fy: V3, fz: V3, a: V3) -> V3:
    return fx * a.x + fy * a.y + fz * a.z


def frame_to_local(fx: V3, fy: V3, fz: V3, a: V3) -> V3:
    return V3(dot(a, fx), dot(a, fy), dot(a, fz))


# ---------------------------------------------------------------------------
# Samplers (utils.hxx:85-237) — uniforms passed as separate [...] tensors
# ---------------------------------------------------------------------------


def sample_cos_hemisphere_w(u1, u2):
    """Cosine hemisphere; returns (V3 dir, pdfW)."""
    term1 = 2.0 * PI_F * u1
    term2 = torch.sqrt((1.0 - u2).clamp_min(1e-12))
    z = torch.sqrt(u2.clamp_min(1e-12))
    d = V3(torch.cos(term1) * term2, torch.sin(term1) * term2, z)
    return d, z * INV_PI_F


def cos_hemisphere_pdf_w(normal: V3, direction: V3):
    return dot(normal, direction).clamp_min(0.0) * INV_PI_F


def sample_power_cos_hemisphere_w(u1, u2, power):
    """Power-cosine lobe around +Z (utils.hxx:85-103)."""
    term1 = 2.0 * PI_F * u1
    u = u2.clamp_min(1e-12)
    term2 = torch.pow(u, 1.0 / (power + 1.0))
    term3 = torch.sqrt((1.0 - term2 * term2).clamp_min(1e-12))
    d = V3(torch.cos(term1) * term3, torch.sin(term1) * term3, term2)
    pdf = (power + 1.0) * torch.pow(term2, power) * (0.5 * INV_PI_F)
    return d, pdf


def power_cos_hemisphere_pdf_w(normal: V3, direction: V3, power):
    cos_theta = dot(normal, direction).clamp_min(0.0)
    safe = cos_theta.clamp_min(1e-20)
    val = (power + 1.0) * torch.pow(safe, power) * (INV_PI_F * 0.5)
    return torch.where(cos_theta > 0.0, val, 0.0)


def sample_concentric_disc(u1, u2):
    """Shirley-Chiu concentric disc (utils.hxx:119-162), branch-free.
    Returns (x, y)."""
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0

    safe = lambda x: torch.where(x == 0.0, 1.0, x)
    quarter = PI_F / 4.0
    r1, phi1 = a, quarter * (b / safe(a))
    r2, phi2 = b, quarter * (2.0 - a / safe(b))
    r3, phi3 = -a, quarter * (4.0 + b / safe(a))
    r4 = -b
    phi4 = torch.where(b != 0.0, quarter * (6.0 - a / safe(b)), 0.0)

    reg12 = a > -b
    reg1 = reg12 & (a > b)
    reg2 = reg12 & ~(a > b)
    reg3 = ~reg12 & (a < b)

    r = torch.where(reg1, r1, torch.where(reg2, r2, torch.where(reg3, r3, r4)))
    phi = torch.where(
        reg1, phi1, torch.where(reg2, phi2, torch.where(reg3, phi3, phi4))
    )
    return r * torch.cos(phi), r * torch.sin(phi)


def concentric_disc_pdf_a():
    return INV_PI_F


def sample_uniform_triangle(u1, u2):
    """Barycentric sample (utils.hxx:202-207). Returns (a, b)."""
    term = torch.sqrt(u1.clamp_min(1e-12))
    return 1.0 - term, u2 * term


def sample_uniform_sphere_w(u1, u2):
    """Uniform sphere direction (utils.hxx:212-231); returns (V3, pdfSA)."""
    term1 = 2.0 * PI_F * u1
    term2 = 2.0 * torch.sqrt((u2 - u2 * u2).clamp_min(1e-12))
    d = V3(torch.cos(term1) * term2, torch.sin(term1) * term2, 1.0 - 2.0 * u2)
    return d, torch.full_like(u1, INV_PI_F * 0.25)


def uniform_sphere_pdf_w():
    return INV_PI_F * 0.25


def fresnel_dielectric(cos_inc, ior):
    """Dielectric Fresnel (utils.hxx:43-74). ior < 0 => 1 (no refraction)."""
    hit_inside = cos_inc < 0.0
    abs_cos = torch.abs(cos_inc)
    safe_ior = torch.where(ior <= 0.0, 1.5, ior)
    eta = torch.where(hit_inside, safe_ior, 1.0 / safe_ior)

    sin_trans2 = sqr(eta) * (1.0 - sqr(abs_cos))
    cos_trans = torch.sqrt((1.0 - sin_trans2).clamp_min(1e-12))

    term1 = eta * cos_trans
    r_par = (abs_cos - term1) / (abs_cos + term1).clamp_min(1e-35)
    term2 = eta * abs_cos
    r_perp = (term2 - cos_trans) / (term2 + cos_trans).clamp_min(1e-35)
    fres = 0.5 * (sqr(r_par) + sqr(r_perp))
    return torch.where(ior < 0.0, torch.ones_like(fres), fres)
