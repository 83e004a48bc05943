"""Batched light sampling/evaluation for the four light types (SoA vectors).

Port of ``smallvcm_tpu/ops/lights.py``: every lane gathers its picked
light's unified parameter record, all four type formulas are computed and
the result is selected by the type code (lights.hxx:112-514, including the
background light's "pdf lies in area measure" convention, :469-471).

The entry points :func:`illuminate`, :func:`emit` and :func:`get_radiance`
choose their path by device: on a card a call is one launch of the
hand-written kernel ``csrc/lights.cu`` (:func:`lights_kernel`), bit for
bit the plain functions (``illuminate_plain`` and its siblings), and under
autograd (``diff.py``) its gradient is the plain functions'
(:class:`_LightsKernelFn`); on the CPU the plain functions run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.vec3 import V3, dot, len_sqr, take, v3_where
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
from . import _cuda
from ._cuda import leaves as _leaves, on_card as _on_card


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
    g = lambda a: take(a, safe)
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


def illuminate_plain(
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


def emit_plain(
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


def get_radiance_plain(
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


# ---------------------------------------------------------------------------
# Dispatch, and the kernel (csrc/lights.cu)
# ---------------------------------------------------------------------------

# Operation codes of csrc/lights.cu, each one's operand planes (the light
# id first), and the dtypes of its outputs (its result's fields in order).
_F, _B = torch.float32, torch.bool
_OPS = {"illuminate": 0, "emit": 1, "get_radiance": 2}
_N_IN = {"illuminate": 6, "emit": 5, "get_radiance": 4}
_OUTS = {
    "illuminate": (_F,) * 10,
    "emit": (*(_F,) * 12, _B, _B),
    "get_radiance": (_F,) * 5,
}
MAX_LIGHTS = 256  # csrc/lights.cu's kMaxLights: the table's rows
_N_TABLE = 25  # Lights' planes: kind, 7 V3 fields, inv_area, 2 flags


def _table_dtype(k: int):
    return (torch.int32 if k == 0 else torch.bool if k >= 23
            else torch.float32)


def _plain(op: str, lights: Lights, sphere: SceneSphere, planes):
    """The plain chain of ``op`` over :func:`lights_kernel`'s operand
    planes -> its output planes, in ``_OUTS[op]``'s order."""
    p = list(planes)
    if op == "illuminate":
        r = illuminate_plain(lights, p[0], sphere, V3(*p[1:4]), p[4], p[5])
    elif op == "emit":
        r = emit_plain(lights, p[0], sphere, *p[1:5])
    else:
        r = get_radiance_plain(lights, p[0], sphere, V3(*p[1:4]))
    return tuple(_leaves(r))


def _lights_of(planes) -> Lights:
    p = list(planes)
    return Lights(p[0], *(V3(*p[k:k + 3]) for k in range(1, 22, 3)),
                  *p[22:25])


def _operands_of(flat):
    """:func:`_run`'s flat operand list -> (lights, sphere, planes)."""
    f, t = list(flat), _N_TABLE
    return (_lights_of(f[:t]),
            SceneSphere(V3(*f[t:t + 3]), f[t + 3], f[t + 4]), f[t + 5:])


def lights_kernel(op: str, lights: Lights, sphere: SceneSphere, planes):
    """Launch ``csrc/lights.cu``'s ``op`` over ``planes`` -> its output
    planes (``_OUTS[op]``'s dtypes, the operands' broadcast shape).

    ``planes``: the int64 light id, then illuminate's receiving
    position (3), u1, u2; emit's ud1, ud2, up1, up2; or get_radiance's ray
    direction (3). Operands broadcast to one shape of at most two
    dimensions and are read through their strides: a column of an
    ``[N, slots]`` draw is read in place."""
    req = _cuda.require
    name = f"lights_kernel({op!r})"
    req(op in _OPS, f"lights_kernel: unknown op {op!r}")
    planes = list(planes)
    req(len(planes) == _N_IN[op], f"{name}: {len(planes)} operand planes")
    req(all(isinstance(t, torch.Tensor) for t in planes),
        f"{name}: operands are tensors")
    for k, t in enumerate(planes):
        want = torch.int64 if k == 0 else torch.float32
        req(t.dtype == want, f"{name}: operand {k} is {t.dtype}, not "
            f"{want}")
    table = list(_leaves(lights))
    l = table[0].shape[0] if table and isinstance(
        table[0], torch.Tensor) and table[0].dim() == 1 else 0
    req(len(table) == _N_TABLE and all(
        isinstance(t, torch.Tensor) and t.dtype == _table_dtype(k)
        and t.shape == (l,) for k, t in enumerate(table))
        and 1 <= l <= MAX_LIGHTS,
        f"{name}: lights are {_N_TABLE} planes (kind int32, is_finite and "
        f"is_delta bool, the rest float32) of 1 to {MAX_LIGHTS} rows")
    scalars = list(_leaves(sphere))
    req(len(scalars) == 5 and all(
        isinstance(t, torch.Tensor) and t.dtype == torch.float32
        and t.numel() == 1 for t in scalars),
        f"{name}: the scene sphere is 5 float32 scalars")
    shape, rows, n, ins = _cuda.lane_grid(name, planes)
    dev = planes[0].device
    req(dev.type == "cuda"
        and all(t.device == dev for t in planes + table + scalars),
        f"{name}: every operand on one CUDA device")
    outs = [torch.empty(shape, dtype=d, device=dev) for d in _OUTS[op]]
    if rows * n == 0:
        return outs
    lib = _cuda.load_library()
    status = lib.svcm_lights(
        _OPS[op], ins, len(planes),
        (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs)),
        len(outs), (ctypes.c_longlong * (2 * _N_TABLE))(
            *(v for t in table for v in (t.data_ptr(), t.stride(0)))),
        l, (ctypes.c_longlong * 5)(*(t.data_ptr() for t in scalars)),
        rows, n, torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "svcm_lights")
    lights_kernel.launches += 1
    return outs


# Kernel launches on the device: graphs.py takes a capture's increment back
# and adds it at every replay (counter ``lights.launches``).
lights_kernel.launches = 0


class _LightsKernelFn(torch.autograd.Function):
    """The kernel with a gradient: forward launches :func:`lights_kernel`;
    backward runs the op's plain chain (:func:`_plain`) again on the saved
    operands and differentiates it, so the gradient is the plain path's.
    The bool outputs (emit's is_finite and is_delta) get none."""

    @staticmethod
    def forward(ctx, op, *tensors):
        outs = lights_kernel(op, *_operands_of(tensors))
        ctx.op = op
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(
            *(o for o in outs if o.dtype != torch.float32))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_outs):
        return (None, *_cuda.plain_backward(
            ctx.saved_tensors, ctx.needs_input_grad[1:],
            lambda ins: _plain(ctx.op, *_operands_of(ins)), g_outs))


def _run(op: str, lights: Lights, sphere: SceneSphere, planes):
    """``op``'s output planes: the plain chain on the CPU, the kernel on a
    card (through :class:`_LightsKernelFn` when an operand needs a
    gradient)."""
    planes = list(planes)
    if not _on_card(lights, sphere, planes):
        return _plain(op, lights, sphere, planes)
    flat = [*_leaves(lights), *_leaves(sphere), *planes]
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        return _LightsKernelFn.apply(op, *flat)
    return lights_kernel(op, lights, sphere, planes)


def illuminate(
    lights: Lights, idx, sphere: SceneSphere, recv_pos: V3, u1, u2
) -> IlluminateResult:
    """AbstractLight::Illuminate for every lane's picked light: the kernel
    on a card, else :func:`illuminate_plain`."""
    o = _run("illuminate", lights, sphere, (idx, *recv_pos, u1, u2))
    return IlluminateResult(V3(*o[0:3]), V3(*o[3:6]), *o[6:])


def emit(
    lights: Lights, idx, sphere: SceneSphere, ud1, ud2, up1, up2
) -> EmitResult:
    """AbstractLight::Emit for every lane's picked light (ud* the direction
    pair, up* the position pair): the kernel on a card, else
    :func:`emit_plain`."""
    o = _run("emit", lights, sphere, (idx, ud1, ud2, up1, up2))
    return EmitResult(V3(*o[0:3]), V3(*o[3:6]), V3(*o[6:9]), *o[9:])


def get_radiance(
    lights: Lights, idx, sphere: SceneSphere, ray_dir: V3
) -> RadianceResult:
    """AbstractLight::GetRadiance for lights hit by a random ray: the
    kernel on a card, else :func:`get_radiance_plain`."""
    o = _run("get_radiance", lights, sphere, (idx, *ray_dir))
    return RadianceResult(V3(*o[0:3]), *o[3:])
