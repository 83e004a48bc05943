"""Batched four-lobe BSDF engine (diffuse + Phong + mirror + glass).

Port of ``smallvcm_tpu/ops/bsdf.py`` (the reference's ``BSDF<FixIsLight>``,
bsdf.hxx:61-576) as plain functions over component-planar tensors. One
``BsdfState`` holds, per wavefront lane, everything ``BSDF::Setup``
computed. MIS correctness depends on pdfs being computed identically
everywhere (bsdf.hxx:298-299), so the formulas and their evaluation order
follow the JAX package exactly.

The entry points :func:`setup`, :func:`evaluate` and :func:`sample` (and
the fusions :func:`setup_evaluate` and :func:`sample_with_pdf`) choose
their path by device: on a card a call is one launch of the hand-written
kernel ``csrc/bsdf.cu`` (:func:`bsdf_kernel`), bit for bit the plain
functions (``setup_plain`` and its siblings), and under autograd
(``diff.py``) its gradient is the plain functions' (:class:`_BsdfKernelFn`);
on the CPU the plain functions run. :func:`pdf` is plain everywhere.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.vec3 import V3, dot, luminance, reflect_local, take, v3_where
from ..core.vecmath import (
    EPS_COSINE,
    EPS_PHONG,
    INV_PI_F,
    fresnel_dielectric,
    frame_set_from_z,
    frame_to_local,
    frame_to_world,
    power_cos_hemisphere_pdf_w,
    sample_cos_hemisphere_w,
    sample_power_cos_hemisphere_w,
    sqr,
)
from ..scene.scene import Materials
from . import _cuda
from ._cuda import leaves as _leaves, on_card as _on_card

# Event codes (bsdf.hxx:72-82).
EV_NONE = 0
EV_DIFFUSE = 1
EV_PHONG = 2
EV_REFLECT = 4
EV_REFRACT = 8
EV_SPECULAR = EV_REFLECT | EV_REFRACT


class BsdfState(NamedTuple):
    valid: torch.Tensor       # [N] bool (materialID >= 0 in the reference)
    mat_id: torch.Tensor      # [N] int64 (clamped >= 0 for safe gathers)
    frame_x: V3               # V3 of [N]
    frame_y: V3
    frame_z: V3
    local_dir_fix: V3         # V3 of [N]
    is_delta: torch.Tensor    # [N] bool
    prob_diff: torch.Tensor   # [N]
    prob_phong: torch.Tensor  # [N]
    prob_refl: torch.Tensor   # [N]
    prob_refr: torch.Tensor   # [N]
    cont_prob: torch.Tensor   # [N]
    reflect_coeff: torch.Tensor  # [N]

    def cos_theta_fix(self):
        return self.local_dir_fix.z

    def world_dir_fix(self) -> V3:
        return frame_to_world(
            self.frame_x, self.frame_y, self.frame_z, self.local_dir_fix
        )


def _gather_material(materials: Materials, mat_id):
    safe = mat_id.long().clamp_min(0)
    return tuple(take(t, safe) for t in materials)


def setup_plain(materials: Materials, ray_dir: V3, normal: V3, mat_id,
                hit_mask) -> BsdfState:
    """BSDF::Setup (bsdf.hxx:95-117) over a wavefront."""
    fx, fy, fz = frame_set_from_z(normal)
    local_fix = frame_to_local(fx, fy, fz, -ray_dir)

    valid = hit_mask & (mat_id >= 0) & (torch.abs(local_fix.z) >= EPS_COSINE)

    diffuse, phong, _, mirror, ior = _gather_material(materials, mat_id)

    # GetComponentProbabilities (bsdf.hxx:528-566).
    reflect_coeff = fresnel_dielectric(local_fix.z, ior)
    albedo_diff = luminance(diffuse)
    albedo_phong = luminance(phong)
    albedo_refl = reflect_coeff * luminance(mirror)
    albedo_refr = (1.0 - reflect_coeff) * torch.where(ior > 0.0, 1.0, 0.0)

    total = albedo_diff + albedo_phong + albedo_refl + albedo_refr
    degenerate = total < 1e-9
    safe_total = torch.where(degenerate, 1.0, total)

    zero = torch.zeros_like(total)
    p_diff = torch.where(degenerate, zero, albedo_diff / safe_total)
    p_phong = torch.where(degenerate, zero, albedo_phong / safe_total)
    p_refl = torch.where(degenerate, zero, albedo_refl / safe_total)
    p_refr = torch.where(degenerate, zero, albedo_refr / safe_total)

    cont = (diffuse + phong + mirror * reflect_coeff).max_component() + (
        1.0 - reflect_coeff
    )
    cont = torch.where(degenerate, zero, cont.clamp(0.0, 1.0))

    # Differentiability: the component probabilities and the Russian-roulette
    # continuation probability are detached. With p0 = detach(p(theta)) the
    # estimator E_u[1{u<p0} X(theta)/p0] equals X(theta)'s integral for every
    # theta near the current one, so its gradient is unbiased; live
    # probabilities differentiate the 1/p weights without the compensating
    # decision-boundary terms (white-furnace oracle: 0.62 against a true
    # derivative of 1.0; tests/test_torch_diff.py).
    p_diff, p_phong, p_refl, p_refr = (
        p_diff.detach(), p_phong.detach(), p_refl.detach(), p_refr.detach()
    )
    cont = cont.detach()

    return BsdfState(
        valid=valid,
        mat_id=mat_id.long().clamp_min(0),
        frame_x=fx, frame_y=fy, frame_z=fz,
        local_dir_fix=local_fix,
        is_delta=(p_diff == 0.0) & (p_phong == 0.0),
        prob_diff=p_diff, prob_phong=p_phong,
        prob_refl=p_refl, prob_refr=p_refr,
        cont_prob=cont,
        reflect_coeff=reflect_coeff,
    )


def _phong_rho(phong_refl: V3, exponent) -> V3:
    return phong_refl * ((exponent + 2.0) * 0.5 * INV_PI_F)


def _eval_diffuse(state, diffuse: V3, local_gen: V3):
    """EvaluateDiffuse (bsdf.hxx:393-412): (value V3, direct_pdf, rev_pdf)."""
    ok = (
        (state.prob_diff > 0.0)
        & (state.local_dir_fix.z >= EPS_COSINE)
        & (local_gen.z >= EPS_COSINE)
    )
    value = v3_where(ok, diffuse * INV_PI_F, 0.0)
    direct = torch.where(
        ok, state.prob_diff * (local_gen.z * INV_PI_F).clamp_min(0.0), 0.0
    )
    rev = torch.where(
        ok,
        state.prob_diff * (state.local_dir_fix.z * INV_PI_F).clamp_min(0.0),
        0.0,
    )
    return value, direct, rev


def _eval_phong(state, phong_refl: V3, exponent, local_gen: V3):
    """EvaluatePhong (bsdf.hxx:414-450): (value V3, direct_pdf, rev_pdf)."""
    refl_fix = reflect_local(state.local_dir_fix)
    dot_r_wi = dot(refl_fix, local_gen)
    ok = (
        (state.prob_phong > 0.0)
        & (state.local_dir_fix.z >= EPS_COSINE)
        & (local_gen.z >= EPS_COSINE)
        & (dot_r_wi > EPS_PHONG)
    )
    pdf_w = state.prob_phong * power_cos_hemisphere_pdf_w(
        refl_fix, local_gen, exponent
    )
    rho = _phong_rho(phong_refl, exponent)
    lobe = torch.pow(dot_r_wi.clamp_min(EPS_PHONG), exponent)
    value = v3_where(ok, rho * lobe, 0.0)
    pdf_w = torch.where(ok, pdf_w, 0.0)
    return value, pdf_w, pdf_w  # phong sampling is symmetric


def _pdf_diffuse(state, local_gen: V3):
    """PdfDiffuse (bsdf.hxx:456-472) — NOTE: no EPS_COSINE gating."""
    ok = state.prob_diff > 0.0
    direct = torch.where(
        ok, state.prob_diff * (local_gen.z * INV_PI_F).clamp_min(0.0), 0.0
    )
    rev = torch.where(
        ok,
        state.prob_diff * (state.local_dir_fix.z * INV_PI_F).clamp_min(0.0),
        0.0,
    )
    return direct, rev


def _pdf_phong(state, exponent, local_gen: V3):
    """PdfPhong (bsdf.hxx:474-502)."""
    refl_fix = reflect_local(state.local_dir_fix)
    dot_r_wi = dot(refl_fix, local_gen)
    ok = (state.prob_phong > 0.0) & (dot_r_wi > EPS_PHONG)
    pdf_w = power_cos_hemisphere_pdf_w(refl_fix, local_gen, exponent) * \
        state.prob_phong
    pdf_w = torch.where(ok, pdf_w, 0.0)
    return pdf_w, pdf_w


def evaluate_plain(materials: Materials, state: BsdfState,
                   world_dir_gen: V3):
    """BSDF::Evaluate (bsdf.hxx:128-153).

    Returns (value V3, cos_theta_gen, direct_pdf_w, rev_pdf_w); zero when
    the directions are in opposite hemispheres or the state is invalid.
    """
    diffuse, phong, exponent, _, _ = _gather_material(materials, state.mat_id)
    local_gen = frame_to_local(
        state.frame_x, state.frame_y, state.frame_z, world_dir_gen
    )
    same_side = (local_gen.z * state.local_dir_fix.z >= 0.0) & state.valid
    cos_gen = torch.abs(local_gen.z)

    vd, dd, rd = _eval_diffuse(state, diffuse, local_gen)
    vp, dp, rp = _eval_phong(state, phong, exponent, local_gen)

    value = v3_where(same_side, vd + vp, 0.0)
    direct = torch.where(same_side, dd + dp, 0.0)
    rev = torch.where(same_side, rd + rp, 0.0)
    return value, cos_gen, direct, rev


def pdf(materials: Materials, state: BsdfState, world_dir_gen: V3):
    """BSDF::Pdf (bsdf.hxx:161-180): returns (direct_pdf_w, rev_pdf_w)."""
    _, _, exponent, _, _ = _gather_material(materials, state.mat_id)
    local_gen = frame_to_local(
        state.frame_x, state.frame_y, state.frame_z, world_dir_gen
    )
    same_side = (local_gen.z * state.local_dir_fix.z >= 0.0) & state.valid
    dd, rd = _pdf_diffuse(state, local_gen)
    dp, rp = _pdf_phong(state, exponent, local_gen)
    return (
        torch.where(same_side, dd + dp, 0.0),
        torch.where(same_side, rd + rp, 0.0),
    )


def sample_plain(materials: Materials, state: BsdfState, u1, u2, u3,
                 fix_is_light: bool):
    """BSDF::Sample (bsdf.hxx:191-257) over a wavefront.

    Returns (factor V3, world_dir_gen V3, pdf_w, cos_theta_gen, event int64,
    keep bool). ``keep=False`` corresponds to the reference returning a zero
    factor (sample discarded).
    """
    diffuse, phong, exponent, mirror, ior = _gather_material(
        materials, state.mat_id
    )
    thr_d = state.prob_diff
    thr_p = thr_d + state.prob_phong
    thr_r = thr_p + state.prob_refl
    event = torch.where(
        u3 < thr_d,
        EV_DIFFUSE,
        torch.where(u3 < thr_p, EV_PHONG,
                    torch.where(u3 < thr_r, EV_REFLECT, EV_REFRACT)),
    )

    local_fix = state.local_dir_fix

    # --- Diffuse candidate (SampleDiffuse + EvaluatePhong; bsdf.hxx:219-227).
    d_dir, d_unweighted_pdf = sample_cos_hemisphere_w(u1, u2)
    d_ok = local_fix.z >= EPS_COSINE
    d_pdf = d_unweighted_pdf * state.prob_diff
    d_value = diffuse * INV_PI_F
    pv, pd, _ = _eval_phong(state, phong, exponent, d_dir)
    d_value = d_value + pv
    d_pdf = d_pdf + pd

    # --- Phong candidate (SamplePhong + EvaluateDiffuse; bsdf.hxx:228-236,
    # 290-318): lobe sampled around the reflected fix direction.
    lobe_dir, _ = sample_power_cos_hemisphere_w(u1, u2, exponent)
    refl_fix = reflect_local(local_fix)
    rfx, rfy, rfz = frame_set_from_z(refl_fix)
    p_dir = frame_to_world(rfx, rfy, rfz, lobe_dir)
    dot_r_wi = dot(refl_fix, p_dir)
    p_ok = dot_r_wi > EPS_PHONG
    p_pdf_d, _ = _pdf_phong(state, exponent, p_dir)
    p_value = _phong_rho(phong, exponent) * torch.pow(
        dot_r_wi.clamp_min(EPS_PHONG), exponent
    )
    dv, dd_pdf, _ = _eval_diffuse(state, diffuse, p_dir)
    p_value = p_value + dv
    p_pdf = p_pdf_d + dd_pdf

    # --- Reflect candidate (bsdf.hxx:320-333).
    r_dir = refl_fix
    r_pdf = state.prob_refl
    r_cos = torch.abs(r_dir.z).clamp_min(1e-30)
    r_value = mirror * (state.reflect_coeff / r_cos)

    # --- Refract candidate (bsdf.hxx:335-387).
    cos_i_raw = local_fix.z
    inside = cos_i_raw < 0.0
    safe_ior = torch.where(ior <= 0.0, 1.5, ior)
    eta = torch.where(inside, safe_ior, 1.0 / safe_ior)
    cos_i = torch.abs(cos_i_raw)
    cos_t_sign = torch.where(inside, 1.0, -1.0)
    sin_t2 = sqr(eta) * (1.0 - cos_i * cos_i)
    no_tir = sin_t2 < 1.0
    cos_t = cos_t_sign * torch.sqrt((1.0 - sin_t2).clamp_min(1e-12))
    f_dir = V3(-eta * local_fix.x, -eta * local_fix.y, cos_t)
    f_pdf = state.prob_refr
    refract_coeff = 1.0 - state.reflect_coeff
    abs_cos_t = torch.abs(cos_t).clamp_min(1e-30)
    if not fix_is_light:  # camera paths carry the eta^2 factor
        f_scalar = refract_coeff * sqr(eta) / abs_cos_t
    else:
        f_scalar = refract_coeff / abs_cos_t
    f_value = V3(f_scalar, f_scalar, f_scalar)
    f_ok = (ior >= 0.0) & no_tir

    # --- Select by event.
    is_d = event == EV_DIFFUSE
    is_p = event == EV_PHONG
    is_r = event == EV_REFLECT

    def pick(d, p, r, f):
        if isinstance(d, V3):
            return v3_where(is_d, d, v3_where(is_p, p, v3_where(is_r, r, f)))
        return torch.where(is_d, d, torch.where(is_p, p, torch.where(is_r, r, f)))

    local_gen = pick(d_dir, p_dir, r_dir, f_dir)
    pdf_w = pick(d_pdf, p_pdf, r_pdf, f_pdf)
    value = pick(d_value, p_value, r_value, f_value)
    ok = pick(d_ok, p_ok, torch.ones_like(d_ok), f_ok)

    cos_gen = torch.abs(local_gen.z)
    keep = ok & (cos_gen >= EPS_COSINE) & state.valid

    world_dir = frame_to_world(
        state.frame_x, state.frame_y, state.frame_z, local_gen
    )
    return value, world_dir, pdf_w, cos_gen, event, keep


# ---------------------------------------------------------------------------
# Dispatch, and the kernel (csrc/bsdf.cu)
# ---------------------------------------------------------------------------

# Operation codes of csrc/bsdf.cu, and the dtypes of each one's outputs.
_F, _B, _L = torch.float32, torch.bool, torch.int64
_OPS = {"setup": 0, "evaluate": 1, "sample": 2, "setup_evaluate": 3}
_OUTS = {
    "setup": (_B, _L, *(_F,) * 12, _B, *(_F,) * 6),  # BsdfState's planes
    "evaluate": (_F,) * 6,
    "sample": (*(_F,) * 8, _L, _B, _F),  # sample's, then pdf's rev_pdf_w
    "setup_evaluate": (_F,) * 7,
}
# Float outputs the plain chains detach: setup's component and
# continuation probabilities, and setup_evaluate's cont_prob.
_DETACHED = {"setup": range(15, 20), "setup_evaluate": (6,)}
_SETUP_OPS = ("setup", "setup_evaluate")
MAX_MATERIALS = 1024  # csrc/bsdf.cu's kMaxMaterials: the table's rows


def _state_of(planes) -> BsdfState:
    p = list(planes)
    return BsdfState(p[0], p[1], V3(*p[2:5]), V3(*p[5:8]), V3(*p[8:11]),
                     V3(*p[11:14]), *p[14:])


def _materials_of(planes) -> Materials:
    p = list(planes)
    return Materials(V3(*p[0:3]), V3(*p[3:6]), p[6], V3(*p[7:10]), p[10])


def _plain(op: str, materials: Materials, planes, fix_is_light=False):
    """The plain chain of ``op`` over :func:`bsdf_kernel`'s operand planes
    -> its output planes, in ``_OUTS[op]``'s order."""
    p = list(planes)
    if op in _SETUP_OPS:
        b = setup_plain(materials, V3(*p[0:3]), V3(*p[3:6]), p[6], p[7])
        if op == "setup":
            return tuple(_leaves(b))
        return (*_leaves(evaluate_plain(materials, b, V3(*p[8:11]))),
                b.cont_prob)
    state = _state_of(p[:21])
    if op == "evaluate":
        return tuple(_leaves(evaluate_plain(materials, state,
                                            V3(*p[21:24]))))
    s = sample_plain(materials, state, *p[21:24], fix_is_light)
    return (*_leaves(s), pdf(materials, state, s[1])[1])


def bsdf_kernel(op: str, materials: Materials, planes, fix_is_light=False):
    """Launch ``csrc/bsdf.cu``'s ``op`` over ``planes`` -> its output
    planes (``_OUTS[op]``'s dtypes, the operands' broadcast shape).

    ``planes``: setup's ray_dir, normal (3 each), mat_id, hit_mask
    (setup_evaluate's then a world direction); or a BsdfState's 21 planes
    in field order, then evaluate's world direction (3) or sample's u1,
    u2, u3. Operands broadcast to one shape of at most two dimensions and
    are read through their strides: an expanded [w, N] state is read from
    its [N] base."""
    req = _cuda.require
    name = f"bsdf_kernel({op!r})"
    req(op in _OPS, f"bsdf_kernel: unknown op {op!r}")
    planes = list(planes)
    req(len(planes) == {"setup": 8, "setup_evaluate": 11}.get(op, 24),
        f"{name}: {len(planes)} operand planes")
    req(all(isinstance(t, torch.Tensor) for t in planes),
        f"{name}: operands are tensors")
    mat_at, bool_at = (6, (7,)) if op in _SETUP_OPS else (1, (0, 14))
    for k, t in enumerate(planes):
        want = ((torch.int32, torch.int64) if k == mat_at
                else (torch.bool,) if k in bool_at else (torch.float32,))
        req(t.dtype in want, f"{name}: operand {k} is {t.dtype}, not "
            + " or ".join(map(str, want)))
    mats = list(_leaves(materials))
    m = mats[0].shape[0] if mats and mats[0].dim() == 1 else 0
    req(len(mats) == 11 and all(
        isinstance(t, torch.Tensor) and t.dtype == torch.float32
        and t.shape == (m,) for t in mats) and 1 <= m <= MAX_MATERIALS,
        f"{name}: materials are 11 float32 planes of 1 to "
        f"{MAX_MATERIALS} rows")
    shape, rows, n, ins = _cuda.lane_grid(name, planes)
    dev = planes[0].device
    req(dev.type == "cuda"
        and all(t.device == dev for t in planes + mats),
        f"{name}: every operand on one CUDA device")
    outs = [torch.empty(shape, dtype=d, device=dev) for d in _OUTS[op]]
    if rows * n == 0:
        return outs
    lib = _cuda.load_library()
    status = lib.svcm_bsdf(
        _OPS[op], ins, len(planes),
        (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs)),
        len(outs), (ctypes.c_longlong * 22)(
            *(v for t in mats for v in (t.data_ptr(), t.stride(0)))),
        m, rows, n, int(planes[mat_at].dtype == torch.int64),
        int(bool(fix_is_light)), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(status, "svcm_bsdf")
    bsdf_kernel.launches += 1
    return outs


# Kernel launches on the device: graphs.py takes a capture's increment back
# and adds it at every replay (counter ``bsdf.launches``).
bsdf_kernel.launches = 0


class _BsdfKernelFn(torch.autograd.Function):
    """The kernel with a gradient: forward launches :func:`bsdf_kernel`;
    backward runs the op's plain chain (:func:`_plain`) again on the saved
    operands and differentiates it, so the gradient is the plain path's.
    The outputs the plain chains detach, and the bool and int64 ones, get
    none."""

    @staticmethod
    def forward(ctx, op, fix_is_light, *tensors):
        outs = bsdf_kernel(op, _materials_of(tensors[:11]), tensors[11:],
                           fix_is_light)
        ctx.op, ctx.fix_is_light = op, fix_is_light
        ctx.save_for_backward(*tensors)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(
            o for k, o in enumerate(outs)
            if o.dtype != torch.float32 or k in _DETACHED.get(op, ())))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_outs):
        return (None, None, *_cuda.plain_backward(
            ctx.saved_tensors, ctx.needs_input_grad[2:],
            lambda ins: _plain(ctx.op, _materials_of(ins[:11]), ins[11:],
                               ctx.fix_is_light), g_outs))


def _run(op: str, materials: Materials, planes, fix_is_light=False):
    """``op``'s output planes: the plain chain on the CPU, the kernel on a
    card (through :class:`_BsdfKernelFn` when an operand needs a
    gradient)."""
    planes = list(planes)
    if not _on_card(materials, planes):
        return _plain(op, materials, planes, fix_is_light)
    flat = [*_leaves(materials), *planes]
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        return _BsdfKernelFn.apply(op, fix_is_light, *flat)
    return bsdf_kernel(op, materials, planes, fix_is_light)


def setup(materials: Materials, ray_dir: V3, normal: V3, mat_id,
          hit_mask) -> BsdfState:
    """BSDF::Setup (bsdf.hxx:95-117) over a wavefront: the kernel on a
    card, else :func:`setup_plain`."""
    return _state_of(_run("setup", materials,
                          (*ray_dir, *normal, mat_id, hit_mask)))


def evaluate(materials: Materials, state: BsdfState, world_dir_gen: V3):
    """BSDF::Evaluate (bsdf.hxx:128-153) -> (value V3, cos_theta_gen,
    direct_pdf_w, rev_pdf_w): the kernel on a card, else
    :func:`evaluate_plain`."""
    o = _run("evaluate", materials, (*_leaves(state), *world_dir_gen))
    return V3(*o[:3]), o[3], o[4], o[5]


def sample_with_pdf(materials: Materials, state: BsdfState, u1, u2, u3,
                    fix_is_light: bool):
    """:func:`sample`, and :func:`pdf`'s rev_pdf_w of the sampled world
    direction -> sample's six outputs and that pdf: one launch on a
    card."""
    o = _run("sample", materials, (*_leaves(state), u1, u2, u3),
             fix_is_light)
    return V3(*o[:3]), V3(*o[3:6]), o[6], o[7], o[8], o[9], o[10]


def sample(materials: Materials, state: BsdfState, u1, u2, u3,
           fix_is_light: bool):
    """BSDF::Sample (bsdf.hxx:191-257) -> (factor V3, world_dir_gen V3,
    pdf_w, cos_theta_gen, event int64, keep bool): the kernel on a card
    (:func:`sample_with_pdf`'s launch, its last plane left unread), else
    :func:`sample_plain`."""
    if not _on_card(materials, state, u1, u2, u3):
        return sample_plain(materials, state, u1, u2, u3, fix_is_light)
    return sample_with_pdf(materials, state, u1, u2, u3, fix_is_light)[:6]


def setup_evaluate(materials: Materials, ray_dir: V3, normal: V3, mat_id,
                   hit_mask, world_dir_gen: V3):
    """:func:`setup` then :func:`evaluate` of its state -> (value V3,
    cos_theta_gen, direct_pdf_w, rev_pdf_w, the state's cont_prob): one
    launch on a card, the state kept in registers."""
    o = _run("setup_evaluate", materials,
             (*ray_dir, *normal, mat_id, hit_mask, *world_dir_gen))
    return V3(*o[:3]), o[3], o[4], o[5], o[6]
