"""Which path a BSDF call takes, on the CPU.

``ops/bsdf.py``'s entry points launch the kernel (``csrc/bsdf.cu``)
whenever an operand is a CUDA tensor, through an autograd function whose
backward differentiates the plain chain when an operand needs a
gradient. These tests hold that CPU operands keep the plain functions,
with their outputs and gradients; that the autograd function, with the
kernel stood in for by the plain chain, gives the plain path's values,
gradients and detached outputs; that the kernel's wrapper refuses bad
operands before it loads anything; and that the launches reach the
trace's counters. The kernel's bits are held on a card, in
tests/test_torch_cuda.py. The file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu_torch import graphs, trace
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import _cuda
from smallvcm_tpu_torch.ops import bsdf as B
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

torch.set_num_threads(2)

N = 2000


def _no_library():
    raise AssertionError("the kernels' library was loaded")


@pytest.fixture(autouse=True)
def no_library(monkeypatch):
    monkeypatch.setattr(_cuda, "load_library", _no_library)


def _lanes(seed, n=N):
    """Scene 0's materials and n lanes: directions, normals, material ids
    (-1 among them), hits, a second direction and [n, 4] uniforms."""
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device="cpu")
    m = scene.materials.ior.shape[0]
    r = np.random.default_rng(seed)

    def dirs():
        d = r.normal(size=(3, n)).astype(np.float32)
        return V3(*torch.from_numpy(d / np.linalg.norm(d, axis=0)))

    mat = torch.from_numpy(r.integers(-1, m, n))
    hit = torch.from_numpy(r.random(n) < 0.85)
    u = torch.from_numpy(r.random((n, 4), dtype=np.float32))
    return scene.materials, dirs(), dirs(), mat, hit, dirs(), u


def _equal(got, want):
    got, want = list(B._leaves(got)), list(B._leaves(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) or torch.equal(
            torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0))


def _calls(mats, ray, nrm, mat, hit, gen, u, state=None):
    """Each entry point's call and its plain function's, on one state."""
    if state is None:
        state = B.setup_plain(mats, ray, nrm, mat, hit)
    us = (u[..., 0], u[..., 1], u[..., 2])
    return {
        "setup": (lambda: B.setup(mats, ray, nrm, mat, hit),
                  lambda: B.setup_plain(mats, ray, nrm, mat, hit)),
        "evaluate": (lambda: B.evaluate(mats, state, gen),
                     lambda: B.evaluate_plain(mats, state, gen)),
        "sample": (lambda: B.sample(mats, state, *us, fix_is_light=False),
                   lambda: B.sample_plain(mats, state, *us, False)),
        "sample_with_pdf": (
            lambda: B.sample_with_pdf(mats, state, *us, fix_is_light=True),
            lambda: (*(s := B.sample_plain(mats, state, *us, True)),
                     B.pdf(mats, state, s[1])[1])),
        "setup_evaluate": (
            lambda: B.setup_evaluate(mats, ray, nrm, mat, hit, gen),
            lambda: (*B.evaluate_plain(
                mats, b := B.setup_plain(mats, ray, nrm, mat, hit), gen),
                b.cont_prob)),
    }


ENTRIES = ["setup", "evaluate", "sample", "sample_with_pdf",
           "setup_evaluate"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_cpu_operands_take_the_plain_path(entry):
    call, plain = _calls(*_lanes(1))[entry]
    launches = B.bsdf_kernel.launches
    _equal(call(), plain())
    assert B.bsdf_kernel.launches == launches


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it is on a card: the dispatch rule's view of
    a CUDA operand, without one."""

    @property
    def is_cuda(self):
        return True


def test_the_rule_takes_the_kernel_for_any_cuda_operand():
    c = torch.ones(3)
    t = c.as_subclass(_CudaLooking)
    g = torch.ones(3).requires_grad_()
    assert B._on_card(c, (c, t))
    assert B._on_card(t, 1.0)  # the kernel then refuses the float
    assert not B._on_card(c, (c, c), 1.0)
    with torch.enable_grad():  # a gradient does not change the device's
        assert B._on_card(t, (g, c))
        assert not B._on_card(c, (g, c))


@pytest.mark.parametrize("entry", ENTRIES)
def test_cpu_operands_needing_grad_take_the_plain_path(entry):
    """CPU operands with materials that require grad, under grad mode: the
    plain path, its values, a gradient reaching the materials, and no
    launch."""
    mats, ray, nrm, mat, hit, gen, u = _lanes(2)
    want = _calls(mats, ray, nrm, mat, hit, gen, u)[entry][1]()
    leaf = mats.diffuse.x.clone().requires_grad_()
    mats = mats._replace(diffuse=mats.diffuse._replace(x=leaf))
    launches = B.bsdf_kernel.launches
    with torch.enable_grad():
        got = _calls(mats, ray, nrm, mat, hit, gen, u)[entry][0]()
        _equal(got, want)
        value = got[0] if entry != "setup" else got.prob_diff
        total = value.x.sum() if isinstance(value, V3) else value.sum()
        if total.requires_grad:
            total.backward()
    assert B.bsdf_kernel.launches == launches
    if entry != "setup":  # setup detaches its probabilities
        assert leaf.grad is not None and bool(leaf.grad.abs().sum() > 0)


@pytest.fixture
def plain_kernel(monkeypatch):
    """Every operand taken for a card's, and the kernel stood in for by
    the plain chain (its outputs fresh and detached), launches counted."""

    def kernel(op, materials, planes, fix_is_light=False):
        kernel.launches += 1
        with torch.no_grad():
            return [o.clone() for o in
                    B._plain(op, materials, planes, fix_is_light)]

    kernel.launches = 0
    monkeypatch.setattr(B, "_on_card", lambda *operands: True)
    monkeypatch.setattr(B, "bsdf_kernel", kernel)
    return kernel


def _grad_lanes(seed, expanded):
    """_lanes with the diffuse and IOR planes of the materials, the ray
    and normal x and the second direction's y needing gradients; an
    expanded state ([3, N] read from an [N] setup, as connect_vertices
    forms it) when ``expanded``."""
    mats, ray, nrm, mat, hit, gen, u = _lanes(seed, 400)
    leaves = [mats.diffuse.y.clone(), mats.ior.clone(), ray.x.clone(),
              nrm.x.clone(), gen.y.clone()]
    for t in leaves:
        t.requires_grad_()
    mats = mats._replace(diffuse=mats.diffuse._replace(y=leaves[0]),
                         ior=leaves[1])
    ray, nrm = ray._replace(x=leaves[2]), nrm._replace(x=leaves[3])
    gen = gen._replace(y=leaves[4])
    state = None
    if expanded:
        bro = lambda a: a.unsqueeze(0).expand(3, a.shape[0])
        state = B.BsdfState(*(
            V3(*map(bro, f)) if isinstance(f, V3) else bro(f)
            for f in B.setup_plain(mats, ray, nrm, mat, hit)))
        gen = V3(*map(bro, gen))
        u = bro(u[:, 0]).unsqueeze(-1).expand(3, 400, 4)
    return (mats, ray, nrm, mat, hit, gen, u), state, leaves


@pytest.mark.parametrize("entry,expanded", [
    *((e, False) for e in ENTRIES),
    *((e, True) for e in ("evaluate", "sample", "sample_with_pdf"))])
def test_the_kernel_under_grad_has_the_plain_gradient(plain_kernel, entry,
                                                      expanded):
    """Operands on a card that need a gradient: one launch, the plain
    path's values, the plain path's gradients to every leaf (materials,
    rays, normals, directions; through an expanded state as well), and
    the outputs the plain path detaches detached."""
    ops, state, leaves = _grad_lanes(6, expanded)
    call, plain = _calls(*ops, state=state)[entry]

    def run(fn):
        with torch.enable_grad():
            outs = list(B._leaves(fn()))
            total = sum(o.float().sum() * (k + 1) for k, o in
                        enumerate(outs) if o.requires_grad)
            grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                        retain_graph=True)
        return outs, grads

    got, got_grads = run(call)
    assert plain_kernel.launches == 1
    want, want_grads = run(plain)
    _equal(tuple(got), tuple(want))
    assert [o.requires_grad for o in got] == [o.requires_grad for o in want]
    # A leaf the plain graph never reaches gets None there and zeros
    # through the autograd function (it reaches every operand).
    zero = lambda g, t: torch.zeros_like(t) if g is None else g
    for g, w, t in zip(got_grads, want_grads, leaves):
        _equal(zero(g, t), zero(w, t))
    assert any(w is not None for w in want_grads)


def test_no_grad_takes_the_kernel_outside_autograd(plain_kernel):
    """Under no_grad an operand that requires grad does not bring in the
    autograd function: the kernel's outputs come back as they are."""
    ops, _, leaves = _grad_lanes(7, False)
    with torch.no_grad():
        b = B.setup(*ops[:5])
    assert plain_kernel.launches == 1
    assert not any(t.requires_grad for t in B._leaves(b))


def test_a_broadcast_state_equals_the_materialised_one_on_the_plain_path():
    """[w, N] as connect_vertices forms it: the camera state expanded
    along the window gives evaluate, pdf and sample the outputs of the
    same state cloned to [w, N], with no launch."""
    w, n = 3, 500
    mats, ray, nrm, mat, hit, _, _ = _lanes(3, n)
    base = B.setup(mats, ray, nrm, mat, hit)
    bro = lambda a: a.unsqueeze(0).expand(w, n)
    wide = lambda f: V3(*map(bro, f)) if isinstance(f, V3) else bro(f)
    expanded = B.BsdfState(*map(wide, base))
    solid = B.BsdfState(*(V3(*(c.clone() for c in f))
                          if isinstance(f, V3) else f.clone()
                          for f in expanded))
    assert expanded.prob_diff.stride() == (0, 1)
    _, _, _, _, _, gen, u = _lanes(4, w * n)
    gen = V3(*(c.view(w, n) for c in gen))
    us = [c.reshape(w, n) for c in (u[:, 0], u[:, 1], u[:, 2])]
    launches = B.bsdf_kernel.launches
    for a, b in ((B.evaluate(mats, expanded, gen),
                  B.evaluate(mats, solid, gen)),
                 (B.pdf(mats, expanded, gen), B.pdf(mats, solid, gen)),
                 (B.sample_with_pdf(mats, expanded, *us, fix_is_light=False),
                  B.sample_with_pdf(mats, solid, *us, fix_is_light=False)),
                 (B.sample(mats, expanded, *us, fix_is_light=True),
                  B.sample(mats, solid, *us, fix_is_light=True))):
        _equal(a, b)
    assert B.bsdf_kernel.launches == launches


def _setup_planes(seed=5, n=64):
    mats, ray, nrm, mat, hit, _, _ = _lanes(seed, n)
    return mats, [*ray, *nrm, mat, hit]


@pytest.mark.parametrize("case,match", [
    ("unknown_op", "unknown op"),
    ("too_few_planes", "operand planes"),
    ("float_mat_id", "operand 6"),
    ("float_mask", "operand 7"),
    ("double_plane", "operand 0"),
    ("short_materials", "materials"),
    ("three_dims", "3 dimensions"),
    ("cpu", "CUDA device"),
])
def test_kernel_wrapper_refuses_before_loading_anything(case, match):
    mats, planes = _setup_planes()
    op = "setup"
    if case == "unknown_op":
        op = "shade"
    elif case == "too_few_planes":
        planes = planes[:7]
    elif case == "float_mat_id":
        planes[6] = planes[6].float()
    elif case == "float_mask":
        planes[7] = planes[7].float()
    elif case == "double_plane":
        planes[0] = planes[0].double()
    elif case == "short_materials":
        mats = mats._replace(ior=mats.ior[:3])
    elif case == "three_dims":
        planes[7] = planes[7].view(1, 1, -1)
    launches = B.bsdf_kernel.launches
    with pytest.raises(ValueError, match=match):
        B.bsdf_kernel(op, mats, planes)
    assert B.bsdf_kernel.launches == launches


def test_bsdf_launches_reach_the_trace_summary(monkeypatch):
    monkeypatch.setattr(B.bsdf_kernel, "launches", 17)
    counters = trace.summary()["counters"]
    assert counters["bsdf.launches"] == 17
    assert ("bsdf.launches", B.bsdf_kernel, "launches") in graphs._counters()
