"""Which path a light call takes, on the CPU.

``ops/lights.py``'s entry points launch the kernel (``csrc/lights.cu``)
whenever an operand is a CUDA tensor, through an autograd function whose
backward differentiates the plain chain when an operand needs a
gradient. These tests hold that CPU operands keep the plain functions on
all four light kinds (scene 0's directional light, scene 1's area
lights, scene 2's point light, scene 3's background); that the autograd
function, with the kernel stood in for by the plain chain, gives the
plain path's values, gradients and detached outputs; that the kernel's
wrapper refuses bad operands before it loads anything; and that the
launches reach the trace's counters. The kernel's bits are held on a
card, in tests/test_torch_cuda.py. The file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu_torch import graphs, trace
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import _cuda
from smallvcm_tpu_torch.ops import lights as L
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

torch.set_num_threads(2)

N = 2000
OPS = ["illuminate", "emit", "get_radiance"]
SCENES = [0, 1, 2, 3]


def _no_library():
    raise AssertionError("the kernels' library was loaded")


@pytest.fixture(autouse=True)
def no_library(monkeypatch):
    monkeypatch.setattr(_cuda, "load_library", _no_library)


def _lanes(scene_id, seed, n=N, special=True):
    """Scene ``scene_id``'s lights and sphere and n lanes: light ids (-1
    among them), receiving positions, ray directions and an [n, 5] draw
    whose columns are the uniforms. ``special`` puts NaN, infinite and
    zero positions and directions, and uniforms of 0 and the largest
    float below 1, in the first lanes."""
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[scene_id], device="cpu")
    l = scene.lights.kind.shape[0]
    r = np.random.default_rng(seed)
    pos = (r.random((3, n)) * 3.0 - 1.5).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    u = r.random((n, 5), dtype=np.float32)
    if special:
        bad = np.array([[np.nan, 0, 0], [np.inf, 1, 0], [0, 0, 0],
                        [1e-30, 0, 0]], np.float32).T
        pos[:, :4] = bad
        d[:, :4] = bad
        below_one = np.nextafter(np.float32(1), np.float32(0))
        u[:4] = np.array([[0] * 5, [below_one] * 5, [0.5, 0, 1, 0.25, 0.75],
                          [1e-30, 1 - 1e-7, 0.5, 0, 0.5]])
    idx = torch.from_numpy(r.integers(-1, l, n))
    v3 = lambda a: V3(*torch.from_numpy(np.ascontiguousarray(a)))
    return scene.lights, scene.scene_sphere, idx, v3(pos), v3(d), \
        torch.from_numpy(u)


def _calls(lights, sphere, idx, pos, d, u):
    """Each entry point's call and its plain function's, the uniforms
    read as columns of the draw as the walks pass them."""
    ill = (idx, sphere, pos, u[:, 1], u[:, 2])
    em = (idx, sphere, u[:, 1], u[:, 2], u[:, 3], u[:, 4])
    rad = (idx, sphere, d)
    return {
        "illuminate": (lambda: L.illuminate(lights, *ill),
                       lambda: L.illuminate_plain(lights, *ill)),
        "emit": (lambda: L.emit(lights, *em),
                 lambda: L.emit_plain(lights, *em)),
        "get_radiance": (lambda: L.get_radiance(lights, *rad),
                         lambda: L.get_radiance_plain(lights, *rad)),
    }


def _equal(got, want):
    got, want = list(L._leaves(got)), list(L._leaves(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w) or torch.equal(
            torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0))


@pytest.mark.parametrize("scene_id", SCENES)
@pytest.mark.parametrize("op", OPS)
def test_cpu_operands_take_the_plain_path(op, scene_id):
    call, plain = _calls(*_lanes(scene_id, 1))[op]
    launches = L.lights_kernel.launches
    got, want = call(), plain()
    assert type(got) is type(want)
    _equal(got, want)
    assert L.lights_kernel.launches == launches


@pytest.mark.parametrize("scene_id", SCENES)
def test_the_lanes_cover_each_kind_and_mask(scene_id):
    """The plain path over the lanes: every light of the scene is picked,
    -1 lanes read light 0's values, and the kind's result is not
    trivially zero."""
    lights, sphere, idx, pos, d, u = _lanes(scene_id, 2)
    l = lights.kind.shape[0]
    assert set(idx.tolist()) == set(range(-1, l))
    ill = L.illuminate_plain(lights, idx, sphere, pos, u[:, 1], u[:, 2])
    zero = torch.zeros_like(idx)
    as_zero = L.illuminate_plain(lights, torch.where(idx < 0, zero, idx),
                                 sphere, pos, u[:, 1], u[:, 2])
    _equal(ill, as_zero)
    assert bool((ill.radiance.x[4:] > 0).any())
    rad = L.get_radiance_plain(lights, idx, sphere, d)
    kind = int(lights.kind[0])
    assert bool((rad.radiance.x > 0).any()) == (kind in (0, 3))


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it is on a card: the dispatch rule's view of
    a CUDA operand, without one."""

    @property
    def is_cuda(self):
        return True


def test_the_rule_takes_the_kernel_for_any_cuda_operand():
    lights, sphere, idx, pos, d, u = _lanes(0, 3, 16)
    t = idx.as_subclass(_CudaLooking)
    assert not L._on_card(lights, sphere, [idx, *d])
    assert L._on_card(lights, sphere, [t, *d])
    assert L._on_card(lights._replace(
        inv_area=lights.inv_area.as_subclass(_CudaLooking)), sphere, [idx])
    assert L._on_card(sphere._replace(
        radius=sphere.radius.as_subclass(_CudaLooking)), 1.0)
    with torch.enable_grad():  # a gradient does not change the device's
        g = d.x.clone().requires_grad_()
        assert not L._on_card(lights, sphere, [idx, g])


@pytest.mark.parametrize("op", OPS)
def test_cpu_operands_needing_grad_take_the_plain_path(op):
    """CPU operands with an intensity that requires grad, under grad mode:
    the plain path, its values, a gradient reaching the intensity, and no
    launch."""
    lights, sphere, idx, pos, d, u = _lanes(1, 4, special=False)
    want = _calls(lights, sphere, idx, pos, d, u)[op][1]()
    leaf = lights.intensity.y.clone().requires_grad_()
    lights = lights._replace(intensity=lights.intensity._replace(y=leaf))
    launches = L.lights_kernel.launches
    with torch.enable_grad():
        got = _calls(lights, sphere, idx, pos, d, u)[op][0]()
        _equal(got, want)
        got[0].y.sum().backward()
    assert L.lights_kernel.launches == launches
    assert leaf.grad is not None and bool(leaf.grad.abs().sum() > 0)


@pytest.fixture
def plain_kernel(monkeypatch):
    """Every operand taken for a card's, and the kernel stood in for by
    the plain chain (its outputs fresh and detached), launches counted."""

    def kernel(op, lights, sphere, planes):
        kernel.launches += 1
        with torch.no_grad():
            return [o.clone() for o in L._plain(op, lights, sphere, planes)]

    kernel.launches = 0
    monkeypatch.setattr(L, "_on_card", lambda *operands: True)
    monkeypatch.setattr(L, "lights_kernel", kernel)
    return kernel


def _grad_lanes(scene_id, seed):
    """_lanes (no special values) with the light intensity's three planes,
    the receiving positions and the ray directions needing gradients."""
    lights, sphere, idx, pos, d, u = _lanes(scene_id, seed, 400,
                                            special=False)
    leaves = [c.clone().requires_grad_() for c in (*lights.intensity, *pos,
                                                   *d)]
    lights = lights._replace(intensity=V3(*leaves[0:3]))
    return (lights, sphere, idx, V3(*leaves[3:6]), V3(*leaves[6:9]), u), \
        leaves


@pytest.mark.parametrize("scene_id", SCENES)
@pytest.mark.parametrize("op", OPS)
def test_the_kernel_under_grad_has_the_plain_gradient(plain_kernel, op,
                                                      scene_id):
    """Operands on a card that need a gradient: one launch, the plain
    path's values, the plain path's gradients to the light intensity, the
    receiving positions and the ray directions, and the bool outputs
    detached."""
    ops, leaves = _grad_lanes(scene_id, 6)
    call, plain = _calls(*ops)[op]

    def run(fn):
        with torch.enable_grad():
            outs = list(L._leaves(fn()))
            total = sum(o.sum() * (k + 1) for k, o in enumerate(outs)
                        if o.requires_grad)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        return outs, grads

    got, got_grads = run(call)
    assert plain_kernel.launches == 1
    want, want_grads = run(plain)
    _equal(tuple(got), tuple(want))
    assert not any(o.requires_grad for o in got if o.dtype == torch.bool)
    # A leaf the plain graph never reaches gets None there and zeros
    # through the autograd function (it reaches every operand).
    zero = lambda g, t: torch.zeros_like(t) if g is None else g
    for g, w, t in zip(got_grads, want_grads, leaves):
        _equal(zero(g, t), zero(w, t))
    assert all(w is not None for w in want_grads[:3])  # the intensity's


def test_no_grad_takes_the_kernel_outside_autograd(plain_kernel):
    """Under no_grad an operand that requires grad does not bring in the
    autograd function: the kernel's outputs come back as they are."""
    (lights, sphere, idx, pos, _, u), _ = _grad_lanes(1, 7)
    with torch.no_grad():
        ill = L.illuminate(lights, idx, sphere, pos, u[:, 1], u[:, 2])
    assert plain_kernel.launches == 1
    assert not any(t.requires_grad for t in L._leaves(ill))


def _planes(op="illuminate", n=64):
    lights, sphere, idx, pos, d, u = _lanes(2, 5, n)
    planes = {"illuminate": [idx, *pos, u[:, 1], u[:, 2]],
              "emit": [idx, *(u[:, k] for k in range(1, 5))],
              "get_radiance": [idx, *d]}[op]
    return lights, sphere, planes


@pytest.mark.parametrize("case,match", [
    ("unknown_op", "unknown op"),
    ("too_few_planes", "operand planes"),
    ("float_id", "operand 0"),
    ("int32_id", "operand 0"),
    ("double_plane", "operand 1"),
    ("not_a_tensor", "operands are tensors"),
    ("int64_kind", "lights are"),
    ("short_table_plane", "lights are"),
    ("too_many_lights", "lights are"),
    ("double_sphere", "scene sphere"),
    ("three_dims", "3 dimensions"),
    ("cpu", "CUDA device"),
    ("mixed_devices", "CUDA device"),
])
def test_kernel_wrapper_refuses_before_loading_anything(case, match):
    lights, sphere, planes = _planes()
    op = "illuminate"
    if case == "unknown_op":
        op = "shade"
    elif case == "too_few_planes":
        planes = planes[:5]
    elif case == "float_id":
        planes[0] = planes[0].float()
    elif case == "int32_id":
        planes[0] = planes[0].int()
    elif case == "double_plane":
        planes[1] = planes[1].double()
    elif case == "not_a_tensor":
        planes[4] = 0.5
    elif case == "int64_kind":
        lights = lights._replace(kind=lights.kind.long())
    elif case == "short_table_plane":
        lights = lights._replace(inv_area=lights.inv_area[:0])
    elif case == "too_many_lights":
        lights = L._lights_of(t.repeat(L.MAX_LIGHTS + 1)
                              for t in L._leaves(lights))
    elif case == "double_sphere":
        sphere = sphere._replace(radius=sphere.radius.double())
    elif case == "three_dims":
        planes[5] = planes[5].reshape(1, 1, -1)
    elif case == "mixed_devices":
        planes[1] = planes[1].to("meta")
    launches = L.lights_kernel.launches
    with pytest.raises(ValueError, match=match):
        L.lights_kernel(op, lights, sphere, planes)
    assert L.lights_kernel.launches == launches


@pytest.mark.parametrize("op", OPS)
def test_kernel_wrapper_counts_each_ops_planes(op):
    """Each op's operand count: one plane short is refused, and the plane
    lists the public functions pass have the count."""
    lights, sphere, planes = _planes(op)
    assert len(planes) == L._N_IN[op]
    with pytest.raises(ValueError, match="operand planes"):
        L.lights_kernel(op, lights, sphere, planes[:-1])


def test_lights_launches_reach_the_trace_summary(monkeypatch):
    monkeypatch.setattr(L.lights_kernel, "launches", 21)
    counters = trace.summary()["counters"]
    assert counters["lights.launches"] == 21
    assert ("lights.launches", L.lights_kernel, "launches") in \
        graphs._counters()
