"""The benchmark's plain gradient step (benchmark/reference/grad.py)
against the port's ``diff.loss_and_grad`` on the CPU: vcm through the pair
merge and pt, one iteration at 16x16, at parameters drawn from a seed
(reflectances in [0, 0.9] where the scene has the lobe, Phong exponents in
[1, 100], IORs in [1.2, 2] where the material refracts, light intensities
times [0.5, 2]).

Tolerances: the loss to rtol 1e-6, and each gradient leaf to 1e-5 of its
largest |reference| value (plus 1e-12): both sides differentiate the same
estimator from the same forward bits (the copy is the port's plain path)
and sum a material row's lanes alike; the port's pair merge sums the
photons of a query in another order, which moves a gradient by float
rounding alone (pt equal bit for bit, vcm at most 1.2e-6 of the leaf's
scale over six draws here).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_grad_reference.py -q
"""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import env
from benchmark.reference import grad as ref
from smallvcm_tpu_torch import diff
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.scene.scene import load_cornell_box

torch.set_num_threads(2)

RES = 16
SEED = 2 ** 31 + 2027          # the renderer keys on its low 32 bits


def _config(alg: str) -> dict:
    """The gradient cell's configuration at 16x16, its merge radius
    widened to 5% of the scene's so that the few paths merge."""
    path = env.ROOT / "benchmark" / "configs" / "vcm_cornell_512_grad.json"
    config = json.loads(path.read_text())
    config.update(resolution=[RES, RES], algorithm=alg, radius_factor=0.05)
    return config


def _drawn(params, seed: int):
    """``params`` with values drawn from ``seed`` (see the docstring)."""
    r = np.random.default_rng(seed)
    draw = lambda lo, hi, like: torch.from_numpy(
        r.uniform(lo, hi, like.shape).astype(np.float32))

    def reflectance(v: V3) -> V3:
        has = v.max_component() > 0
        return V3(*(torch.where(has, draw(0.0, 0.9, c), c) for c in v))

    return params._replace(
        diffuse=reflectance(params.diffuse),
        phong=reflectance(params.phong),
        exponent=draw(1.0, 100.0, params.exponent),
        mirror=reflectance(params.mirror),
        ior=torch.where(params.ior > 0, draw(1.2, 2.0, params.ior),
                        params.ior),
        light_intensity=params.light_intensity * draw(
            0.5, 2.0, params.light_intensity.x))


@pytest.mark.parametrize("alg", ["vcm", "pt"])
@pytest.mark.parametrize("draw", [1, 2])
def test_loss_and_grad_equals_the_plain_reference(alg, draw):
    config = _config(alg)
    scene = load_cornell_box((RES, RES), config["scene_mask"], device="cpu")
    params = _drawn(diff.extract_params(scene), SEED + draw)
    target = torch.from_numpy(np.random.default_rng(draw).uniform(
        0.0, 0.5, (RES, RES, 3)).astype(np.float32))
    base = SEED & 0xFFFFFFFF
    iteration = 3 + draw
    kw = dict(base_seed=base, radius_factor=config["radius_factor"])
    kw.update(diff.fit_caps(scene, params, alg, RES, RES, **kw))
    loss, g = diff.loss_and_grad(scene, params, target, iteration, alg, RES,
                                 RES, **kw)
    leaves = list(diff._leaves(params))
    want_loss, want, mass = ref.loss_and_grad(config, base, iteration,
                                              leaves, target, "cpu")
    assert int(diff.truncated_steps("cpu")) == 0
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0.0)
    got = list(diff._leaves(g))
    assert len(got) == len(want) == 14
    assert float(sum(w.abs().sum() for w in want)) > 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        bound = 1e-5 * float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= bound, (i, a, b)
    # A value's lane mass bounds its gradient (the sum of the lanes' terms)
    # and is zero only where no lane reached it.
    for b, m in zip(want, mass):
        assert m.shape == b.shape and m.dtype == torch.float64
        assert bool((b.double().abs() <= m * (1 + 1e-5) + 1e-12).all()), \
            (b, m)
    assert float(sum(m.sum() for m in mass)) > 0.0


def test_reference_leaves_follow_the_ports_params():
    """The reference's leaves and starting point are the port's: the same
    values in diff.Params' order, the diffuse planes scaled."""
    config = _config("vcm")
    scene = load_cornell_box((RES, RES), config["scene_mask"], device="cpu")
    copy = ref.compute.build_scene(config, "cpu")
    port = list(diff._leaves(diff.extract_params(scene)))
    mine = ref.leaves(copy)
    assert len(port) == len(mine) == 14
    for a, b in zip(port, mine):
        assert torch.equal(a, b)
    start = ref.start_leaves(copy, config)
    scale = config["start"]["diffuse_scale"]
    for i, (a, b) in enumerate(zip(port, start)):
        assert torch.equal(a * scale if i < 3 else a, b)


@pytest.mark.parametrize("lanes,rows", [(1000, 9), (262_144, 4)])
def test_the_reference_gather_has_plain_indexings_gradient(lanes, rows):
    """The reference's one-hot gather (``grad._TakeRows``, the order the
    port sums a row's lanes in) gives the forward of ``table[idx]`` bit for
    bit and its gradient as plain indexing's autograd does, within float32
    rounding of the lanes' sum: each row within 1e-5 of the sum of its
    lanes' |gradient| (the float64 sum of both sides' lanes is the
    arbiter), at a scene's material count and at 512x512's paths; and it
    keeps that sum, the row's lane mass."""
    r = np.random.default_rng(lanes)
    table = torch.from_numpy(r.uniform(0.1, 0.9, rows).astype(np.float32))
    idx = torch.from_numpy(r.integers(0, rows, lanes))
    up = torch.from_numpy(r.normal(0.0, 1.0, lanes).astype(np.float32))
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    with torch.enable_grad(), ref._gradient_gathers([a]) as (lanes,):
        got = ref._take(a, idx)
        plain = b[idx]
        (g_got,) = torch.autograd.grad((got * up).sum(), a)
        (g_plain,) = torch.autograd.grad((plain * up).sum(), b)
    assert torch.equal(got, plain)
    exact = torch.zeros(rows, dtype=torch.float64).index_add_(
        0, idx, up.double())
    mass = torch.zeros(rows, dtype=torch.float64).index_add_(
        0, idx, up.double().abs())
    # The lane mass the gather kept: each row's sum of |lane gradient|.
    torch.testing.assert_close(lanes, mass, rtol=1e-6, atol=0.0)
    for g in (g_got, g_plain):
        assert bool(((g.double() - exact).abs() <= 1e-5 * mass).all()), \
            (g, exact)
    assert bool(((g_got.double() - g_plain.double()).abs()
                 <= 2e-5 * mass).all())
    # A colour table (the copy's V3) takes the same gather per plane.
    v = ref.V3(*(table.clone().requires_grad_(True) for _ in range(3)))
    with torch.enable_grad():
        out = ref._take(v, idx)
        (gx,) = torch.autograd.grad((out.x * up).sum(), v.x)
    assert torch.equal(gx, g_got)
