"""Gradients of the port: the furnace oracle, AD vs JAX, AD vs FD.

* White-furnace oracle (tests/test_grad.py's): one-bounce estimator on
  the glossy-floor material with Russian roulette, whose true derivative
  w.r.t. the diffuse x-reflectance is exactly 1. It must read 1.0 +- 0.03;
  with live (undetached) lobe and roulette probabilities it reads ~0.62.
* Port gradients of the mean image against ``jax.grad`` of
  ``diff.render_params`` on the same scene and seed (pt at 16x16 here,
  vcm at 8x8 in test_torch_diff_vcm.py, max path length 6). Bound: per leaf, |port - jax| <= 1e-4 x the
  leaf's largest |jax| + 1e-9; both differentiate the same estimator, and
  the difference is float rounding through ~10 bounces.
* Light intensity: the image is linear in it and it never moves a sampling
  decision, so AD equals central FD (rtol 2e-2, test_grad.py's bound).
* The sweep kernel's backward formula (``winner_distance``) against the
  plain dense sweep's own autograd, and ``loss_and_grad`` (checkpointed)
  against the same loss differentiated without checkpointing.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallvcm_tpu import diff as jdiff
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import convert, diff
from smallvcm_tpu_torch.core import rng
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import bsdf as bsdf_ops
from smallvcm_tpu_torch.ops import sweep as S
from smallvcm_tpu_torch.scene.scene import Materials, load_cornell_box

torch.set_num_threads(2)


def _grad_leaves(scene, params, fn):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in diff._leaves(params)]
    out = fn(diff._unflatten(leaves))
    return out, torch.autograd.grad(out, leaves, allow_unused=True)


def test_furnace_gradient_unbiased():
    scene = load_cornell_box((32, 32), SCENE_CONFIGS[1], device="cpu")
    n = 1 << 17
    u = rng.uniform_slots(4242, 0, torch.arange(n), 4)
    zeros = torch.zeros(n)
    normal = V3(zeros, zeros, torch.ones(n))
    d = np.random.default_rng(0).normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray_dir = V3(*(torch.from_numpy(d[:, i].astype(np.float32))
                   for i in range(3)))
    mat = torch.full((n,), 2)
    hit = torch.ones(n, dtype=torch.bool)

    dx = torch.tensor(0.1, requires_grad=True)
    m = scene.materials
    diffuse = V3(torch.cat([m.diffuse.x[:2], dx[None], m.diffuse.x[3:]]),
                 m.diffuse.y, m.diffuse.z)
    m2 = Materials(diffuse=diffuse, phong=m.phong, exponent=m.exponent,
                   mirror=m.mirror, ior=m.ior)
    b = bsdf_ops.setup(m2, ray_dir, normal, mat, hit)
    value, _, pdf, cosg, _, keep = bsdf_ops.sample(
        m2, b, u[:, 0], u[:, 1], u[:, 2], fix_is_light=False)
    cont = b.cont_prob
    surv = (u[:, 3] <= cont) & keep
    w = torch.where(
        surv,
        value.x * cosg / torch.where(pdf == 0, 1, pdf)
        / torch.where(cont == 0, 1, cont),
        0.0,
    )
    (grad,) = torch.autograd.grad(w.mean(), dx)
    assert abs(float(grad) - 1.0) < 0.03, float(grad)


def gradients_match_jax(alg, res):
    js = jload((res, res), SCENE_CONFIGS[1])
    jp = jdiff.extract_params(js)
    want = jax.grad(lambda p: jnp.mean(jdiff.render_params(
        js, p, 0, alg, res, res, max_path_length=6)))(jp)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, want),
                                     device="cpu")

    scene = load_cornell_box((res, res), SCENE_CONFIGS[1], device="cpu")
    # The port's own parameters equal the JAX package's.
    port_params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")
    for a, b in zip(diff._leaves(diff.extract_params(scene)),
                    diff._leaves(port_params)):
        assert torch.equal(a, b)
    _, got = _grad_leaves(scene, port_params, lambda p: diff.render_params(
        scene, p, 0, alg, res, res, max_path_length=6).mean())
    for name, g, w in zip(
            [f for f in diff.Params._fields
             for _ in range(1 if f in ("exponent", "ior") else 3)],
            got, diff._leaves(want)):
        g = torch.zeros_like(w) if g is None else g
        assert torch.isfinite(g).all(), name
        bound = 1e-4 * float(w.abs().max()) + 1e-9
        assert float((g - w).abs().max()) <= bound, name
    assert float(want.light_intensity.x.abs().max()) > 0.0


def test_pt_gradients_match_jax():
    gradients_match_jax("pt", 16)


def test_merging_gradients_nonzero_and_finite():
    """BPM is pure merging: gradients must flow through the photon map
    (the pair-expansion merge; a merge radius large enough that most
    camera vertices find photons at 16x16)."""
    res = 16
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1], device="cpu")
    _, g = _grad_leaves(scene, diff.extract_params(scene),
                        lambda p: diff.render_params(
                            scene, p, 0, "bpm", res, res,
                            max_path_length=6, radius_factor=0.05).mean())
    g = diff._unflatten([torch.zeros(1) if x is None else x for x in g])
    assert float(g.diffuse.x.abs().max()) > 0.0
    assert float(g.light_intensity.x.abs().max()) > 0.0
    assert all(torch.isfinite(x).all() for x in diff._leaves(g))


def test_light_intensity_ad_equals_fd():
    res, iters = 16, 2
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1], device="cpu")
    params = diff.extract_params(scene)

    def loss(p):
        return sum(diff.render_params(scene, p, i, "pt", res, res,
                                      max_path_length=6).mean()
                   for i in range(iters)) / iters

    _, g = _grad_leaves(scene, params, loss)
    g_int = float(diff._unflatten(g).light_intensity.x[0])
    assert abs(g_int) > 0

    eps = 1e-2
    li = params.light_intensity

    def bumped(e):
        x = li.x.clone()
        x[0] += e
        return float(loss(params._replace(light_intensity=V3(x, li.y, li.z))))

    fd = (bumped(eps) - bumped(-eps)) / (2 * eps)
    np.testing.assert_allclose(g_int, fd, rtol=2e-2, atol=1e-7)


def test_sweep_backward_formula_matches_plain_autograd():
    """The kernel Function's backward differentiates winner_distance; on
    the CPU it must equal the plain sweep's autograd gradient."""
    for config in SCENE_CONFIGS:
        scene = load_cornell_box((8, 8), config, device="cpu")
        r = np.random.default_rng(config)
        n = 20000
        o = (np.array([[-1.2], [-1.2], [-1.2]]) + 2.4 * r.random((3, n)))
        d = r.normal(size=(3, n))
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        wts = torch.from_numpy(r.random(n).astype(np.float32))

        def grads(fn):
            rays = [torch.from_numpy(a.astype(np.float32)).requires_grad_()
                    for a in (*o, *d)]
            dist, prim = fn(V3(*rays[:3]), V3(*rays[3:]))
            hit = dist < S.BIG_DIST
            out = torch.where(hit, dist, 0.0)
            return out, prim, torch.autograd.grad((out * wts).sum(), rays)

        want_t, _, want = grads(lambda a, b: S.sweep_plain(scene, a, b))
        got_t, _, got = grads(lambda a, b: (
            S.winner_distance(scene, a, b, S.sweep_plain(scene, a, b)[1]),
            None))
        torch.testing.assert_close(got_t, want_t, rtol=1e-6, atol=0.0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_loss_and_grad_checkpointing_is_exact():
    res = 8
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1], device="cpu")
    params = diff.extract_params(scene)
    target = torch.full((res, res, 3), 0.2)
    for alg in ("pt", "bpm"):
        loss, g = diff.loss_and_grad(scene, params, target, 1, alg, res, res,
                                     n_iterations=2, max_path_length=5)

        def plain(p):
            img = sum(diff.render_params(scene, p, 2 + i, alg, res, res,
                                         max_path_length=5)
                      for i in range(2)) / 2
            return torch.mean((img - target) ** 2)

        want_loss, want = _grad_leaves(scene, params, plain)
        assert float(loss) == float(want_loss.detach())
        for a, b in zip(diff._leaves(g), want):
            b = torch.zeros_like(a) if b is None else b
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("alg", ["pt", "bpm"])
def test_loss_and_grad_matches_golden(alg):
    """loss_and_grad on scene 1 at 32x32 against the JAX package's
    (tests/data/torch_golden_grad_s1_32.npz): the light-intensity gradient
    to rtol 1e-3 and the loss to rtol 1e-4; every leaf finite."""
    data = np.load(Path(__file__).parent / "data"
                   / "torch_golden_grad_s1_32.npz")
    c = json.loads(str(data["config"]))
    res_x, res_y = c["resolution"]
    scene = load_cornell_box((res_x, res_y), SCENE_CONFIGS[c["scene_id"]],
                             device="cpu")
    target = torch.full((res_y, res_x, 3), c["target"])
    loss, g = diff.loss_and_grad(
        scene, diff.extract_params(scene), target, c["iteration"], alg,
        res_x, res_y, n_iterations=c["n_iterations"],
        base_seed=c["base_seed"], max_path_length=c["max_path_length"])
    flat = torch.cat([x.reshape(-1) for x in diff._leaves(g)])
    want = torch.from_numpy(data[f"{alg}_grad"])
    assert flat.shape == want.shape and bool(torch.isfinite(flat).all())
    n_li = 3 * scene.lights.kind.shape[0]
    torch.testing.assert_close(flat[-n_li:], want[-n_li:], rtol=1e-3,
                               atol=0.0)
    assert abs(float(loss) / float(data[f"{alg}_loss"]) - 1.0) < 1e-4


def test_take_gradient_equals_index_gradient():
    """core.vec3.take's one-hot backward sums each row's lane gradients,
    as the index backward does (up to summation order)."""
    from smallvcm_tpu_torch.core.vec3 import take

    r = np.random.default_rng(5)
    table = torch.from_numpy(r.random(9).astype(np.float32))
    idx = torch.from_numpy(r.integers(0, 9, (4, 5000)))
    w = torch.from_numpy(r.normal(size=(4, 5000)).astype(np.float32))
    grads = []
    for fn in (take, lambda t_, i: t_[i]):
        t_ = table.clone().requires_grad_()
        (g,) = torch.autograd.grad((fn(t_, idx) * w).sum(), t_)
        grads.append(g)
        assert torch.equal(fn(t_, idx), table[idx])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
