"""Sharded gradients: the collectives' backward rules and the sharded step.

Two gloo CPU ranks, spawned once for the module, compute everything below
and this process holds it against single-process autograd:

* each autograd Function of parallel/comm.py against autograd on the
  concatenated tensors: the framebuffer all-reduce (identity backward for
  a replicated loss), the column all-gather (the sum over ranks of each
  rank's slice), the ring shift (the reverse shift); rtol 1e-6;
* ``diff.sharded_loss_and_grad`` against the port's ``loss_and_grad`` on
  scene 1 at 16x16, max path length 3, at the JAX package's tolerances
  (tests/test_sharding.py:132,171): rtol 1e-3 / atol 1e-5 for pt, rtol
  2e-3 / atol 1e-5 for VCM with either exchange (also two checkpointed
  iterations); the losses to rtol 1e-6;
* the white-furnace oracle of test_torch_diff.py with its lanes split over
  the ranks: the derivative reads 1.0 +- 0.03 (an all-reducing backward
  would read 2.0).
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu_torch import diff
from smallvcm_tpu_torch.core import rng
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import bsdf as bsdf_ops
from smallvcm_tpu_torch.parallel import comm, multihost
from smallvcm_tpu_torch.scene.scene import (SCENE_CONFIGS, Materials,
                                            load_cornell_box)

RES = 16
RANKS = 2
SHAPE = (2, 3, 4)
STEPS = (("pt", "allgather", 1), ("vcm", "allgather", 1),
         ("vcm", "ring", 1), ("vcm", "allgather", 2))
FURNACE_LANES = 1 << 17


def _arr(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _functions(group, r):
    """Each Function's gradient w.r.t. this rank's input."""
    out = {}
    x = _arr(10 + r, SHAPE).requires_grad_()
    s = comm.framebuffer_sum(x, group)
    (out["sum"],) = torch.autograd.grad((s * s * _arr(1, SHAPE)).sum(), x)
    out["sum_value"] = s.detach()
    wide = SHAPE[:-1] + (RANKS * SHAPE[-1],)
    g = comm.all_gather_columns(x, group)
    (out["gather"],) = torch.autograd.grad(
        (torch.sin(g) * _arr(20 + r, wide)).sum(), x)
    out["gather_value"] = g.detach()
    y = comm.ring_shift(x, group)
    (out["ring"],) = torch.autograd.grad(
        (torch.cos(y) * _arr(30 + r, SHAPE)).sum(), x)
    out["ring_value"] = y.detach()
    return out


def _furnace_lanes(pix):
    """test_torch_diff.py's one-bounce furnace estimator on lanes ``pix``
    -> (estimator sum over the lanes / all lanes, the parameter)."""
    scene = load_cornell_box((32, 32), SCENE_CONFIGS[1], device="cpu")
    n = pix.shape[0]
    u = rng.uniform_slots(4242, 0, pix, 4)
    zeros = torch.zeros(n)
    normal = V3(zeros, zeros, torch.ones(n))
    d = np.random.default_rng(0).normal(size=(FURNACE_LANES, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.05
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d[pix.numpy()]
    ray_dir = V3(*(torch.from_numpy(d[:, i].astype(np.float32))
                   for i in range(3)))
    dx = torch.tensor(0.1, requires_grad=True)
    m = scene.materials
    diffuse = V3(torch.cat([m.diffuse.x[:2], dx[None], m.diffuse.x[3:]]),
                 m.diffuse.y, m.diffuse.z)
    m2 = Materials(diffuse=diffuse, phong=m.phong, exponent=m.exponent,
                   mirror=m.mirror, ior=m.ior)
    b = bsdf_ops.setup(m2, ray_dir, normal, torch.full((n,), 2),
                       torch.ones(n, dtype=torch.bool))
    value, _, pdf, cosg, _, keep = bsdf_ops.sample(
        m2, b, u[:, 0], u[:, 1], u[:, 2], fix_is_light=False)
    cont = b.cont_prob
    w = torch.where((u[:, 3] <= cont) & keep,
                    value.x * cosg / torch.where(pdf == 0, 1, pdf)
                    / torch.where(cont == 0, 1, cont), 0.0)
    return w.sum() / FURNACE_LANES, dx


def _rank_work():
    torch.set_num_threads(1)
    group = multihost.global_group()
    r = comm.rank(group)
    out = {"functions": _functions(group, r)}
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[1], device="cpu")
    target = torch.zeros((RES, RES, 3))
    for alg, exchange, n_it in STEPS:
        loss, g = diff.sharded_loss_and_grad(
            group, scene, diff.extract_params(scene), target, 0, alg, RES,
            RES, n_iterations=n_it, vm_exchange=exchange, max_path_length=3)
        out[alg, exchange, n_it] = (loss, diff._leaves(g))
    m = FURNACE_LANES // RANKS
    part, dx = _furnace_lanes(torch.arange(r * m, (r + 1) * m))
    (g,) = torch.autograd.grad(comm.framebuffer_sum(part, group), dx)
    out["furnace"] = float(comm.all_reduce_sum(g, group))
    return out


@pytest.fixture(scope="module")
def ranks():
    return multihost.spawn(RANKS, "cpu", _rank_work)


def test_framebuffer_sum_backward_is_identity(ranks):
    xs = [_arr(10 + r, SHAPE).requires_grad_() for r in range(RANKS)]
    s = sum(xs)
    grads = torch.autograd.grad((s * s * _arr(1, SHAPE)).sum(), xs)
    for r in range(RANKS):
        f = ranks[r]["functions"]
        torch.testing.assert_close(f["sum_value"], s.detach(), rtol=1e-6,
                                   atol=0.0)
        torch.testing.assert_close(f["sum"], grads[r], rtol=1e-6, atol=0.0)


def test_all_gather_backward_sums_each_slice_over_ranks(ranks):
    xs = [_arr(10 + r, SHAPE).requires_grad_() for r in range(RANKS)]
    cat = torch.cat(xs, dim=-1)
    wide = SHAPE[:-1] + (RANKS * SHAPE[-1],)
    loss = sum((torch.sin(cat) * _arr(20 + r, wide)).sum()
               for r in range(RANKS))
    grads = torch.autograd.grad(loss, xs)
    for r in range(RANKS):
        f = ranks[r]["functions"]
        assert torch.equal(f["gather_value"], cat.detach())
        torch.testing.assert_close(f["gather"], grads[r], rtol=1e-6,
                                   atol=1e-7)


def test_ring_shift_backward_is_the_reverse_shift(ranks):
    xs = [_arr(10 + r, SHAPE).requires_grad_() for r in range(RANKS)]
    loss = sum((torch.cos(xs[(r - 1) % RANKS]) * _arr(30 + r, SHAPE)).sum()
               for r in range(RANKS))
    grads = torch.autograd.grad(loss, xs)
    for r in range(RANKS):
        f = ranks[r]["functions"]
        assert torch.equal(f["ring_value"], xs[(r - 1) % RANKS].detach())
        torch.testing.assert_close(f["ring"], grads[r], rtol=1e-6,
                                   atol=0.0)


@pytest.mark.parametrize("step", STEPS, ids=lambda s: "-".join(map(str, s)))
def test_sharded_loss_and_grad_matches_single_process(ranks, step):
    alg, _, n_it = step
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[1], device="cpu")
    loss, g = diff.loss_and_grad(
        scene, diff.extract_params(scene), torch.zeros((RES, RES, 3)), 0,
        alg, RES, RES, n_iterations=n_it, max_path_length=3)
    rtol = 1e-3 if alg == "pt" else 2e-3
    for r in range(RANKS):
        got_loss, got = ranks[r][step]
        assert abs(float(got_loss) / float(loss) - 1.0) < 1e-6
        for a, b in zip(got, diff._leaves(g)):
            torch.testing.assert_close(a, b, rtol=rtol, atol=1e-5)
    assert float(g.light_intensity.x.abs().max()) > 0.0


def test_furnace_gradient_unbiased_over_two_ranks(ranks):
    for r in range(RANKS):
        assert abs(ranks[r]["furnace"] - 1.0) < 0.03, ranks[r]["furnace"]
    # The same estimator in one process reads the same value.
    part, dx = _furnace_lanes(torch.arange(FURNACE_LANES))
    (g,) = torch.autograd.grad(part, dx)
    assert abs(float(g) - ranks[0]["furnace"]) < 1e-5
