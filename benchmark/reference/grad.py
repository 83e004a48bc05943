"""The plain gradient step: the loss and the gradient of every scene
parameter, the answer the benchmark judges the port's
``diff.loss_and_grad`` by.

One step is the mean over pixels of the squared difference between the
mean of ``n_iterations`` iterations and the target, with the parameters
substituted into the frozen copy's scene (``svcm/``), and its gradient
with respect to each parameter leaf, under torch autograd in float32 with
TF32 off. An iteration is ``pairs.iteration_image``: the copy's light and
camera stages, then for the VCM family the plain pair merge (no caps, no
truncation); pt is the copy's path tracer. The leaves come in the port's
order (``diff.Params``: diffuse, phong, exponent, mirror, ior, light
intensity, a colour as its three planes).

The estimator is the port's, and nothing here departs from it:

* the copy's BSDF detaches the lobe-selection and Russian-roulette
  probabilities (``svcm/ops/bsdf.py::setup``), so discrete decisions are
  constants and the survivors' weights carry the gradient;
* the closest-hit sweep is the dense sweep, differentiated through
  torch's ``argmin`` and ``gather``: the gradient reaches the winning
  primitive's distance alone, which is what the port's sweep kernel's
  backward (``winner_distance``) computes; occlusion is a boolean and has
  none;
* the merge's positions enter only its cell and distance tests, so no
  gradient flows through them (the port detaches them);
* the gathers of materials and lights per lane (``take`` in
  ``svcm/ops/bsdf.py`` and ``svcm/ops/lights.py``) take, for the step
  alone, the port's one-hot backward (:class:`_TakeRows`, the autograd
  gather the frozen copy left out): a row's lane gradients are summed by
  a reduction, as the port sums them, and not one after another, as
  plain indexing's backward does, whose float32 rounding over 262,144
  lanes was most of the gap between the two.

The port's pair merge truncates at its caps where this one has none; the
benchmark counts a truncated step as failed. There is no checkpoint: the
whole iteration's graph is held at once. It imports nothing of the port.

``dtype`` is the precision the step ends in: float32 is the reference;
bfloat16 is the control (the image and the target rounded to it before
the loss, the loss computed in it, and the loss and every gradient
rounded to it), which the checks must refuse.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from . import compute, pairs
from .svcm.core.vec3 import V3
from .svcm.ops import bsdf, lights


# The lane mass of each leaf being differentiated, by the leaf's id: a
# float64 tensor of the leaf's shape (see :func:`loss_and_grad`).
_MASS: dict = {}


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` with a backward that sums each lane's gradient into
    its row by a one-hot reduction, and adds the lanes' |gradient| to the
    row's lane mass where ``table`` is a leaf in ``_MASS``."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        ctx.mass = _MASS.get(id(table))
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        onehot = torch.zeros((flat.shape[0], ctx.rows), dtype=grad.dtype,
                             device=grad.device)
        onehot.scatter_(1, flat[:, None], 1.0)
        lanes = grad.reshape(-1, 1)
        if ctx.mass is not None:
            ctx.mass += (onehot * lanes.abs()).sum(0).double()
        return (onehot * lanes).sum(0), None


def _take(table, idx):
    """The copy's ``take`` with :class:`_TakeRows` where the table needs a
    gradient."""
    if isinstance(table, V3):
        return V3(*(_take(c, idx) for c in table))
    if torch.is_grad_enabled() and table.requires_grad:
        return _TakeRows.apply(table, idx)
    return table[idx]


@contextlib.contextmanager
def _gradient_gathers(leaves):
    """The copy's BSDF and lights gathers through :func:`_take` inside,
    the lane mass of each of ``leaves`` gathered from zero."""
    saved = bsdf.take, lights.take
    bsdf.take = lights.take = _take
    masses = [torch.zeros(t.shape, dtype=torch.float64, device=t.device)
              for t in leaves]
    _MASS.update({id(t): m for t, m in zip(leaves, masses)})
    try:
        yield masses
    finally:
        bsdf.take, lights.take = saved
        _MASS.clear()


def leaves(scene) -> list:
    """The scene's parameter leaves in the port's order."""
    m = scene.materials
    out = []
    for f in (m.diffuse, m.phong, m.exponent, m.mirror, m.ior,
              scene.lights.intensity):
        out += list(f) if isinstance(f, V3) else [f]
    return out


def with_leaves(scene, ls):
    """The scene with its parameters replaced by ``ls`` (:func:`leaves`'
    order)."""
    d, ph, ex, mi, ior, li = (V3(*ls[0:3]), V3(*ls[3:6]), ls[6],
                              V3(*ls[7:10]), ls[10], V3(*ls[11:14]))
    mats = scene.materials._replace(diffuse=d, phong=ph, exponent=ex,
                                    mirror=mi, ior=ior)
    return dataclasses.replace(scene, materials=mats,
                               lights=scene.lights._replace(intensity=li))


def start_leaves(scene, config: dict) -> list:
    """The configuration's starting parameters: the scene's own, every
    material's diffuse reflectance times ``config["start"]
    ["diffuse_scale"]``."""
    scale = config["start"]["diffuse_scale"]
    return [t * scale if i < 3 else t for i, t in enumerate(leaves(scene))]


def loss_and_grad(config: dict, base_seed: int, iteration: int, params,
                  target, device, dtype=torch.float32, scene=None):
    """The step at ``params`` (leaves in :func:`leaves`' order) against
    ``target`` [resY, resX, 3] -> (loss, [gradient of each leaf], [lane
    mass of each leaf]), float32 tensors on ``device`` (the masses
    float64): iterations ``iteration * n + i`` for ``i < n``, ``n`` the
    configuration's ``n_iterations``.

    A leaf value's lane mass is the sum over every gather of it of the
    lanes' |gradient|, the terms its gradient is the sum of: the scale at
    which float32 rounding of those terms acts, which does not vanish
    where the terms cancel (the glass sphere's IOR, whose lanes brighten
    some pixels and darken others) as the gradient itself does."""
    compute._no_tf32()
    scene = compute.build_scene(config, device) if scene is None else scene
    ls = [torch.as_tensor(p, dtype=torch.float32, device=device).detach()
          .clone().requires_grad_(True) for p in params]
    n = config.get("n_iterations", 1)
    with torch.enable_grad(), _gradient_gathers(ls) as masses:
        s = with_leaves(scene, ls)
        img = None
        for i in range(n):
            part = pairs.iteration_image(s, config, base_seed,
                                         iteration * n + i)
            img = part if img is None else img + part
        img = (img / n).to(dtype)
        want = torch.as_tensor(target, device=device).to(dtype)
        loss = torch.mean((img - want) ** 2)
        grads = torch.autograd.grad(loss, ls, allow_unused=True)
    return (loss.detach().float(),
            [torch.zeros_like(t).detach() if g is None else
             g.to(dtype).float() for t, g in zip(ls, grads)], masses)
