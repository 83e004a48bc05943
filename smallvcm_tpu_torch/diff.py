"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

Port of ``smallvcm_tpu/diff.py`` (single device): path tracing, BPT
connections and photon merging are differentiable with torch autograd
w.r.t. material reflectances, Phong exponents, IORs and light intensities.

Gradient strategy (ops/bsdf.py::setup): the lobe-selection and
Russian-roulette probabilities are detached, so discrete decisions are
constants and the survivors' 1/probability weights make the estimator's
gradient unbiased. Continuous sampling transforms (the Phong lobe) give
reparameterised gradients. Merging algorithms use the pair-expansion merge
(``merge_backend="xla"``, as the JAX package's ``render_params`` does): the
tile kernel is forward-only. On a card the closest-hit sweep is the kernel
with its autograd backward (ops/sweep.py::_SweepKernelFn).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .core.vec3 import V3
from .scene.scene import Materials, SceneData


class Params(NamedTuple):
    """Differentiable scene parameters (V3 = component-planar colour)."""

    diffuse: V3                   # V3 of [M]
    phong: V3                     # V3 of [M]
    exponent: torch.Tensor        # [M]
    mirror: V3                    # V3 of [M]
    ior: torch.Tensor             # [M]
    light_intensity: V3           # V3 of [L]


def extract_params(scene: SceneData) -> Params:
    m = scene.materials
    return Params(
        diffuse=m.diffuse,
        phong=m.phong,
        exponent=m.exponent,
        mirror=m.mirror,
        ior=m.ior,
        light_intensity=scene.lights.intensity,
    )


def apply_params(scene: SceneData, params: Params) -> SceneData:
    mats = Materials(
        diffuse=params.diffuse,
        phong=params.phong,
        exponent=params.exponent,
        mirror=params.mirror,
        ior=params.ior,
    )
    lights = scene.lights._replace(intensity=params.light_intensity)
    return dataclasses.replace(scene, materials=mats, lights=lights)


def _leaves(params: Params) -> list:
    return [t for f in params for t in (f if isinstance(f, V3) else (f,))]


def _unflatten(leaves) -> Params:
    it = iter(leaves)
    fields = []
    for name in Params._fields:
        if name in ("exponent", "ior"):
            fields.append(next(it))
        else:
            fields.append(V3(next(it), next(it), next(it)))
    return Params(*fields)


def render_params(
    scene: SceneData,
    params: Params,
    iteration: int,
    algorithm: str,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
):
    """One iteration of the given algorithm with params substituted ->
    image [resY, resX, 3], differentiable in ``params``."""
    from .algorithms import pathtracer, vcm
    from .render import _VCM_FLAGS

    s = apply_params(scene, params)
    if algorithm == "pt":
        img, _ = pathtracer.render_iteration(
            s, iteration, res_x, res_y, base_seed, max_path_length,
            min_path_length,
        )
        return img
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[algorithm]
    img, _ = vcm.render_iteration(
        s, iteration, res_x, res_y, base_seed, max_path_length,
        min_path_length, radius_factor, radius_alpha,
        use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only, ppm=ppm,
        merge_backend="xla",
    )
    return img


def loss_and_grad(
    scene: SceneData,
    params: Params,
    target,
    iteration: int,
    algorithm: str,
    res_x: int,
    res_y: int,
    n_iterations: int = 1,
    **kw,
):
    """L2 image loss against a target and its gradient w.r.t. params ->
    (loss scalar tensor, gradient Params).

    Averages ``n_iterations`` stochastic iterations before the loss. Each
    iteration runs under ``torch.utils.checkpoint`` (``jax.checkpoint`` in
    the JAX package): its activations are dropped after the forward and
    recomputed in the backward, so memory holds one iteration's graph at a
    time. The counter-based RNG makes the recomputation exact.
    """
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]

    def one(i, *ls):
        return render_params(scene, _unflatten(ls), iteration * n_iterations
                             + i, algorithm, res_x, res_y, **kw)

    img = None
    for i in range(n_iterations):
        part = checkpoint(one, i, *leaves, use_reentrant=False)
        img = part if img is None else img + part
    img = img / n_iterations
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), _unflatten(grads)
