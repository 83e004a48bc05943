"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

Port of ``smallvcm_tpu/diff.py``: path tracing, BPT
connections and photon merging are differentiable with torch autograd
w.r.t. material reflectances, Phong exponents, IORs and light intensities.

Gradient strategy (ops/bsdf.py::setup): the lobe-selection and
Russian-roulette probabilities are detached, so discrete decisions are
constants and the survivors' 1/probability weights make the estimator's
gradient unbiased. Continuous sampling transforms (the Phong lobe) give
reparameterised gradients. Merging algorithms use the pair merge at static
caps (``merge_backend="xla"``, as the JAX package's ``render_params`` does;
``pair_factor`` / ``photon_factor`` / ``query_factor``, the JAX defaults 24 /
3 / 3, or the caps a render measured): the merge kernel is forward-only.
A truncation at the caps is not retried here, as in the JAX package. On a
card the closest-hit sweep is the kernel with its autograd backward
(ops/sweep.py::_SweepKernelFn).

On a card :func:`loss_and_grad` is one CUDA graph a step (graphs.py): the
forward, the loss, the checkpoint's recomputation and the backward are
captured once a key and replayed, the parameters, target and iteration
scalars copied into the graph's buffers first; the pair merge's
truncations are counted on the device (:func:`truncated_steps`), and
:func:`fit_caps` measures caps that the job's parameters fit.
:func:`sharded_loss_and_grad` takes the same step with paths sharded over a
torch.distributed group (parallel/sharding.py), eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from . import graphs, trace
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


class _Options(NamedTuple):
    """The keywords of :func:`render_params`, :func:`fit_caps` and
    :func:`loss_and_grad`, and their defaults (the JAX package's; the
    merge caps 24 / 3 / 3): a static value of the gradient step's graph
    key."""

    base_seed: int = 1234
    max_path_length: int = 10
    min_path_length: int = 0
    radius_factor: float = 0.003
    radius_alpha: float = 0.75
    pair_factor: float = 24.0
    photon_factor: float = 3.0
    query_factor: float = 3.0


def _scalars(scene: SceneData, iteration: int, algorithm: str, res_x: int,
             res_y: int, o: _Options) -> tuple:
    """The per-iteration scalars of :func:`_render`, as host numbers: pt's
    iteration; the VCM family's iteration, radius, r^2, vm normalization
    and two MIS weights (``vcm.iteration_scalars``)."""
    if algorithm == "pt":
        return (iteration,)
    from .algorithms import vcm
    from .render import _VCM_FLAGS

    use_vc, use_vm, _, _ = _VCM_FLAGS[algorithm]
    return vcm.iteration_scalars(scene, iteration, res_x * res_y,
                                 o.radius_factor, o.radius_alpha, use_vc,
                                 use_vm)


def _render(scene: SceneData, scalars: tuple, algorithm: str, res_x: int,
            res_y: int, o: _Options):
    """One iteration of ``algorithm`` at :func:`_scalars`' ``scalars``
    (host numbers, or 0-dim device tensors inside the step's graph) ->
    (image [resY, resX, 3], the pair merge's overflow int64 or None for
    pt, the rays traced int64): the iteration stages as ``render.py`` runs
    them, the pair merge at the caps of ``o``."""
    from .algorithms import pathtracer, vcm
    from .render import _VCM_FLAGS

    if algorithm == "pt":
        img, rays = pathtracer.render_iteration(
            scene, scalars[0], res_x, res_y, o.base_seed,
            o.max_path_length, o.min_path_length)
        return img, None, rays
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[algorithm]
    static = vcm.iteration_static(
        res_x, res_y, o.base_seed, o.max_path_length, o.min_path_length,
        use_vc, use_vm, lt_only, ppm, "threefry", o.photon_factor,
        o.query_factor, "xla", o.pair_factor)
    img, rays, overflow, _ = graphs.stage(vcm.iteration_stage, scene, (),
                                          scalars, static)
    return img, overflow, rays


def render_params(scene: SceneData, params: Params, iteration: int,
                  algorithm: str, res_x: int, res_y: int, **kw):
    """One iteration of the given algorithm with params substituted ->
    image [resY, resX, 3], differentiable in ``params``. ``kw`` are
    :class:`_Options`' fields: the seed, path lengths, radius and the
    merge caps (pair, photon and query factors of the paths), exposed so
    inverse rendering at larger resolutions can take the caps a render
    measured (render.py, :func:`fit_caps`) instead of the defaults."""
    o = _Options(**kw)
    s = apply_params(scene, params)
    return _render(s, _scalars(s, iteration, algorithm, res_x, res_y, o),
                   algorithm, res_x, res_y, o)[0]


def fit_caps(scene: SceneData, params: Params, algorithm: str, res_x: int,
             res_y: int, **kw) -> dict:
    """The pair merge's caps for gradient steps at ``params`` -> the
    keywords ``pair_factor``, ``photon_factor`` and ``query_factor`` of
    :func:`loss_and_grad` ({} for pt, which does not merge): render.py's
    measurement of iteration 0 under ``kw``'s ``base_seed``
    (``render.measure_merge_caps``, the span ``render.caps_measure``),
    at these parameters and not the cache's. ``kw`` are
    :class:`_Options`' fields (its caps are not read)."""
    from . import render as R

    if algorithm == "pt" or not R._VCM_FLAGS[algorithm][1]:
        return {}
    o = _Options(**kw)
    cfg = R.RenderConfig(
        algorithm=algorithm, resolution=(res_x, res_y),
        base_seed=o.base_seed, max_path_length=o.max_path_length,
        min_path_length=o.min_path_length, radius_factor=o.radius_factor,
        radius_alpha=o.radius_alpha, merge_backend="xla")
    with trace.span("render.caps_measure", how="measured"):
        return R.measure_merge_caps(apply_params(scene, params), cfg,
                                    algorithm)


def _device_count(counts: dict, device) -> torch.Tensor:
    """``counts``' 0-dim int64 tensor on ``device``, made at first use."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    count = counts.get(dev)
    if count is None:
        count = counts[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return count


def truncated_steps(device) -> torch.Tensor:
    """The gradient steps on ``device`` whose pair merge truncated at its
    caps, counted on the device: a 0-dim int64 tensor that every step
    adds to, for the caller to read with what it reads anyway (a block's
    one host read), not once a step. A truncated step's pairs past a cap
    are dropped, as the JAX package drops them; :func:`fit_caps` sizes
    the caps."""
    return _device_count(_TRUNCATED, device)


def traced_rays(device) -> torch.Tensor:
    """The rays the gradient steps on ``device`` traced in their forward
    passes (path segments and shadow rays, as ``render`` counts them),
    counted on the device as :func:`truncated_steps` is. The checkpoint's
    recomputation traces them again and is not counted."""
    return _device_count(_RAYS, device)


_TRUNCATED: dict = {}
_RAYS: dict = {}
# The stamps a step holds back: the stages' own, which the checkpoint's
# recomputation would stamp twice (trace.GRAD_STAGES are the step's).
_INNER_STAMPS = tuple(n for n in trace.SLOT_NAMES
                      if n not in trace.GRAD_STAGES)


def _step(scene: SceneData, leaves: tuple, target, *args):
    """One gradient step as a stage (graphs.stage): ``leaves`` are the
    parameters' values, ``args`` each iteration's :func:`_scalars`, then
    the static algorithm, res_x, res_y, n_iterations and :class:`_Options`
    -> one flat tensor [loss, every leaf's gradient], with no host read,
    so that on a card the whole step is one CUDA graph: the forward, the
    loss, the checkpoint's recomputation and the backward. Adds the step
    to :func:`truncated_steps` if a pair merge of it overflowed, and its
    forward's rays to :func:`traced_rays`."""
    *scalars, algorithm, res_x, res_y, n_iterations, o = args
    per = len(scalars) // n_iterations
    dev = scene.device
    with torch.enable_grad():
        ls = [t.detach().requires_grad_(True) for t in leaves]

        def one(i, *ls):
            return _render(apply_params(scene, _unflatten(ls)),
                           tuple(scalars[i * per:(i + 1) * per]),
                           algorithm, res_x, res_y, o)

        trace.stamp("start", scalars[0])
        with trace.paused(*_INNER_STAMPS):
            img, overflow, rays = None, None, 0
            for i in range(n_iterations):
                part, ovf, r = checkpoint(one, i, *ls, use_reentrant=False,
                                          preserve_rng_state=False)
                img = part if img is None else img + part
                rays = rays + r
                if ovf is not None:
                    overflow = ovf if overflow is None else overflow + ovf
            img = img / n_iterations
            loss = torch.mean((img - target) ** 2)
            trace.stamp("grad_forward")
            grads = torch.autograd.grad(loss, ls, allow_unused=True)
            trace.stamp("grad_backward")
    if overflow is not None:
        truncated_steps(dev).add_((overflow > 0).long())
    traced_rays(dev).add_(rays)
    return torch.cat([loss.detach().reshape(1),
                      *((torch.zeros_like(t) if g is None else g).reshape(-1)
                        for t, g in zip(ls, grads))])


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
    (loss scalar tensor, gradient Params), fresh tensors of the caller's.

    ``kw`` are :func:`render_params`' keywords (the merge caps among
    them; :func:`fit_caps` measures them). Averages ``n_iterations``
    stochastic iterations before the loss. Each iteration runs under
    ``torch.utils.checkpoint`` (``jax.checkpoint`` in the JAX package):
    its activations are dropped after the forward and recomputed in the
    backward, so memory holds one iteration's graph at a time. The
    counter-based RNG makes the recomputation exact, and no torch RNG
    state is kept.

    The step is one stage of graphs.py (:func:`_step`), keyed by the
    scene, the shapes of the parameters and target, and the algorithm,
    size and keywords: on a card its first call runs eagerly, the second
    captures it as one CUDA graph and later calls replay it, the
    parameters, target and iteration scalars copied into the graph's
    buffers first (a handful of host calls, no host read); on the CPU,
    in ``graphs.eager()`` and where the scene needs a gradient itself it
    runs eagerly, with the same bits. A pair merge that truncates at its
    caps is counted in :func:`truncated_steps`, not retried. Counters
    ``diff.steps`` and ``diff.step_replays`` (trace.py).
    """
    o = _Options(**kw)
    leaves = tuple(t.detach() for t in _leaves(params))
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=scene.device).detach()
    scalars = tuple(v for i in range(n_iterations) for v in _scalars(
        scene, iteration * n_iterations + i, algorithm, res_x, res_y, o))
    replays = graphs.stage.replays
    flat = graphs.stage(_step, scene, (leaves, target), scalars,
                        (algorithm, res_x, res_y, n_iterations, o))
    _COUNTS["diff.steps"] += 1
    _COUNTS["diff.step_replays"] += graphs.stage.replays - replays
    flat = flat.clone()
    grads = flat[1:].split([t.numel() for t in leaves])
    return flat[0], _unflatten([g.view(t.shape)
                                for g, t in zip(grads, leaves)])


# The gradient steps taken, and those that were a graph's replay.
_COUNTS = {"diff.steps": 0, "diff.step_replays": 0}


def _report() -> dict:
    return {**_COUNTS, "diff.truncated_steps": sum(
        int(t) for t in _TRUNCATED.values())}


trace.report_counters("diff", _report)


def sharded_loss_and_grad(
    group,
    scene: SceneData,
    params: Params,
    target,
    iteration: int,
    algorithm: str,
    res_x: int,
    res_y: int,
    n_iterations: int = 1,
    vm_exchange: str = "allgather",
    pair_factor: float = 24.0,
    photon_factor: float = 3.0,
    query_factor: float = 3.0,
    **kw,
):
    """``loss_and_grad`` with paths sharded over ``group`` -> (loss, gradient
    Params), both replicated on every rank; every rank of the group calls
    it with the same arguments.

    Port of the JAX package's ``sharded_loss_and_grad`` (mesh -> group).
    The forward pass is the sharded render (light vertices all-gathered or
    ring-exchanged for merging through the pair merge, the framebuffer
    summed over ranks; the pair merge at the caps of the three factors
    over each rank's paths); each rank differentiates the replicated loss
    through its own paths, the collectives' backward rules carry the
    photons' gradients to the ranks that own them (parallel/comm.py), and
    the ranks' partial parameter gradients are summed once, here. With
    ``n_iterations > 1`` each iteration is recomputed in the backward
    (``torch.utils.checkpoint``) in full, never stopped early, so every
    rank re-issues the same collectives in the same order.
    """
    from .parallel import comm, sharding
    from .render import _VCM_FLAGS

    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]

    def one(i, *ls):
        s = apply_params(scene, _unflatten(ls))
        it = iteration * n_iterations + i
        if algorithm in ("el", "pt"):
            img, _ = sharding.sharded_simple_iteration(
                group, algorithm, s, it, res_x, res_y, **kw)
            return img
        use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[algorithm]
        return sharding.sharded_render_iteration(
            group, s, it, res_x, res_y, use_vc=use_vc, use_vm=use_vm,
            light_trace_only=lt_only, ppm=ppm, vm_exchange=vm_exchange,
            merge_backend="xla", pair_factor=pair_factor,
            photon_factor=photon_factor, query_factor=query_factor, **kw)

    img = None
    with set_checkpoint_early_stop(False):
        for i in range(n_iterations):
            part = (checkpoint(one, i, *leaves, use_reentrant=False)
                    if n_iterations > 1 else one(i, *leaves))
            img = part if img is None else img + part
    img = img / n_iterations
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    # One collective for every leaf: the ranks' partial gradients summed.
    total = comm.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                group)
    parts = total.split([g.numel() for g in grads])
    return loss.detach(), _unflatten([t.reshape(g.shape)
                                      for t, g in zip(parts, grads)])
