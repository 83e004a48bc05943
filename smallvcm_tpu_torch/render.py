"""Rendering: algorithm registry, the progressive loop, time budget.

Port of ``smallvcm_tpu/render.py`` (the reference's ``CreateRenderer``
factory, config.hxx:112-143, and ``render()`` loop, smallvcm.cxx:52-151)
for all seven algorithms. PyTorch runs eagerly, so one iteration is one
unit of work: no blocks of iterations, no static merge caps (the merges
size their compaction from the live counts) and no grow-and-retry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .algorithms import eyelight, pathtracer, vcm
from .io.framebuffer import total_luminance
from .scene.scene import SceneData

ALGORITHMS = ("el", "pt", "lt", "ppm", "bpm", "bpt", "vcm")

ALGORITHM_NAMES = {
    "el": "eye light",
    "pt": "path tracing",
    "lt": "light tracing",
    "ppm": "progressive photon mapping",
    "bpm": "bidirectional photon mapping",
    "bpt": "bidirectional path tracing",
    "vcm": "vertex connection and merging",
}

# VertexCM family flags: (use_vc, use_vm, light_trace_only, ppm)
# (vertexcm.hxx:222-244).
_VCM_FLAGS = {
    "lt": (False, False, True, False),
    "ppm": (False, True, False, True),
    "bpm": (False, True, False, False),
    "bpt": (True, False, False, False),
    "vcm": (True, True, False, False),
}

TRACE_BACKENDS = ("auto", "pallas", "xla")


@dataclass
class RenderConfig:
    """Mirror of the reference Config (config.hxx:52-109) plus the JAX
    package's backend knobs, with the same names and defaults."""

    algorithm: str = "vcm"
    iterations: int = 1
    max_time: float = -1.0
    radius_factor: float = 0.003
    radius_alpha: float = 0.75
    base_seed: int = 1234
    max_path_length: int = 10
    min_path_length: int = 0
    resolution: tuple = (512, 512)
    rng_kind: str = "threefry"  # or "tea" (the reference's old_rng flavor)
    # Photon merge: "auto"/"pallas" = the tile merge (the Hopper kernel on
    # CUDA, its plain version on the CPU); "xla" = the differentiable
    # pair-expansion merge (algorithms/vcm.py::merge_stage).
    merge_backend: str = "auto"
    # Closest-hit sweep: "auto"/"pallas" = the Hopper kernel on CUDA, the
    # dense plain sweep on the CPU; "xla" names the dense sweep, which is
    # the kernel's test reference and is never substituted for it on a
    # card: on CUDA it raises.
    trace_backend: str = "auto"
    # Accepted for the JAX package's CLI and configs; has no effect: the
    # eager port renders one iteration per step.
    block_size: int = 0


def ppm_downgrade_needed(scene: SceneData) -> bool:
    """PPM cannot handle mixed specular+non-specular materials; the reference
    self-downgrades to BPM after scanning the scene (vertexcm.hxx:246-278)."""
    mats = scene.materials
    host = lambda a: a.detach().cpu().numpy()
    diffuse = host(mats.diffuse.max_component())
    phong = host(mats.phong.max_component())
    mirror = host(mats.mirror.max_component())
    ior = host(mats.ior)
    has_non_specular = (diffuse > 0) | (phong > 0)
    has_specular = (mirror > 0) | (ior > 0)
    return bool(np.any(has_non_specular & has_specular))


def resolve_algorithm(scene: SceneData, algorithm: str) -> str:
    if algorithm == "ppm" and ppm_downgrade_needed(scene):
        return "bpm"
    return algorithm


def check_backends(scene: SceneData, cfg: RenderConfig) -> None:
    """Reject trace backends the port does not know, and the dense sweep
    on a card: it is the sweep kernel's reference, not a fallback (merge
    backends are checked by vcm.render_iteration)."""
    if cfg.trace_backend not in TRACE_BACKENDS:
        raise ValueError(f"trace_backend must be one of {TRACE_BACKENDS}, "
                         f"not {cfg.trace_backend!r}")
    if cfg.trace_backend == "xla" and scene.device.type == "cuda":
        raise ValueError(
            "trace_backend 'xla' (the dense plain sweep) does not run on a "
            "CUDA device: the sweep kernel traces every ray there; use "
            "'auto' or 'pallas'")


def render_iteration(scene: SceneData, cfg: RenderConfig, alg: str,
                     iteration: int):
    """One iteration of the resolved algorithm -> (image, ray_count)."""
    res_x, res_y = cfg.resolution
    if alg == "el":
        return eyelight.render_iteration(
            scene, iteration, res_x, res_y, cfg.base_seed, cfg.rng_kind)
    if alg == "pt":
        return pathtracer.render_iteration(
            scene, iteration, res_x, res_y, cfg.base_seed,
            cfg.max_path_length, cfg.min_path_length, cfg.rng_kind)
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    return vcm.render_iteration(
        scene, iteration, res_x, res_y, cfg.base_seed, cfg.max_path_length,
        cfg.min_path_length, cfg.radius_factor, cfg.radius_alpha,
        use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only, ppm=ppm,
        rng_kind=cfg.rng_kind, merge_backend=cfg.merge_backend,
    )


def render_single_iteration(scene: SceneData, cfg: RenderConfig,
                            iteration: int):
    """The image of one iteration (not averaged) of ``cfg.algorithm``."""
    check_backends(scene, cfg)
    img, _ = render_iteration(scene, cfg,
                              resolve_algorithm(scene, cfg.algorithm),
                              iteration)
    return img


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render(scene: SceneData, cfg: RenderConfig, verbose: bool = False,
           accum=None, start_iter: int = 0, block_cb=None):
    """Progressive render on the scene's device.

    Returns (image [resY, resX, 3], seconds, iterations, rays). Like
    smallvcm.cxx:52-151: -t (max_time) takes precedence over -i; the image
    is the average over completed iterations. ``accum`` / ``start_iter``
    resume a previous accumulation (checkpoint.py): iterations continue at
    ``start_iter`` and ``iterations`` counts them all, resumed prefix
    included. ``block_cb(accum, iterations_done)`` fires after every
    iteration (the checkpoint hook). ``rays`` is the traced ray count of
    this call. With ``verbose``, prints one line per iteration: mean
    luminance, image mean, rays and wall time (each line waits for the
    device, so its time is the iteration's).
    """
    check_backends(scene, cfg)
    res_x, res_y = cfg.resolution
    alg = resolve_algorithm(scene, cfg.algorithm)
    dev = scene.device
    accum = (torch.zeros((res_y, res_x, 3), dtype=torch.float32, device=dev)
             if accum is None else accum.to(dev))
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    done = start_iter

    def step():
        nonlocal accum, rays, done
        t0 = time.perf_counter()
        img, r = render_iteration(scene, cfg, alg, done)
        accum = accum + img
        rays = rays + r
        done += 1
        if verbose:
            lum = float(total_luminance(accum)) / done
            mean = float(accum.mean()) / done
            _sync(dev)
            print(f"  iter {done - 1}: luminance={lum:.1f} mean={mean:.9g} "
                  f"rays={int(r)} dt={time.perf_counter() - t0:.4f}s",
                  flush=True)
        if block_cb is not None:
            block_cb(accum, done)

    _sync(dev)
    start = time.perf_counter()
    if cfg.max_time > 0:
        while time.perf_counter() - start < cfg.max_time:
            step()
            _sync(dev)  # the budget is wall time of finished iterations
    else:
        while done < cfg.iterations:
            step()
    _sync(dev)
    elapsed = time.perf_counter() - start

    img = accum / done if done > 0 else accum
    return img, elapsed, done, int(rays)
