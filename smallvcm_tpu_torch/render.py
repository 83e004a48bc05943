"""Rendering: algorithm flags, the progressive loop, time budget.

Port of ``smallvcm_tpu/render.py`` (the reference's ``CreateRenderer``
factory, config.hxx:112-143, and ``render()`` loop, smallvcm.cxx:52-151)
for the VertexCM family. PyTorch runs eagerly, so one iteration is one
unit of work: no blocks of iterations, no static merge caps (ops/merge.py
sizes them from the live counts) and no grow-and-retry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .algorithms import vcm
from .io.framebuffer import total_luminance
from .scene.scene import SceneData

ALGORITHMS = ("lt", "ppm", "bpm", "bpt", "vcm")

ALGORITHM_NAMES = {
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


@dataclass
class RenderConfig:
    """Mirror of the reference Config (config.hxx:52-109)."""

    algorithm: str = "vcm"
    iterations: int = 1
    max_time: float = -1.0
    radius_factor: float = 0.003
    radius_alpha: float = 0.75
    base_seed: int = 1234
    max_path_length: int = 10
    min_path_length: int = 0
    resolution: tuple = (512, 512)


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


def render_iteration(scene: SceneData, cfg: RenderConfig, alg: str,
                     iteration: int):
    """One iteration of the resolved algorithm -> (image, ray_count)."""
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    res_x, res_y = cfg.resolution
    return vcm.render_iteration(
        scene, iteration, res_x, res_y, cfg.base_seed, cfg.max_path_length,
        cfg.min_path_length, cfg.radius_factor, cfg.radius_alpha,
        use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only, ppm=ppm,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render(scene: SceneData, cfg: RenderConfig, verbose: bool = False):
    """Progressive render on the scene's device.

    Returns (image [resY, resX, 3], seconds, iterations, rays). Like
    smallvcm.cxx:52-151: -t (max_time) takes precedence over -i; the image
    is the average over completed iterations and ``rays`` the total traced
    ray count. With ``verbose``, prints one line per iteration: mean
    luminance, image mean, rays and wall time (each line waits for the
    device, so its time is the iteration's).
    """
    res_x, res_y = cfg.resolution
    alg = resolve_algorithm(scene, cfg.algorithm)
    dev = scene.device
    accum = torch.zeros((res_y, res_x, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0

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
