"""Rendering: algorithm registry, the progressive loop, time budget.

Port of ``smallvcm_tpu/render.py`` (the reference's ``CreateRenderer``
factory, config.hxx:112-143, and ``render()`` loop, smallvcm.cxx:52-151)
for all seven algorithms. On a card each trace stage of an iteration runs
as one device program, a CUDA graph (graphs.py): the light walk and the
camera stage of the VCM family, the whole pass of pt and el. The merge,
the light splat flush and the framebuffer accumulation run eagerly between
them, because they size their work from live counts read on the host.
That host read is why one iteration stays the unit of work: no blocks of
iterations (``--block`` has no effect), no static merge caps and no
grow-and-retry.

With ``RenderConfig.group`` (the JAX package's ``mesh``), every rank of the
group runs :func:`render` with the same configuration: each renders its
path shard (parallel/sharding.py) and holds the summed image. Under a time
budget rank 0 decides each step and broadcasts it, so every rank runs the
same number of iterations; only rank 0 prints.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .algorithms import eyelight, pathtracer, vcm
from .io.framebuffer import total_luminance
from .parallel import comm, sharding
from .parallel.multihost import is_coordinator
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
    # Photon merge: "auto"/"pallas" = the cell merge (the Hopper kernel on
    # CUDA, its plain version on the CPU); "xla" = the differentiable
    # pair-expansion merge (algorithms/vcm.py::merge_stage).
    merge_backend: str = "auto"
    # Closest-hit sweep: "auto"/"pallas" = the Hopper kernel on CUDA, the
    # dense plain sweep on the CPU; "xla" names the dense sweep, which is
    # the kernel's test reference and is never substituted for it on a
    # card: on CUDA it raises.
    trace_backend: str = "auto"
    # Accepted for the JAX package's CLI and configs; has no effect: an
    # iteration's merge reads its live counts on the host between the
    # graphs of its trace stages, so the port renders one iteration a step.
    block_size: int = 0
    # Photon exchange between ranks for merging: "allgather" or "ring"
    # (parallel/sharding.py); unused by a single process.
    vm_exchange: str = "allgather"
    # torch.distributed process group whose ranks share the paths
    # (parallel/multihost.py); None renders every path in this process.
    group: object = None


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
    """One iteration of the resolved algorithm -> (image, ray_count); with
    ``cfg.group``, this rank's shard, summed over the group's ranks. On a
    card el's and pt's image and count are their graph's outputs, which
    the next iteration overwrites: clone what you keep."""
    res_x, res_y = cfg.resolution
    if cfg.group is not None:
        if alg in ("el", "pt"):
            return sharding.sharded_simple_iteration(
                cfg.group, alg, scene, iteration, res_x, res_y,
                cfg.base_seed, cfg.max_path_length, cfg.min_path_length,
                cfg.rng_kind)
        use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
        img, rays, _ = sharding.sharded_render_iteration_with_stats(
            cfg.group, scene, iteration, res_x, res_y, cfg.base_seed,
            cfg.max_path_length, cfg.min_path_length, cfg.radius_factor,
            cfg.radius_alpha, use_vc, use_vm, lt_only, ppm, cfg.vm_exchange,
            cfg.rng_kind, cfg.merge_backend)
        return img, rays
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
    """The image of one iteration (not averaged) of ``cfg.algorithm``, a
    tensor of its own (never a graph's output)."""
    check_backends(scene, cfg)
    img, _ = render_iteration(scene, cfg,
                              resolve_algorithm(scene, cfg.algorithm),
                              iteration)
    return img.clone()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _maybe_inject_test_fault(done: int) -> None:
    """Test hook for the isolate.py supervisor (tests/test_torch_isolate.py).

    With SMALLVCM_TEST_FAULT_AT=k set, raises a CUDA-fault-shaped error
    once ``done`` reaches k, at most SMALLVCM_TEST_FAULT_TIMES times across
    processes, counted in the SMALLVCM_TEST_FAULT_COUNTER file, so a
    supervised run faults, respawns from its checkpoint, and must still
    produce the byte-identical image (the JAX package's hook,
    smallvcm_tpu/render.py:496-519).
    """
    at = os.environ.get("SMALLVCM_TEST_FAULT_AT")
    if not at or done < int(at):
        return
    times = int(os.environ.get("SMALLVCM_TEST_FAULT_TIMES", "1"))
    path = os.environ.get("SMALLVCM_TEST_FAULT_COUNTER")
    count = 0
    if path and os.path.exists(path):
        count = int(Path(path).read_text() or 0)
    if count >= times:
        return
    if path:
        Path(path).write_text(str(count + 1))
    raise RuntimeError("CUDA error: injected test fault "
                       "(SMALLVCM_TEST_FAULT_AT)")


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
    device, so its time is the iteration's). With ``cfg.group``, every
    rank of the group must call this with the same ``cfg``.
    """
    check_backends(scene, cfg)
    res_x, res_y = cfg.resolution
    alg = resolve_algorithm(scene, cfg.algorithm)
    dev = scene.device
    accum = (torch.zeros((res_y, res_x, 3), dtype=torch.float32, device=dev)
             if accum is None else accum.to(dev))
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    done = start_iter
    verbose = verbose and is_coordinator()
    # Test-only fault injection (tests/test_torch_isolate.py), resolved once.
    fault_hook = (_maybe_inject_test_fault
                  if os.environ.get("SMALLVCM_TEST_FAULT_AT") else None)

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
        if fault_hook is not None:
            fault_hook(done)

    def in_budget() -> bool:
        # Each rank's clock would give its own iteration count and hang
        # the collectives: rank 0's clock decides for the group.
        go = time.perf_counter() - start < cfg.max_time
        if cfg.group is None:
            return go
        return comm.broadcast_flag(go, cfg.group)

    _sync(dev)
    start = time.perf_counter()
    if cfg.max_time > 0:
        while in_budget():
            step()
            _sync(dev)  # the budget is wall time of finished iterations
    else:
        while done < cfg.iterations:
            step()
    _sync(dev)
    elapsed = time.perf_counter() - start

    img = accum / done if done > 0 else accum
    return img, elapsed, done, int(rays)
