"""The reference's answers: the images the benchmark judges the program
by, from the configuration's file, the seed and the iteration indices
alone (svcm/ is the frozen plain copy of the port).

``dtype`` is the precision the arithmetic ends in: float32 is the
reference; bfloat16 is the control (every iteration's image and the running
sum rounded to bfloat16), which the checks must refuse.
"""

from __future__ import annotations

import torch

from .svcm.algorithms import pathtracer, vcm
from .svcm.render import _VCM_FLAGS
from .svcm.scene.scene import load_cornell_box


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_scene(config: dict, device):
    """The configuration's scene, built on ``device`` by the copy."""
    res_x, res_y = config["resolution"]
    return load_cornell_box((res_x, res_y), config["scene_mask"],
                            device=device)


def iteration_image(scene, config: dict, base_seed: int, iteration: int):
    """One iteration's image [resY, resX, 3] float32, stage by stage with
    the plain sweeps and the plain cell merge (no caps)."""
    res_x, res_y = config["resolution"]
    alg = config["algorithm"]
    common = dict(base_seed=base_seed,
                  max_path_length=config["max_path_length"],
                  min_path_length=config["min_path_length"],
                  rng_kind=config["rng"])
    if alg == "pt":
        return pathtracer.render_iteration(scene, iteration, res_x, res_y,
                                           **common)[0]
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    return vcm.render_iteration(
        scene, iteration, res_x, res_y, radius_factor=config["radius_factor"],
        radius_alpha=config["radius_alpha"], use_vc=use_vc, use_vm=use_vm,
        light_trace_only=lt_only, ppm=ppm, **common)[0]


@torch.no_grad()
def block_sum(config: dict, base_seed: int, start: int, k: int, device,
              dtype=torch.float32, scene=None):
    """The sum of iterations ``start`` .. ``start + k - 1``, added one by
    one from zeros in ``dtype`` -> float32 [resY, resX, 3]."""
    _no_tf32()
    scene = build_scene(config, device) if scene is None else scene
    res_x, res_y = config["resolution"]
    acc = torch.zeros((res_y, res_x, 3), dtype=dtype, device=device)
    for it in range(start, start + k):
        acc = acc + iteration_image(scene, config, base_seed, it).to(dtype)
    return acc.float()
