"""Eye-light debug integrator (eyelight.hxx:47-78), wavefront form.

Port of ``smallvcm_tpu/algorithms/eyelight.py``: generate every primary
ray, one closest-hit sweep, shade |dot(N, -d)| (red on back faces), add to
each path's own pixel.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.vec3 import V3, dot
from ..io.framebuffer import add_color_at_pix, new_fb_planes
from ..ops.intersect import intersect
from ..scene.camera import generate_ray
from ..scene.scene import SceneData


def render_iteration(
    scene: SceneData, iteration: int, res_x: int, res_y: int,
    base_seed: int = 1234, rng_kind: str = "threefry",
):
    """One eye-light pass -> (image [resY, resX, 3], ray_count).

    Reference quirk preserved: iteration 1 (the second pass;
    smallvcm.cxx:100 starts at 0) samples pixel centres, every other
    iteration jitters (eyelight.hxx:59-60). One primary ray per pixel.
    """
    dev = scene.device
    n = res_x * res_y
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    x = torch.remainder(pix, res_x).to(torch.float32)
    y = torch.div(pix, res_x, rounding_mode="floor").to(torch.float32)

    if iteration == 1:
        jx = jy = 0.5
    else:
        jitter = rng.uniform_slots(
            base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_JITTER),
            pix, 2, rng_kind,
        )
        jx, jy = jitter[:, 0], jitter[:, 1]

    org, d = generate_ray(scene.camera, x + jx, y + jy)
    hit = intersect(scene, org, d)

    dot_ln = dot(hit.normal, -d)
    front = dot_ln > 0
    lit = hit.hit.to(torch.float32)
    color = V3(
        torch.abs(dot_ln) * lit,
        torch.where(front, dot_ln, 0.0) * lit,
        torch.where(front, dot_ln, 0.0) * lit,
    )
    # Own-pixel accumulate: floor(x + jitter) == x (jitter in [0, 1)).
    fb = add_color_at_pix(new_fb_planes(res_x, res_y, dev), pix, color)
    return fb.to_array(), torch.tensor(n, dtype=torch.int64, device=dev)
