"""Eye-light debug integrator (eyelight.hxx:47-78), wavefront form.

Port of ``smallvcm_tpu/algorithms/eyelight.py``: generate every primary
ray, one closest-hit sweep, shade |dot(N, -d)| (red on back faces), add to
each path's own pixel. On a card the pass (:func:`render_pass`) runs as one
CUDA graph (graphs.py).
"""

from __future__ import annotations

import torch

from .. import graphs
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
    """One eye-light pass -> (image [resY, resX, 3], ray_count):
    :func:`render_core` over ``arange(res_x * res_y)``."""
    pix = torch.arange(res_x * res_y, dtype=torch.int64, device=scene.device)
    return render_core(scene, iteration, pix, res_x, res_y, base_seed,
                       rng_kind)


def render_core(
    scene: SceneData, iteration: int, pix, res_x: int, res_y: int,
    base_seed: int = 1234, rng_kind: str = "threefry",
):
    """One eye-light pass over the global pixel ids ``pix`` -> (full-frame
    image [resY, resX, 3] holding those pixels, ray_count).

    Reference quirk preserved: iteration 1 (the second pass;
    smallvcm.cxx:100 starts at 0) samples pixel centres, every other
    iteration jitters (eyelight.hxx:59-60). One primary ray per pixel.
    :func:`render_pass` as one graph (graphs.stage), as in
    pathtracer.render_core.
    """
    return graphs.stage(render_pass, scene, (pix,), (iteration,),
                        (res_x, res_y, base_seed, rng_kind))


def render_pass(scene: SceneData, pix, iteration, res_x: int, res_y: int,
                base_seed: int, rng_kind: str):
    """The body of :func:`render_core`, with the iteration a 0-dim int64
    device tensor: the centre-sample branch is a select on the device, as
    in the JAX package, so one capture serves every iteration."""
    dev = scene.device
    n = pix.shape[0]
    x = torch.remainder(pix, res_x).to(torch.float32)
    y = torch.div(pix, res_x, rounding_mode="floor").to(torch.float32)

    jitter = rng.uniform_slots(
        base_seed, rng.make_stream(iteration, rng.STAGE_CAMERA_JITTER), pix,
        2, rng_kind,
    )
    centred = iteration == 1
    jx = torch.where(centred, 0.5, jitter[:, 0])
    jy = torch.where(centred, 0.5, jitter[:, 1])

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
    return fb.to_array(), torch.full((), n, dtype=torch.int64, device=dev)
