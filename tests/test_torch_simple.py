"""PyTorch port vs the JAX package: eye light (el) and path tracing (pt).

One iteration of each at 16x16 on the CPU, port against
``eyelight.render_iteration`` / ``pathtracer.render_iteration``.
Tolerance (the slice test's): rtol 1e-4 / atol 1e-6 on at least 99% of
pixels and the image mean to 1e-4 relative. The pixel allowance covers
1-ulp differences between XLA's and torch's rounding of camera rays and
transcendentals, which move grazing |cos| values (el) or flip a
Russian-roulette or lobe decision (pt).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from smallvcm_tpu.algorithms import eyelight as jel
from smallvcm_tpu.algorithms import pathtracer as jpt
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import eyelight as tel
from smallvcm_tpu_torch.algorithms import pathtracer as tpt
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_torch_slice import assert_image_close

torch.set_num_threads(2)

RES = 16


@pytest.mark.parametrize("iteration", [0, 1])
def test_eyelight_matches_jax(iteration):
    """Iteration 1 samples pixel centres (the reference quirk), others
    jitter: both forms are held against JAX."""
    want = np.asarray(jel.render_iteration(
        jload((RES, RES), SCENE_CONFIGS[1]), iteration, RES, RES))
    got, rays = tel.render_iteration(
        tload((RES, RES), SCENE_CONFIGS[1], device="cpu"), iteration, RES,
        RES)
    assert int(rays) == RES * RES
    assert_image_close(got, want)


def test_eyelight_centre_quirk():
    scene = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    it1, _ = tel.render_iteration(scene, 1, RES, RES)
    it3, _ = tel.render_iteration(scene, 3, RES, RES, base_seed=99)
    again, _ = tel.render_iteration(scene, 1, RES, RES, base_seed=99)
    assert torch.equal(it1, again)        # centres: the seed plays no part
    assert not torch.equal(it1, it3)


@pytest.mark.parametrize("scene_id,kw", [
    (0, {}),
    (3, {}),                               # background light
    (0, dict(max_path_length=1)),
    (1, dict(max_path_length=1)),          # directly visible area light
    (1, dict(min_path_length=2)),
    (3, dict(min_path_length=2)),
    (0, dict(rng_kind="tea")),
])
def test_pathtracer_matches_jax(scene_id, kw):
    want = np.asarray(jpt.render_iteration(
        jload((RES, RES), SCENE_CONFIGS[scene_id]), 0, RES, RES, **kw))
    got, rays = tpt.render_iteration(
        tload((RES, RES), SCENE_CONFIGS[scene_id], device="cpu"), 0, RES,
        RES, **kw)
    if want.mean() == 0.0:   # nothing reaches the camera in one segment
        assert float(got.abs().max()) == 0.0
    else:
        assert_image_close(got, want)
    assert int(rays) >= RES * RES


def test_render_el_pt_through_render_loop():
    """render() averages el/pt iterations like the other algorithms."""
    scene = tload((8, 8), SCENE_CONFIGS[1], device="cpu")
    for alg in ("el", "pt"):
        cfg = R.RenderConfig(algorithm=alg, iterations=3, resolution=(8, 8))
        img, _, done, rays = R.render(scene, cfg)
        want = sum(R.render_single_iteration(scene, cfg, i)
                   for i in range(3)) / 3
        assert done == 3 and rays > 0
        torch.testing.assert_close(img, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("alg", ["el", "pt"])
def test_matches_golden_image(alg):
    """The port against the JAX images in tests/data (scene 0, 32x32,
    2 iterations; scripts/make_torch_golden.py); needs no JAX."""
    data = np.load(Path(__file__).parent / "data"
                   / f"torch_golden_{alg}_s0_32.npz")
    c = json.loads(str(data["config"]))
    res = tuple(c["resolution"])
    cfg = R.RenderConfig(
        algorithm=c["algorithm"], iterations=c["iterations"], resolution=res,
        base_seed=c["base_seed"], max_path_length=c["max_path_length"],
        min_path_length=c["min_path_length"],
    )
    img, _, _, _ = R.render(
        tload(res, SCENE_CONFIGS[c["scene_id"]], device="cpu"), cfg)
    assert_image_close(img, data["image"])
