"""VCM on the ``--report`` scene 1 (glossy floor, large mirror sphere,
ceiling area light; the cell ``vcm.s1.512``) on the CPU at 16x16: the
port's iteration and a block of its progressive render against the
benchmark's plain reference (benchmark/reference/compute.py), and camera
paths that reach the emitter, directly or through the mirror.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scene1.py -q
"""

import json

import pytest
import torch

from benchmark.drivers import _progressive as P
from benchmark.harness import env
from benchmark.reference import compute
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

torch.set_num_threads(2)

RES = 16
SEED = 2 ** 31 + 5003          # the renderer keys on its low 32 bits
BASE = SEED & 0xFFFFFFFF


@pytest.fixture(autouse=True)
def caps_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("SMALLVCM_TPU_TORCH_CACHE", str(tmp_path / "caps"))


def _config() -> dict:
    path = env.ROOT / "benchmark" / "configs" / "vcm_cornell1_512.json"
    config = json.loads(path.read_text())
    assert config["scene_mask"] == SCENE_CONFIGS[1]
    config["resolution"] = [RES, RES]
    return config


def _scene(config):
    return load_cornell_box((RES, RES), config["scene_mask"], device="cpu")


@pytest.mark.parametrize("start,k", [(3, 1), (0, 2)],
                         ids=["iteration", "block_of_2"])
def test_the_port_equals_the_plain_reference_on_scene_1(start, k):
    """One iteration (``render_single_iteration``) and a block of two
    through ``render.render`` as ``benchmark/drivers/render_blocks.py``
    calls it."""
    config = _config()
    cfg = P.render_config(R, config, BASE)
    if k == 1:
        got = R.render_single_iteration(_scene(config), cfg, start)
    else:
        prog = P.Progressive(R, _scene(config), cfg)
        prog.block(k)
        got = prog.accum
    want = compute.block_sum(config, BASE, start, k, "cpu")
    assert float(want.abs().sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_camera_paths_hit_the_area_light_on_scene_1(monkeypatch):
    """The camera walk's hit-light branch (vertexcm.hxx:468-479) adds
    radiance on scene 1, at path length 1 (the light seen directly) and
    beyond (through the mirror and the floor)."""
    config = _config()
    scene = _scene(config)
    assert int(scene.background_idx) < 0     # every call is a surface hit
    seen = {}
    real = vcm.get_light_radiance_weighted

    def spy(scene, state, light_id, ray_dir, path_length, *args):
        out = real(scene, state, light_id, ray_dir, path_length, *args)
        lit = (state.alive & (light_id >= 0)
               & ((out.x > 0) | (out.y > 0) | (out.z > 0)))
        seen[path_length] = seen.get(path_length, 0) + int(lit.sum())
        return out

    monkeypatch.setattr(vcm, "get_light_radiance_weighted", spy)
    image = R.render_single_iteration(scene, P.render_config(R, config,
                                                             BASE), 1)
    assert float(image.abs().sum()) > 0
    assert seen.get(1, 0) > 0
    assert sum(n for length, n in seen.items() if length > 1) > 0
