"""PyTorch port vs the JAX package: scene build, scene conversion, camera.

Every leaf of the port's ``SceneData`` must equal the JAX package's for
all four report scenes, both from the port's own numpy builder and from
``convert.scene_from_numpy`` (the JAX leaves carried across as numpy).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smallvcm_tpu.scene import camera as jcam
from smallvcm_tpu.scene.scene import SCENE_CONFIGS, get_scene_name
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch.convert import scene_from_numpy
from smallvcm_tpu_torch.scene import camera as tcam
from smallvcm_tpu_torch.scene import scene as tscene
from smallvcm_tpu_torch.scene.scene import SceneData
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_torch_core import close, jv, t, tv

torch.set_num_threads(2)


def _leaves(scene):
    """(path, array) pairs of a scene in field order, numpy on the host."""
    out = []

    def walk(prefix, node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            for name, v in zip(node._fields, node):
                walk(f"{prefix}.{name}", v)
        elif isinstance(node, torch.Tensor):
            out.append((prefix, node.cpu().numpy()))
        else:
            out.append((prefix, np.asarray(node)))

    for f in dataclasses.fields(scene):
        walk(f.name, getattr(scene, f.name))
    return out


def _assert_same_scene(port, ref):
    got, want = _leaves(port), _leaves(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("config", SCENE_CONFIGS)
def test_scene_leaves_equal(config):
    ref = jload((24, 16), config)
    _assert_same_scene(tload((24, 16), config, device="cpu"), ref)
    numpy_tree = jax.tree.map(np.asarray, ref)
    _assert_same_scene(scene_from_numpy(numpy_tree, "cpu"), ref)
    assert tscene.get_scene_name(config) == get_scene_name(config)


def test_scene_to_device_and_default_mask():
    s = tload((8, 8), device="cpu")
    assert isinstance(s, SceneData)
    moved = s.to("cpu")
    _assert_same_scene(moved, jload((8, 8)))
    assert moved.device == torch.device("cpu")
    # Both large spheres requested: the builder keeps the mirror (as JAX).
    both = tscene.LARGE_MIRROR_SPHERE | tscene.LARGE_GLASS_SPHERE
    _assert_same_scene(tload((8, 8), both | tscene.LIGHT_CEILING,
                             device="cpu"),
                       jload((8, 8), both | tscene.LIGHT_CEILING))


def test_camera_rays_and_raster_match():
    res = (40, 30)
    js = jload(res, SCENE_CONFIGS[0])
    ts = tload(res, SCENE_CONFIGS[0], device="cpu")
    r = np.random.default_rng(4)
    sx = r.uniform(0, res[0], 500).astype(np.float32)
    sy = r.uniform(0, res[1], 500).astype(np.float32)
    close(tcam.generate_ray(ts.camera, t(sx), t(sy)),
          jcam.generate_ray(js.camera, jnp.asarray(sx), jnp.asarray(sy)))
    p = r.uniform(-1.3, 1.3, (3, 500)).astype(np.float32)
    rx, ry = tcam.world_to_raster(ts.camera, tv(p))
    jx, jy = jcam.world_to_raster(js.camera, jv(p))
    close((rx, ry), (jx, jy), rtol=1e-5, atol=1e-4)
    close(tcam.check_raster(ts.camera, t(sx - 5), t(sy)),
          jcam.check_raster(js.camera, jnp.asarray(sx - 5), jnp.asarray(sy)))
