"""PyTorch port vs the JAX package: BSDF engine and light sampling.

Same numpy inputs into both; rtol 1e-5 / atol 1e-6 because pow, sqrt,
sin/cos and exp differ by ulps between XLA and torch. Discrete outputs
(validity, delta flags, sampled events) must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smallvcm_tpu.ops import bsdf as jbsdf
from smallvcm_tpu.ops import lights as jlights
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch.ops import bsdf as tbsdf
from smallvcm_tpu_torch.ops import lights as tlights
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_torch_core import close, jv, t, tv, unit_dirs

torch.set_num_threads(2)

N = 3000


def _bsdf_inputs(seed):
    r = np.random.default_rng(seed)
    ray_dir, normal, gen = unit_dirs(r, N), unit_dirs(r, N), unit_dirs(r, N)
    mat = r.integers(-1, 9, N).astype(np.int32)
    hit = r.random(N) < 0.9
    u = r.random((3, N), dtype=np.float32)
    return ray_dir, normal, gen, mat, hit, u


def _setups(seed, config=SCENE_CONFIGS[0]):
    js, ts = jload((8, 8), config), tload((8, 8), config, device="cpu")
    ray_dir, normal, gen, mat, hit, u = _bsdf_inputs(seed)
    jb = jbsdf.setup(js.materials, jv(ray_dir), jv(normal),
                     jnp.asarray(mat), jnp.asarray(hit))
    tb = tbsdf.setup(ts.materials, tv(ray_dir), tv(normal), t(mat), t(hit))
    return js, ts, jb, tb, gen, u


@pytest.mark.parametrize("seed", [0, 1])
def test_bsdf_setup_matches(seed):
    _, _, jb, tb, _, _ = _setups(seed)
    close(tuple(tb), tuple(jb))


@pytest.mark.parametrize("seed", [2, 3])
def test_bsdf_evaluate_and_pdf_match(seed):
    js, ts, jb, tb, gen, _ = _setups(seed)
    close(tbsdf.evaluate(ts.materials, tb, tv(gen)),
          jbsdf.evaluate(js.materials, jb, jv(gen)))
    close(tbsdf.pdf(ts.materials, tb, tv(gen)),
          jbsdf.pdf(js.materials, jb, jv(gen)))


@pytest.mark.parametrize("fix_is_light", [False, True])
def test_bsdf_sample_matches(fix_is_light):
    js, ts, jb, tb, _, u = _setups(4)
    got = tbsdf.sample(ts.materials, tb, *(t(c) for c in u),
                       fix_is_light=fix_is_light)
    want = jbsdf.sample(js.materials, jb, *(jnp.asarray(c) for c in u),
                        fix_is_light=fix_is_light)
    close(got, want)


@pytest.mark.parametrize("config", SCENE_CONFIGS)
def test_lights_match(config):
    js, ts = jload((8, 8), config), tload((8, 8), config, device="cpu")
    r = np.random.default_rng(config)
    n_l = int(js.lights.kind.shape[0])
    idx = r.integers(0, n_l, N).astype(np.int32)
    u = r.random((4, N), dtype=np.float32)
    pos = r.uniform(-1.2, 1.2, (3, N)).astype(np.float32)
    d = unit_dirs(r, N)
    close(tlights.illuminate(ts.lights, t(idx), ts.scene_sphere, tv(pos),
                             t(u[0]), t(u[1])),
          jlights.illuminate(js.lights, jnp.asarray(idx), js.scene_sphere,
                             jv(pos), jnp.asarray(u[0]), jnp.asarray(u[1])))
    close(tlights.emit(ts.lights, t(idx), ts.scene_sphere,
                       *(t(c) for c in u)),
          jlights.emit(js.lights, jnp.asarray(idx), js.scene_sphere,
                       *(jnp.asarray(c) for c in u)))
    close(tlights.get_radiance(ts.lights, t(idx), ts.scene_sphere, tv(d)),
          jlights.get_radiance(js.lights, jnp.asarray(idx), js.scene_sphere,
                               jv(d)))
