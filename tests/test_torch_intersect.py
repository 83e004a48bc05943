"""PyTorch port vs the JAX package: ray-scene intersection and occlusion.

On the CPU the port's sweep is its plain PyTorch version (the dense
[N, P] sweep of ops/intersect.py). Primitive ids must be equal and hit
distances agree to rtol 1e-6, plus atol 1e-7 for origins near a plane,
where n.(p0 - o) cancels and XLA's fused multiply-adds round differently
from torch's separate products. The CUDA kernel is compared with the plain
version on a card, in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu.ops import intersect as jint
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import intersect as tint
from smallvcm_tpu_torch.ops import sweep as tsweep
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_torch_core import close, jv, t, tv, unit_dirs

torch.set_num_threads(2)

_LO = np.array([[-1.27], [-1.25], [-1.28]], np.float32)
_HI = np.array([[1.28], [1.30], [1.28]], np.float32)


def _rays(seed, n):
    r = np.random.default_rng(seed)
    org = (_LO + (_HI - _LO) * r.random((3, n))).astype(np.float32)
    return org, unit_dirs(r, n)


@pytest.mark.parametrize("config", SCENE_CONFIGS)
def test_intersect_matches_jax(config):
    js, ts = jload((8, 8), config), tload((8, 8), config, device="cpu")
    org, d = _rays(config, 4000)
    want = jint.intersect(js, jv(org), jv(d))
    got = tint.intersect(ts, tv(org), tv(d))
    close(got.hit, want.hit)
    close(got.mat_id, want.mat_id)
    close(got.light_id, want.light_id)
    close(got.dist, want.dist, rtol=1e-6, atol=1e-7)
    close(got.normal, want.normal, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("config", SCENE_CONFIGS[:2])
def test_occluded_matches_jax(config):
    js, ts = jload((8, 8), config), tload((8, 8), config, device="cpu")
    org, d = _rays(10 + config, 4000)
    dist = np.random.default_rng(config).uniform(0.0, 3.0, 4000).astype(
        np.float32)
    want = jint.occluded(js, jv(org), jv(d), dist)
    got = tint.occluded(ts, tv(org), tv(d), t(dist))
    close(got, want)


def test_sweep_takes_broadcast_shapes():
    ts = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    org, d = _rays(3, 64)
    o2 = V3(*(t(c)[None, :].expand(3, 64) for c in org))
    d2 = tv(d)
    dist, prim = tsweep.sweep(ts, o2, d2)
    d1, p1 = tsweep.sweep(ts, tv(org), d2)
    assert dist.shape == prim.shape == (3, 64)
    for k in range(3):
        assert torch.equal(dist[k], d1) and torch.equal(prim[k], p1)


def test_kernel_wrapper_refuses_cpu_tensors():
    ts = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    org, d = _rays(5, 16)
    dist, active = torch.ones(16), torch.ones(16, dtype=torch.bool)
    before = (tsweep.sweep_kernel.launches, tsweep.occluded_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.sweep_kernel(ts, tv(org), tv(d))
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.occluded_kernel(ts, tv(org), tv(d), dist, active)
    assert (tsweep.sweep_kernel.launches,
            tsweep.occluded_kernel.launches) == before

