"""PyTorch port vs the JAX package: counter RNG, vec3 and vecmath.

Inputs are made with numpy from a seed and fed to both implementations.
The RNG must be bit-exact (every later comparison of the port rests on
it); float math is held to rtol 1e-5 / atol 1e-6, because transcendentals
(sin, cos, pow, sqrt chains) differ by ulps between XLA and torch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smallvcm_tpu.core import rng as jrng
from smallvcm_tpu.core import vec3 as jv3
from smallvcm_tpu.core import vecmath as jvm
from smallvcm_tpu_torch.core import rng as trng
from smallvcm_tpu_torch.core import vec3 as tv3
from smallvcm_tpu_torch.core import vecmath as tvm

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


# -- helpers shared by the test_torch_* files --------------------------------


def t(a, dtype=None):
    """numpy/JAX array -> torch tensor (copy)."""
    arr = np.array(np.asarray(a))
    if dtype is not None:
        arr = arr.astype(dtype)
    return torch.from_numpy(arr)


def tv(v):
    """JAX V3 (or numpy [3, ...]) -> port V3."""
    return tv3.V3(*(t(c) for c in v))


def jv(v):
    """numpy [3, ...] -> JAX V3."""
    return jv3.V3(*(jnp.asarray(c) for c in v))


def close(got, want, rtol=RTOL, atol=ATOL):
    """Compare port output (tensor / V3 / tuple) with JAX output."""
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol, atol)
        return
    g = got.detach().cpu().numpy()
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def unit_dirs(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


# -- RNG ------------------------------------------------------------------


@pytest.mark.parametrize("seed,iteration,stage,bounce", [
    (1234, 0, jrng.STAGE_CAMERA_JITTER, 0),
    (1234, 7, jrng.STAGE_LIGHT_WALK, 3),
    (0, 123456, jrng.STAGE_CAMERA_NEE, 9),
    (2 ** 32 + 99, 8388607, jrng.STAGE_LIGHT_EMIT, 63),
])
@pytest.mark.parametrize("n_slots", [1, 4, 5])
def test_uniform_slots_bit_exact(seed, iteration, stage, bounce, n_slots):
    ids = np.random.default_rng(seed % 97).integers(
        0, 2 ** 32, size=2048, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jrng.uniform_slots(
        seed, jrng.make_stream(iteration, stage, bounce), ids, n_slots))
    got = trng.uniform_slots(
        seed, trng.make_stream(iteration, stage, bounce),
        t(ids, np.int64), n_slots).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_threefry_words_and_stream_packing():
    r = np.random.default_rng(5)
    k0, k1, c0, c1 = (r.integers(0, 2 ** 32, 512, dtype=np.uint64)
                      .astype(np.uint32) for _ in range(4))
    w0, w1 = jrng.threefry2x32(k0, k1, c0, c1)
    g0, g1 = trng.threefry2x32(*(t(a, np.int64) for a in (k0, k1, c0, c1)))
    np.testing.assert_array_equal(g0.numpy(), np.asarray(w0).astype(np.int64))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1).astype(np.int64))
    for it, st, b in [(0, 0, 0), (5, 3, 9), (2 ** 23 + 1, 4, 63)]:
        assert trng.make_stream(it, st, b) == int(jrng.make_stream(it, st, b))


# -- vec3 / vecmath -------------------------------------------------------


def test_vec3_ops_match():
    r = np.random.default_rng(1)
    a, b = r.normal(size=(2, 3, 300)).astype(np.float32)
    ja, jb, ta, tb = jv(a), jv(b), tv(a), tv(b)
    close(tv3.dot(ta, tb), jv3.dot(ja, jb))
    close(tv3.cross(ta, tb), jv3.cross(ja, jb))
    close(tv3.normalize(ta), jv3.normalize(ja))
    close(tv3.length(ta), jv3.length(ja))
    close(tv3.luminance(tb), jv3.luminance(jb))
    close(tv3.max_gt_zero(ta), jv3.max_gt_zero(ja))
    mask = a[0] > 0
    close(tv3.v3_where(t(mask), ta, 0.0), jv3.v3_where(mask, ja, 0.0))
    close(ta.to_array(), ja.to_array())


def test_frames_and_samplers_match():
    r = np.random.default_rng(2)
    n = 1000
    z = unit_dirs(r, n)
    z[:, :50] = np.array([[1.0], [0.0], [0.0]], np.float32)  # use_y branch
    close(tvm.frame_set_from_z(tv(z)), jvm.frame_set_from_z(jv(z)))
    u1, u2 = r.random((2, n), dtype=np.float32)
    u1[:3], u2[3:6] = 0.0, 0.5  # exact-zero / axis cases
    power = r.uniform(1.0, 100.0, n).astype(np.float32)
    for tf, jf, extra in [
        (tvm.sample_cos_hemisphere_w, jvm.sample_cos_hemisphere_w, ()),
        (tvm.sample_concentric_disc, jvm.sample_concentric_disc, ()),
        (tvm.sample_uniform_triangle, jvm.sample_uniform_triangle, ()),
        (tvm.sample_uniform_sphere_w, jvm.sample_uniform_sphere_w, ()),
        (tvm.sample_power_cos_hemisphere_w,
         jvm.sample_power_cos_hemisphere_w, (power,)),
    ]:
        close(tf(t(u1), t(u2), *(t(e) for e in extra)),
              jf(jnp.asarray(u1), jnp.asarray(u2),
                 *(jnp.asarray(e) for e in extra)))
    d = unit_dirs(r, n)
    close(tvm.cos_hemisphere_pdf_w(tv(z), tv(d)),
          jvm.cos_hemisphere_pdf_w(jv(z), jv(d)))
    close(tvm.power_cos_hemisphere_pdf_w(tv(z), tv(d), t(power)),
          jvm.power_cos_hemisphere_pdf_w(jv(z), jv(d), jnp.asarray(power)))


def test_fresnel_and_pdf_conversions_match():
    r = np.random.default_rng(3)
    cos_i = r.uniform(-1, 1, 2000).astype(np.float32)
    ior = r.choice(np.array([-1.0, 1.6, 1.33, 0.0], np.float32), 2000)
    close(tvm.fresnel_dielectric(t(cos_i), t(ior)),
          jvm.fresnel_dielectric(jnp.asarray(cos_i), jnp.asarray(ior)))
    pdf, dist = r.uniform(0.01, 5, (2, 2000)).astype(np.float32)
    close(tvm.pdf_w_to_a(t(pdf), t(dist), t(cos_i)),
          jvm.pdf_w_to_a(jnp.asarray(pdf), jnp.asarray(dist),
                         jnp.asarray(cos_i)))
    close(tvm.pdf_a_to_w(t(pdf), t(dist), t(cos_i)),
          jvm.pdf_a_to_w(jnp.asarray(pdf), jnp.asarray(dist),
                         jnp.asarray(cos_i)))
