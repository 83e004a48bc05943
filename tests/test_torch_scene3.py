"""Why scene 3 (the background light) differs most from the JAX package.

At 32x32, 2 iterations, seed 1234, the port's scene-3 bpm image has one
pixel, (y=21, x=6), at (0, 0, 0) where the JAX package's has (0.379, 3.259,
3.955); that pixel alone moves the image mean by -1.63%
(tests/test_torch_matrix.py, EXCEPTIONS). These tests pin the cause down
to ulp-level branching, and rule out a fault of the port:

* emission: with the same uniforms, the port's ``lights.emit`` agrees with
  the JAX package's op-by-op (un-jitted) ``emit`` to <= 2 ulp (XLA's own
  sin/cos/sqrt round differently from torch's) on every light kind. The
  jitted ``emit``, which the renders run, differs by up to ~19 ulp because
  XLA's CPU fusions contract products and sums into fused multiply-adds
  (``u - u*u`` in ``sample_uniform_sphere_w``, the frame sums of the
  background and directional positions). Torch rounds each operation on
  its own, so no reordering of the port's arithmetic gives XLA's bits;
* the light stage is not the cause: JAX's emitted light samples carried
  into the port's light stage leave the pixel at zero;
* the merge is exact: JAX's camera queries and light vertices carried
  into the port's merge give JAX's merge colours, and with JAX's camera
  colours JAX's whole 2-iteration image, the firefly included;
* the camera walk is where the bits go: camera rays differ by a few ulp,
  and specular bounces grow that to ~2e-5 at the pixel's third vertex.
  The photon that makes the firefly lies at d^2 / r^2 = 0.99964 of JAX's
  query and 1.0029 of the port's: inside the radius in one, outside in
  the other.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.io.framebuffer import new_fb_planes as jnew_fb
from smallvcm_tpu.ops import lights as jlights
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import convert
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.core import rng
from smallvcm_tpu_torch.ops import lights as tlights
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

torch.set_num_threads(2)

MATRIX_GOLDEN = Path(__file__).parent / "data" / "torch_golden_matrix_32.npz"
RES = 32
N = RES * RES
SEED = 1234
ITERATION = 1           # the firefly comes from the second iteration
PIXEL = 21 * RES + 6    # (y=21, x=6)
MAX_PATH = 10
BPM = dict(use_vc=False, use_vm=True)


def _np(v):
    return np.stack([np.asarray(c) for c in v])


def _emit_both(scene_id: int, jit: bool):
    js = jload((RES, RES), SCENE_CONFIGS[scene_id])
    ts = tload((RES, RES), SCENE_CONFIGS[scene_id], device="cpu")
    u = rng.uniform_slots(SEED, rng.make_stream(ITERATION,
                                                rng.STAGE_LIGHT_EMIT),
                          torch.arange(N), 5).numpy()
    n_lights = ts.lights.kind.shape[0]
    lid = np.minimum((u[:, 0] * n_lights).astype(np.int64), n_lights - 1)
    got = tlights.emit(ts.lights, torch.from_numpy(lid), ts.scene_sphere,
                       *(torch.from_numpy(u[:, k]) for k in range(1, 5)))
    fn = lambda i, a, b, c, d: jlights.emit(js.lights, i, js.scene_sphere,
                                            a, b, c, d)
    args = (jnp.asarray(lid, jnp.int32),
            *(jnp.asarray(u[:, k]) for k in range(1, 5)))
    if jit:
        want = jax.jit(fn)(*args)
    else:
        with jax.disable_jit():
            want = fn(*args)
    return got, want


def _ulps(got, want) -> float:
    """Largest difference in ulps of the largest |component|."""
    a, b = _np(want), _np([c.numpy() for c in got])
    return float(np.abs(a - b).max() / np.spacing(np.abs(a).max()))


# scene -> light kind: 0 directional, 1 area, 2 point, 3 background. The
# bounds are the measured ulps rounded up; the jitted ones (XLA's fused
# multiply-adds) are the measured 2.0, 1.0, 19.2 and 19.2 / 10.5.
@pytest.mark.parametrize("scene_id,jit_pos,jit_dir", [
    (0, 2, 0), (1, 1, 1), (2, 0, 20), (3, 11, 20)])
def test_emit_matches_jax_to_rounding(scene_id, jit_pos, jit_dir):
    got, want = _emit_both(scene_id, jit=False)
    assert _ulps(got.position, want.position) <= 2.0
    assert _ulps(got.direction, want.direction) <= 1.0
    got, want = _emit_both(scene_id, jit=True)
    assert _ulps(got.position, want.position) <= jit_pos
    assert _ulps(got.direction, want.direction) <= jit_dir
    for f in ("energy", "emission_pdf_w", "direct_pdf_a", "cos_theta_light"):
        a, b = getattr(want, f), getattr(got, f)
        a = _np(a) if isinstance(a, tuple) else np.asarray(a)
        b = _np([c.numpy() for c in b]) if isinstance(b, tuple) else \
            b.numpy()
        np.testing.assert_allclose(b, a, rtol=2e-7, atol=0)
    assert np.array_equal(got.is_delta.numpy(), np.asarray(want.is_delta))


def _stored(tree) -> tvcm.StoredVertices:
    """JAX StoredVertices -> the port's, on the CPU."""
    leaf = lambda a: torch.from_numpy(np.array(a))
    return tvcm.StoredVertices(*(
        tvcm.V3(*map(leaf, f)) if isinstance(f, tuple) else leaf(f)
        for f in tree))._replace(mat_id=torch.from_numpy(
            np.asarray(tree.mat_id, np.int64)))


def _jax_stages(js, iteration: int):
    """JAX's bpm iteration stage by stage, jitted as its render jits them
    (loop camera form) -> (misc, light vertices, camera colour, queries,
    merge colour [3, N])."""
    misc = jvcm.compute_misc(js, iteration, N, 0.003, 0.75, **BPM)
    pix = jnp.arange(N, dtype=jnp.uint32)
    flags = (BPM["use_vc"], BPM["use_vm"])
    verts, _, _ = jax.jit(lambda p: jvcm.trace_light_paths(
        js, misc, p, iteration, jnew_fb(RES, RES), SEED, MAX_PATH, 0,
        *flags, False, "threefry"))(pix)
    color, queries = jax.jit(lambda v, p: jvcm._camera_stage(
        js, misc, v, p, iteration, RES, SEED, MAX_PATH, 0, *flags, False,
        "threefry", "allgather", None, False))(verts, pix)[:2]
    merge = _np(jax.jit(lambda q, v: jvcm.merge_stage(
        js, misc, q, v, 8 * N, 64 * N, False, MAX_PATH, 0, 4 * N, 4 * N, N,
        1))(queries, verts)[0])
    return misc, verts, color, queries, merge


def test_scene3_bpm_firefly_is_radius_boundary_branching(monkeypatch):
    js = jload((RES, RES), SCENE_CONFIGS[3])
    ts = tload((RES, RES), SCENE_CONFIGS[3], device="cpu")
    tpix = torch.arange(N)

    def port_merge(misc, queries, verts):
        color, _, _ = tvcm._merge(ts, misc, queries, verts, False, MAX_PATH,
                                  0, N, "auto", "allgather", None)
        return _np([c.numpy() for c in color])

    def port_stages():
        """The port's light vertices and merge queries of ITERATION."""
        return tvcm.trace_iteration(ts, ITERATION, RES, RES, SEED, MAX_PATH,
                                    0, use_vc=BPM["use_vc"])

    # JAX's camera colours and queries and its light vertices, merged by
    # the port: both iterations give JAX's image, the firefly included.
    image = np.zeros((RES, RES, 3), np.float32)
    for it in (0, 1):
        jmisc, jverts, jcolor, jqueries, jmerge = _jax_stages(js, it)
        tmisc = tvcm.compute_misc(ts, it, N, 0.003, 0.75, **BPM)
        assert [float(x) for x in jmisc] == list(tmisc)
        merged = port_merge(tmisc, _stored(jqueries), _stored(jverts))
        # Summation order: one channel of 3,072 differs by 1.1e-6 relative.
        np.testing.assert_allclose(merged, jmerge, rtol=1e-5, atol=1e-7)
        image += (_np(jcolor) + merged).T.reshape(RES, RES, 3)
    # The golden comes from JAX's render, one jitted program a block, which
    # fuses differently from these stage programs: 3 channels of 3,072
    # differ by up to 1.4e-4 relative.
    golden = np.load(MATRIX_GOLDEN)["s3_bpm"]
    np.testing.assert_allclose(image / 2, golden, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(image[21, 6] / 2, golden[21, 6], rtol=1e-5)
    assert golden[21, 6, 2] > 3.9

    # The port's own iteration 1: the pixel gets no merge colour ...
    tverts, tqueries = port_stages()
    assert jmerge[2, PIXEL] > 7.0
    assert np.all(port_merge(tmisc, tqueries, tverts)[:, PIXEL] == 0.0)

    # ... nor with JAX's light samples carried into its light stage.
    def jax_light_sample(scene, misc, pix, iteration, base_seed,
                         rng_kind="threefry"):
        state = jax.jit(lambda p: jvcm.generate_light_sample(
            js, jmisc, p, iteration, base_seed, rng_kind))(
                jnp.asarray(pix.numpy(), jnp.uint32))
        return convert.light_state_from_numpy(
            jax.tree.map(np.asarray, state), device="cpu")

    monkeypatch.setattr(tvcm, "generate_light_sample", jax_light_sample)
    carried = port_stages()[0]
    monkeypatch.undo()
    assert np.all(port_merge(tmisc, tqueries, carried)[:, PIXEL] == 0.0)

    # The photon behind the firefly sits on the radius.
    r2 = float(jmisc.radius_sqr)
    jq_pos = _np(jqueries.position)[:, 2, PIXEL]
    tq_pos = _np([c.numpy() for c in tqueries.position])[:, 2, PIXEL]
    jphoton = _np(jverts.position)[:, 2, 741]
    tphoton = _np([c.numpy() for c in tverts.position])[:, 2, 741]
    assert bool(np.asarray(jverts.valid)[2, 741]) and \
        bool(tverts.valid[2, 741])
    assert 0.999 < ((jphoton - jq_pos) ** 2).sum() / r2 < 1.0
    assert 1.0 < ((tphoton - tq_pos) ** 2).sum() / r2 < 1.01
    assert np.abs(jphoton - tphoton).max() < 1e-6
    assert 1e-5 < np.abs(jq_pos - tq_pos).max() < 1e-4

    # ... because the camera walk grows a few ulps of its rays.
    jcs = jax.jit(lambda p: jvcm.generate_camera_sample(
        js, jmisc, p, RES, ITERATION, SEED, "threefry"))(
            jnp.arange(N, dtype=jnp.uint32))[2]
    tcs = tvcm.generate_camera_sample(ts, tmisc, tpix, RES, ITERATION,
                                      SEED)[2]
    assert _ulps(tcs.origin, jcs.origin) == 0.0
    assert _ulps(tcs.direction, jcs.direction) <= 5.0   # measured 4.5
