"""PyTorch port vs the JAX package: photon merge, hash-grid sort, framebuffer.

The merge is held against the Pallas merge ``merge_stage_pallas`` run in
interpret mode (itself pinned to the XLA merge by test_pallas_merge.py) on
that file's synthetic vertex distributions, at its bound: rtol 3e-5,
atol 1e-7 (per-query sums are taken in another order). On the CPU the
port evaluates its plain tile version; the CUDA kernel is compared with
it on a card, in test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.io import framebuffer as jfb
from smallvcm_tpu.ops import hashgrid as jgrid
from smallvcm_tpu.ops import pallas_merge as JPM
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.io import framebuffer as tfb
from smallvcm_tpu_torch.ops import hashgrid as tgrid
from smallvcm_tpu_torch.ops import merge as TM
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_merge_stage import _random_vertices
from .test_torch_core import close, jv, t, tv

torch.set_num_threads(2)

RES = 8
N = RES * RES


def _port_vertices(jverts):
    return tvcm.StoredVertices(*(
        tv(f) if isinstance(f, tuple) else t(f) for f in jverts))


def _port_misc(jmisc):
    return tvcm.VcmMisc(*(float(np.asarray(v)) for v in jmisc))


def _case(seed, span_radii=30.0):
    js, ts = jload((RES, RES), SCENE_CONFIGS[1]), tload((RES, RES),
                                                        SCENE_CONFIGS[1])
    misc = jvcm.compute_misc(js, 0, N, 0.05, 0.75, True, True)
    kq, kp = jax.random.split(jax.random.PRNGKey(seed))
    span = float(misc.radius) * span_radii
    queries = _random_vertices(kq, 4, N, 0.0, span, 9)
    light_verts = _random_vertices(kp, 5, N, 0.0, span, 9)
    return js, ts, misc, queries, light_verts


def test_port_misc_matches_jax():
    js, ts = jload((RES, RES)), tload((RES, RES))
    for it, use_vc, use_vm in [(0, True, True), (7, False, True),
                               (123, True, False)]:
        want = jvcm.compute_misc(js, it, N, 0.003, 0.75, use_vc, use_vm)
        got = tvcm.compute_misc(ts, it, N, 0.003, 0.75, use_vc, use_vm)
        np.testing.assert_array_equal(
            np.array(got, np.float32),
            np.array([np.asarray(v) for v in want], np.float32))


@pytest.mark.parametrize("ppm", [False, True])
@pytest.mark.parametrize("seed,span_radii", [(0, 30.0), (1, 30.0),
                                              (0, 6.0), (1, 6.0)])
def test_merge_stage_matches_pallas_merge(ppm, seed, span_radii):
    """test_pallas_merge.py's distribution (30 radii) and a denser one
    (6 radii) where most queries find photons in range."""
    js, ts, misc, queries, light_verts = _case(seed, span_radii)
    want, ovf, stats = JPM.merge_stage_pallas(
        js, misc, queries, light_verts, work_cap=8192, ppm=ppm,
        max_path_length=7, min_path_length=0,
        photon_cap=384, query_cap=256, n_paths=N, interpret=True,
    )
    assert int(ovf) == 0 and int(stats[0]) > 0
    got = TM.merge_stage(ts, _port_misc(misc), _port_vertices(queries),
                         _port_vertices(light_verts), ppm, 7, 0, N)
    if span_radii < 10:
        assert float(got.x.abs().sum()) > 0.0
    close(got, want, rtol=3e-5, atol=1e-7)


def test_merge_tables_match_pallas_prep():
    """qtab / ptab / runs are the Pallas prep's tables, cap padding aside."""
    js, ts, misc, queries, light_verts = _case(3, 6.0)
    (jq, jruns, jp), _, n_q, ovf, _ = JPM.merge_prep(
        js, misc, queries, light_verts, 384, 256, N)
    assert int(ovf) == 0
    qtab, runs, ptab, q_path, tn_q = TM.merge_prep(
        ts, _port_misc(misc), _port_vertices(queries),
        _port_vertices(light_verts), N)
    assert tn_q == int(n_q)
    jq_planar = np.asarray(jq).transpose(2, 0, 1).reshape(TM.QF, -1)
    close(qtab, jq_planar[:, :qtab.shape[1]], rtol=1e-5, atol=1e-6)
    cap = ptab.shape[1]
    close(ptab, np.asarray(jp)[:, :cap], rtol=1e-5, atol=1e-6)
    close(runs, np.asarray(jruns)[:, :TM.RUNCOLS])

    # The plain tile evaluation on the JAX prep's own tables equals the
    # Pallas kernel's per-query sums.
    scal = JPM.make_scal(float(misc.radius_sqr), float(misc.mis_vc_weight))
    want = JPM.run_tile_kernel(scal, jq, jruns, jp, max_path_length=7,
                               min_path_length=0, ppm=False, interpret=True)
    got = TM.merge_tiles(
        t(jq_planar), t(np.asarray(jruns)[:, :TM.RUNCOLS]), t(jp),
        float(misc.radius_sqr), float(misc.mis_vc_weight),
        max_path_length=7, min_path_length=0, ppm=False,
    )
    close(got, np.asarray(want)[:3], rtol=3e-5, atol=1e-7)


def test_merge_stage_empty_and_kernel_wrapper_refuses_cpu():
    js, ts, misc, queries, light_verts = _case(0)
    lv = _port_vertices(light_verts)
    dead = lv._replace(valid=torch.zeros_like(lv.valid))
    got = TM.merge_stage(ts, _port_misc(misc), _port_vertices(queries), dead,
                         False, 7, 0, N)
    assert all(float(c.abs().sum()) == 0.0 for c in got)
    with pytest.raises(ValueError):
        TM.merge_tiles_kernel(torch.zeros(TM.QF, TM.QTILE),
                              torch.zeros(1, TM.RUNCOLS, dtype=torch.int32),
                              torch.zeros(TM.PF, TM.SLAB), 0.1, 0.0,
                              max_path_length=7, min_path_length=0, ppm=False)


@pytest.mark.parametrize("cap", [5, 300, 400])
def test_sort_compact_planes_matches(cap):
    r = np.random.default_rng(cap)
    keys = r.integers(0, 40, 320).astype(np.int32)
    keys[r.random(320) < 0.3] = 1 << 19   # dead slots sort last
    planes = r.normal(size=(4, 320)).astype(np.float32)
    want_p, want_src = jgrid.sort_compact_planes(
        jnp.asarray(keys, jnp.uint32), jnp.asarray(planes), cap)
    got_p, got_src = tgrid.sort_compact_planes(t(keys, np.int64), t(planes),
                                               cap)
    close(got_src, want_src)
    close(got_p, want_p, rtol=0, atol=0)


def test_framebuffer_scatters_match():
    r = np.random.default_rng(7)
    res_x, res_y = 12, 10
    p = res_x * res_y
    base = r.random((3, res_y, res_x), dtype=np.float32)
    rgb = r.random((3, 4, 50), dtype=np.float32)
    pix = r.integers(0, p + 1, (4, 50)).astype(np.int32)   # p = dropped
    close(tfb.splat_colors(tv(base), t(pix, np.int64), tv(rgb)),
          jfb.splat_colors(jv(base), jnp.asarray(pix), jv(rgb)),
          rtol=1e-6, atol=1e-7)

    col = r.random((3, p), dtype=np.float32)
    ids = np.arange(p, dtype=np.int64)
    close(tfb.add_color_at_pix(tv(base), t(ids), tv(col)),
          jfb.add_color_at_pix(jv(base), jnp.asarray(ids, jnp.uint32),
                               jv(col)), rtol=0, atol=0)

    sx = r.uniform(0, res_x, 50).astype(np.float32)
    sy = r.uniform(0, res_y, 50).astype(np.float32)
    close(tfb.add_color(tv(base), t(sx), t(sy), tv(rgb[:, 0])),
          jfb.add_color(jv(base), jnp.asarray(sx), jnp.asarray(sy),
                        jv(rgb[:, 0])), rtol=1e-6, atol=1e-7)
    img = base.transpose(1, 2, 0)
    close(tfb.total_luminance(t(img)), jfb.total_luminance(jnp.asarray(img)),
          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ext", ["bmp", "hdr", "pfm", "ppm"])
def test_image_writers_byte_identical(ext, tmp_path, monkeypatch):
    monkeypatch.setenv("SMALLVCM_TPU_NO_NATIVE", "1")
    img = np.random.default_rng(8).gamma(1.0, 0.4, (6, 8, 3)).astype(
        np.float32)
    img[0, 0] = 0.0
    jfb.save_image(img, str(tmp_path / f"j.{ext}"))
    tfb.save_image(torch.from_numpy(img), str(tmp_path / f"t.{ext}"))
    assert (tmp_path / f"t.{ext}").read_bytes() == \
        (tmp_path / f"j.{ext}").read_bytes()
    if ext == "bmp":
        np.testing.assert_array_equal(tfb.load_bmp(str(tmp_path / "t.bmp")),
                                      jfb.load_bmp(str(tmp_path / "j.bmp")))

