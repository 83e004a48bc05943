"""Path sharding over torch.distributed: 2 gloo CPU ranks vs one process.

The ranks are spawned once for the module (``multihost.spawn`` through a
file:// rendezvous) and return every image the module checks; scene 1,
16x16, max path length 4 (tests/test_sharding.py's scene and length). The
single-process references render in this process. Bounds:

* el and pt bit for bit: every pixel has one owner, so the framebuffer sum
  adds exact zeros;
* VCM's per-path camera colour (light-tracing splats off) with the
  all-gather bit for bit: the gathered photon table is the single-process
  table element for element;
* VCM (all-gather and ring), lt and bpt within rtol 1e-4 / atol 1e-6 on
  every pixel of the single-process image, ring within the same bound of
  all-gather: only the order of the sums over ranks differs;
* the same images against the JAX package's single-device render with
  test_torch_slice.py's bound (rtol 1e-4 on >= 99% of pixels, mean to
  1e-4), since 1-ulp differences between XLA and PyTorch can move a path.

JAX is imported inside the test that uses it: the ranks import this
module and need only the port.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import merge as cell_merge
from smallvcm_tpu_torch.parallel import comm, multihost
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

RES = 16
MAXLEN = 4
RANKS = 2
CASES = (("el", "allgather"), ("pt", "allgather"), ("vcm", "allgather"),
         ("vcm", "ring"), ("lt", "allgather"), ("bpt", "allgather"))


def _scene():
    return load_cornell_box((RES, RES), SCENE_CONFIGS[1], device="cpu")


def _cfg(alg, exchange="allgather", group=None):
    return R.RenderConfig(algorithm=alg, resolution=(RES, RES),
                          max_path_length=MAXLEN, vm_exchange=exchange,
                          group=group)


def _camera_colour(scene, group):
    """VCM's image without the light stage's splats: the per-path camera
    colour on each path's own pixel."""
    real = vcm.splat_colors
    vcm.splat_colors = lambda fb, pix, rgb: fb
    try:
        return R.render_iteration(scene, _cfg("vcm", group=group), "vcm",
                                  0)[0]
    finally:
        vcm.splat_colors = real


def _rank_renders():
    """Runs in every rank: each case's image and ray count."""
    torch.set_num_threads(1)
    group = multihost.global_group()
    scene = _scene()
    out = {(alg, ex): R.render_iteration(scene, _cfg(alg, ex, group), alg, 0)
           for alg, ex in CASES}
    out["camera"] = _camera_colour(scene, group)
    try:
        comm.shard_ids(RES * RES + 1, comm.world_size(group),
                       comm.rank(group), "cpu")
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return multihost.spawn(RANKS, "cpu", _rank_renders)


@pytest.fixture(scope="module")
def single():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = _scene()
        out = {(alg, "allgather"): R.render_iteration(scene, _cfg(alg),
                                                      alg, 0)
               for alg in dict(CASES)}
        out["camera"] = _camera_colour(scene, None)
        return out
    finally:
        torch.set_num_threads(threads)


def test_every_rank_holds_the_same_image(ranks):
    for key, value in ranks[0].items():
        if key == "indivisible":
            continue
        img = value[0] if isinstance(value, tuple) else value
        other = ranks[1][key]
        assert torch.equal(img, other[0] if isinstance(other, tuple)
                           else other), key


@pytest.mark.parametrize("alg", ["el", "pt"])
def test_el_pt_bitwise_equal_single_process(ranks, single, alg):
    img, rays = ranks[0][alg, "allgather"]
    want, want_rays = single[alg, "allgather"]
    assert float(want.mean()) > 0.0
    assert torch.equal(img, want)
    assert int(rays) == int(want_rays)


def test_vcm_camera_colour_bitwise_with_allgather(ranks, single):
    assert float(single["camera"].mean()) > 0.0
    assert torch.equal(ranks[0]["camera"], single["camera"])


@pytest.mark.parametrize("case", [("vcm", "allgather"), ("vcm", "ring"),
                                  ("lt", "allgather"), ("bpt", "allgather")])
def test_vcm_family_within_bound_of_single_process(ranks, single, case):
    img, rays = ranks[0][case]
    want, want_rays = single[case[0], "allgather"]
    assert float(want.mean()) > 0.0 and torch.isfinite(img).all()
    torch.testing.assert_close(img, want, rtol=1e-4, atol=1e-6)
    assert int(rays) == int(want_rays)


def test_ring_equals_allgather(ranks):
    torch.testing.assert_close(ranks[0]["vcm", "ring"][0],
                               ranks[0]["vcm", "allgather"][0],
                               rtol=1e-4, atol=1e-6)


def test_indivisible_path_count_raises(ranks):
    assert ranks[0]["indivisible"] == (
        f"path count {RES * RES + 1} not divisible by {RANKS} devices")


@pytest.mark.parametrize("case", [("vcm", "allgather"), ("vcm", "ring"),
                                  ("lt", "allgather"), ("bpt", "allgather")])
def test_sharded_images_match_jax_single_device(ranks, case):
    from smallvcm_tpu.algorithms import vcm as jvcm
    from smallvcm_tpu.scene.scene import load_cornell_box as jload

    use_vc, use_vm, lt_only, ppm = R._VCM_FLAGS[case[0]]
    want, _, ovf, _, _ = jvcm.render_block_with_stats(
        jload((RES, RES), SCENE_CONFIGS[1]), 0, RES, RES, block=1,
        max_path_length=MAXLEN, use_vc=use_vc, use_vm=use_vm,
        light_trace_only=lt_only, ppm=ppm, pair_factor=64.0,
        photon_factor=4.0, query_factor=4.0, merge_backend="xla",
        camera_unroll="off")
    assert int(ovf) == 0
    got, want = ranks[0][case][0].numpy(), np.asarray(want)
    assert want.mean() > 0.0 and np.isfinite(got).all()
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"
    assert abs(got.mean() / want.mean() - 1.0) <= 1e-4


def _columns(v, cols):
    """StoredVertices restricted to path columns ``cols``."""
    return vcm.StoredVertices(*(
        V3(*(c[:, cols] for c in f)) if isinstance(f, V3) else f[:, cols]
        for f in v))


@pytest.mark.parametrize("backend", ["cells", "pairs"])
def test_merge_of_a_query_shard_against_every_photon(backend):
    """A rank's merge under the all-gather: query columns (its paths) fewer
    than photon columns (every path). Each half of the queries merged
    against the whole photon table gives that half of the single-process
    merge bit for bit: path lengths and owners come from each table's own
    column count."""
    scene = _scene()
    n = RES * RES
    misc = vcm.compute_misc(scene, 0, n, 0.05, 0.75, True, True)
    verts, queries = vcm.trace_iteration(scene, 0, RES, RES, 1234, MAXLEN,
                                         0, 0.05)
    if backend == "cells":
        def merge(q, m):
            color, overflow, stats = cell_merge.merge_stage(
                scene, misc, q, verts, False, MAXLEN, 0, m, with_stats=True)
            assert int(overflow) == 0
            return color, stats
    else:
        def merge(q, m):
            color, overflow, stats = vcm.merge_stage(
                scene, misc, q, verts, 8 * n, 64 * m, False, MAXLEN, 0,
                4 * n, 4 * m, m)
            assert int(overflow) == 0
            return color, stats
    full, full_stats = merge(queries, n)
    assert float(full.x.sum()) > 0.0
    half = n // 2
    pairs = 0
    for cols in (slice(0, half), slice(half, n)):
        got, stats = merge(_columns(queries, cols), half)
        for a, b in zip(got, full):
            assert torch.equal(a, b[cols])
        assert int(stats[1]) == int(full_stats[1])      # every photon
        pairs += int(stats[0])
    assert pairs == int(full_stats[0])
