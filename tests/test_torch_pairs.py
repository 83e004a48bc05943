"""PyTorch port vs the JAX package: hash grid and the pair-expansion merge.

* The hash grid (build, query ranges, pair expansion, compaction) equals
  the JAX package's exactly on the same inputs, and its candidate pairs
  cover the brute-force r-neighbourhood.
* The port's pair merge (``algorithms/vcm.py::merge_stage``) and its tile
  merge (``ops/merge.py::merge_stage``, the plain version of the CUDA
  kernel on the CPU) are held against the JAX XLA ``vcm.merge_stage``,
  which test_merge_stage.py pins to a dense all-pairs oracle, at rtol 3e-5
  / atol 1e-7 (per-query sums are taken in another order). The sparse
  case of scripts/check_kernel_tpu.py (32x32, 120 radii, seed 2), where
  the Pallas merge on a TPU disagreed with the XLA merge on 2 of 1024
  paths, is one of the cases.
* A whole VCM render with ``merge_backend="xla"`` against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.core.vec3 import from_array as jfrom_array
from smallvcm_tpu.ops import hashgrid as jgrid
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.core.vec3 import from_array as tfrom_array
from smallvcm_tpu_torch.ops import hashgrid as tgrid
from smallvcm_tpu_torch.ops import merge as TM
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_merge_stage import _random_vertices
from .test_torch_core import close, t
from .test_torch_merge import _port_misc, _port_vertices
from .test_torch_slice import _jax_render, assert_image_close

torch.set_num_threads(2)


def _points(seed, m, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(
        lo, hi, size=(m, 3)).astype(np.float32)


# -- hash grid ----------------------------------------------------------------


def test_hash_cell_matches_jax_with_negative_cells():
    r = np.random.default_rng(0)
    c = r.integers(-2 ** 31, 2 ** 31, size=(3, 5000)).astype(np.int32)
    c[:, :3] = [[-1, 0, 2 ** 31 - 1], [-7, -2 ** 31, 5], [0, -1, -1]]
    for num_cells in (64, 1000, 524288):
        want = jgrid._hash_cell(*(jnp.asarray(a) for a in c), num_cells)
        got = tgrid._hash_cell(*(t(a, np.int64) for a in c), num_cells)
        close(got, want)


@pytest.mark.parametrize("seed,radius,num_cells", [(1, 0.05, 1024),
                                                   (2, 0.2, 64)])
def test_grid_matches_jax(seed, radius, num_cells):
    pos = _points(seed, 3000)
    valid = np.random.default_rng(seed + 9).random(3000) < 0.8
    # Queries inside, at the edges and outside the particle bbox.
    queries = _points(seed + 1, 400, -0.1, 1.1)
    jg = jgrid.build(jfrom_array(jnp.asarray(pos)), jnp.asarray(valid),
                     jnp.float32(radius), num_cells)
    tg = tgrid.build(tfrom_array(t(pos)), t(valid), radius, num_cells)
    close(tg.sorted_idx, jg.sorted_idx)
    close(tg.cell_start, jg.cell_start)
    close(tg.cell_count, jg.cell_count)
    assert int(tg.max_occupancy) == int(jg.max_occupancy)
    assert np.float32(tg.inv_cell_size) == np.asarray(jg.inv_cell_size)
    for f in ("bbox_min_x", "bbox_max_y", "bbox_min_z"):
        close(getattr(tg, f), getattr(jg, f), rtol=0, atol=0)

    want = jgrid.query_cell_ranges(jg, num_cells,
                                   jfrom_array(jnp.asarray(queries)),
                                   jgrid.packed_ranges(jg))
    got = tgrid.query_cell_ranges(tg, num_cells, tfrom_array(t(queries)),
                                  tgrid.packed_ranges(tg))
    close(got, want)
    got_plain = tgrid.query_cell_ranges(tg, num_cells,
                                        tfrom_array(t(queries)))
    close(got_plain, want)

    starts, counts = got
    total = int(counts.sum())
    for cap in (total, total // 2, total + 77):
        w = jgrid.expand_pairs(*want, cap)
        g = tgrid.expand_pairs(starts, counts, cap)
        ok = np.asarray(w[2])
        close(g[2], w[2])
        # Only valid pairs carry meaning (the JAX version leaves the
        # tail of an under-full cap at whatever the carry left there).
        close(g[0][t(ok)], np.asarray(w[0])[ok])
        close(g[1][t(ok)], np.asarray(w[1])[ok])
        assert int(g[3]) == int(w[3]) and int(g[4]) == int(w[4])


def test_grid_pairs_cover_brute_force():
    """Every (query, particle) pair within the radius is a candidate."""
    pos = _points(2, 4000)
    valid = np.random.default_rng(3).random(4000) < 0.9
    queries = _points(4, 256, 0.1, 0.9)
    radius, num_cells = 0.05, 1024
    g = tgrid.build(tfrom_array(t(pos)), t(valid), radius, num_cells)
    starts, counts = tgrid.query_cell_ranges(g, num_cells,
                                             tfrom_array(t(queries)))
    qc, ppos, ok, total, ovf = tgrid.expand_pairs(starts, counts,
                                                  int(counts.sum()))
    assert int(ovf) == 0 and bool(ok.all())
    q = (qc // 8).numpy()
    p = g.sorted_idx[ppos].numpy()
    d2 = ((pos[p] - queries[q]) ** 2).sum(-1)
    keep = (d2 <= radius * radius) & valid[p]
    mine = set(zip(q[keep], p[keep]))
    d2_all = ((queries[:, None, :] - pos[None]) ** 2).sum(-1)
    qi, pi = np.nonzero((d2_all <= radius * radius) & valid[None])
    assert mine == set(zip(qi, pi)) and len(mine) > 100


@pytest.mark.parametrize("cap", [10, 600, 2000])
def test_compact_indices_matches_jax(cap):
    valid = np.random.default_rng(cap).random(1000) < 0.6
    w_idx, w_n, w_ovf = jgrid.compact_indices(jnp.asarray(valid), cap)
    g_idx, g_n, g_ovf = tgrid.compact_indices(t(valid), cap)
    close(g_idx, w_idx)
    assert int(g_n) == int(w_n) and int(g_ovf) == int(w_ovf)


# -- pair-expansion merge -----------------------------------------------------


def _case(res, seed, span_radii):
    """test_merge_stage.py's synthetic vertices at res x res paths."""
    n = res * res
    js, ts = jload((res, res), SCENE_CONFIGS[1]), tload((res, res),
                                                        SCENE_CONFIGS[1])
    misc = jvcm.compute_misc(js, 0, n, 0.05, 0.75, True, True)
    kq, kp = jax.random.split(jax.random.PRNGKey(seed))
    span = float(misc.radius) * span_radii
    queries = _random_vertices(kq, 4, n, 0.0, span, 9)
    light_verts = _random_vertices(kp, 5, n, 0.0, span, 9)
    return js, ts, misc, queries, light_verts


def _jax_merge(js, misc, queries, light_verts, ppm, n, pair_factor):
    want, ovf, stats = jvcm.merge_stage(
        js, misc, queries, light_verts, num_cells=2 * n,
        pair_cap=pair_factor * n, ppm=ppm, max_path_length=7,
        min_path_length=0, photon_cap=5 * n, query_cap=4 * n, n_paths=n,
    )
    assert int(ovf) == 0 and int(stats[0]) > 0
    return want


@pytest.mark.parametrize("ppm", [False, True])
@pytest.mark.parametrize("res,seed,span_radii,pair_factor", [
    (8, 0, 30.0, 64),       # test_merge_stage.py's distribution
    (8, 1, 6.0, 1024),      # dense: most queries find photons in range
    (32, 2, 120.0, 64),     # scripts/check_kernel_tpu.py:79, sparse
])
def test_pair_and_tile_merge_match_xla_merge(ppm, res, seed, span_radii,
                                             pair_factor):
    n = res * res
    js, ts, misc, queries, light_verts = _case(res, seed, span_radii)
    want = _jax_merge(js, misc, queries, light_verts, ppm, n, pair_factor)
    args = (ts, _port_misc(misc), _port_vertices(queries),
            _port_vertices(light_verts), ppm, 7, 0, n)
    # The JAX call's cell count: probe cells that collide in the hash
    # visit their photons twice, in the reference's grid too.
    pair = tvcm.merge_stage(*args, num_cells=2 * n)
    if span_radii < 10:
        assert float(pair.x.abs().sum()) > 0.0
    close(pair, want, rtol=3e-5, atol=1e-7)
    close(TM.merge_stage(*args), want, rtol=3e-5, atol=1e-7)
    # Chunked pair expansion (query ranges of at most 500 pairs) gives
    # the same sums.
    close(tvcm.merge_stage(*args, num_cells=2 * n, max_pairs=500), want,
          rtol=3e-5, atol=1e-7)


def test_pair_merge_empty_and_min_length():
    js, ts, misc, queries, light_verts = _case(8, 0, 6.0)
    args = (ts, _port_misc(misc), _port_vertices(queries))
    lv = _port_vertices(light_verts)
    dead = lv._replace(valid=torch.zeros_like(lv.valid))
    got = tvcm.merge_stage(*args, dead, False, 7, 0, 64)
    assert all(float(c.abs().sum()) == 0.0 for c in got)
    want, ovf, _ = jvcm.merge_stage(
        js, misc, queries, light_verts, num_cells=128, pair_cap=1024 * 64,
        ppm=False, max_path_length=6, min_path_length=4, photon_cap=320,
        query_cap=256, n_paths=64)
    assert int(ovf) == 0
    close(tvcm.merge_stage(*args, lv, False, 6, 4, 64, num_cells=128), want,
          rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("alg", ["vcm", "bpm"])
def test_render_with_pair_merge_matches_jax(alg):
    """A whole render through the pair merge, against JAX renders with the
    XLA merge (loop camera form), at the slice test's bound."""
    res, iters = 16, 2
    use_vc = alg == "vcm"
    kw = dict(max_path_length=10) if use_vc else dict(
        use_vc=False, radius_factor=0.05)
    want, _ = _jax_render(res, iters, "off", **kw)
    cfg = R.RenderConfig(algorithm=alg, iterations=iters,
                         resolution=(res, res), merge_backend="xla",
                         radius_factor=kw.get("radius_factor", 0.003))
    img, _, _, _ = R.render(tload((res, res), SCENE_CONFIGS[0]), cfg)
    assert_image_close(img, want, rtol=1e-4 if use_vc else 1e-3)
    tile_cfg = R.RenderConfig(**{**cfg.__dict__, "merge_backend": "auto"})
    tile, _, _, _ = R.render(tload((res, res), SCENE_CONFIGS[0]), tile_cfg)
    assert_image_close(img, tile.numpy(), rtol=1e-4)
