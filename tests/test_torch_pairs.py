"""PyTorch port vs the JAX package: hash grid and the pair-expansion merge.

* The pair merge's hash grid (cell hashes and counts, the probed cells'
  ranges, pair expansion) equals the JAX package's exactly on the same
  inputs, and its candidate pairs cover the brute-force r-neighbourhood.
* The port's pair merge (``algorithms/vcm.py::merge_stage``) and its cell
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


def _port_grid(pos, valid, queries, radius, num_cells, pad=None):
    """The pair merge's grid pieces (vcm._photon_grid, vcm._probe_cells)
    on points -> (grid, starts [Q, 8], counts [Q, 8]); the bbox pad is
    the radius unless given."""
    grid = tvcm._photon_grid(
        tvcm.StoredVertices(*([tfrom_array(t(pos))] + [None] * 7
                              + [t(valid)])), torch.tensor(
            np.float32(radius)), num_cells)
    pad = torch.tensor(np.float32(radius)) if pad is None else pad
    cells, live = tvcm._probe_cells(grid, pad, list(t(queries).T),
                                    torch.ones(len(queries), dtype=bool),
                                    num_cells)
    start = torch.cumsum(grid.count, 0) - grid.count
    return grid, start[cells].T, torch.where(live, grid.count[cells], 0).T


@pytest.mark.parametrize("seed,radius,num_cells", [(1, 0.05, 1024),
                                                   (2, 0.2, 64)])
def test_grid_matches_jax(seed, radius, num_cells):
    """The pair merge's cell hashes, counts and probed (start, count) rows
    equal the JAX hash grid's, and so do the pairs expand_pairs lists."""
    pos = _points(seed, 3000)
    valid = np.random.default_rng(seed + 9).random(3000) < 0.8
    # Queries inside, at the edges and outside the particle bbox.
    queries = _points(seed + 1, 400, -0.1, 1.1)
    jg = jgrid.build(jfrom_array(jnp.asarray(pos)), jnp.asarray(valid),
                     jnp.float32(radius), num_cells)
    # JAX's query_cell_ranges pads the bbox by half a cell.
    pad = torch.tensor(np.float32(0.5) / np.asarray(jg.inv_cell_size))
    grid, starts, counts = _port_grid(pos, valid, queries, radius,
                                      num_cells, pad)
    assert float(grid.inv_cell) == np.asarray(jg.inv_cell_size)
    close(grid.count, jg.cell_count)
    assert torch.equal(torch.sort(grid.hashes, stable=True).indices,
                       torch.from_numpy(np.asarray(jg.sorted_idx,
                                                   np.int64)))
    for mine, theirs in zip(grid.mins + grid.maxs,
                            (jg.bbox_min_x, jg.bbox_min_y, jg.bbox_min_z,
                             jg.bbox_max_x, jg.bbox_max_y, jg.bbox_max_z)):
        close(mine, theirs, rtol=0, atol=0)

    want = jgrid.query_cell_ranges(jg, num_cells,
                                   jfrom_array(jnp.asarray(queries)))
    close((starts, counts), want)
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
    """Every (query, particle) pair within the radius is a candidate of
    the pair merge's grid."""
    pos = _points(2, 4000)
    valid = np.random.default_rng(3).random(4000) < 0.9
    queries = _points(4, 256, 0.1, 0.9)
    radius, num_cells = 0.05, 1024
    grid, starts, counts = _port_grid(pos, valid, queries, radius,
                                      num_cells)
    qc, ppos, ok, total, ovf = tgrid.expand_pairs(starts, counts,
                                                  int(counts.sum()))
    assert int(ovf) == 0 and bool(ok.all())
    q = (qc // 8).numpy()
    p = torch.sort(grid.hashes, stable=True).indices[ppos].numpy()
    d2 = ((pos[p] - queries[q]) ** 2).sum(-1)
    keep = (d2 <= radius * radius) & valid[p]
    mine = set(zip(q[keep], p[keep]))
    d2_all = ((queries[:, None, :] - pos[None]) ** 2).sum(-1)
    qi, pi = np.nonzero((d2_all <= radius * radius) & valid[None])
    assert mine == set(zip(qi, pi)) and len(mine) > 100


# -- pair-expansion merge -----------------------------------------------------


def _case(res, seed, span_radii):
    """test_merge_stage.py's synthetic vertices at res x res paths."""
    n = res * res
    js = jload((res, res), SCENE_CONFIGS[1])
    ts = tload((res, res), SCENE_CONFIGS[1], device="cpu")
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
    return want, np.asarray(stats)


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
    want, jstats = _jax_merge(js, misc, queries, light_verts, ppm, n,
                              pair_factor)
    tm, tq, tl = (_port_misc(misc), _port_vertices(queries),
                  _port_vertices(light_verts))
    # The JAX call's cell count and caps: probe cells that collide in the
    # hash visit their photons twice, in the reference's grid too.
    pair_args = (ts, tm, tq, tl, 2 * n, pair_factor * n, ppm, 7, 0, 5 * n,
                 4 * n, n)
    pair, ovf, stats = tvcm.merge_stage(*pair_args)
    assert int(ovf) == 0 and stats.tolist() == jstats.tolist()
    if span_radii < 10:
        assert float(pair.x.abs().sum()) > 0.0
    close(pair, want, rtol=3e-5, atol=1e-7)
    close(TM.merge_stage(ts, tm, tq, tl, ppm, 7, 0, n), want, rtol=3e-5,
          atol=1e-7)
    # Four query chunks give the same sums.
    close(tvcm.merge_stage(*pair_args, merge_chunks=4)[0], want, rtol=3e-5,
          atol=1e-7)


def test_pair_merge_empty_and_min_length():
    js, ts, misc, queries, light_verts = _case(8, 0, 6.0)
    args = (ts, _port_misc(misc), _port_vertices(queries))
    lv = _port_vertices(light_verts)
    dead = lv._replace(valid=torch.zeros_like(lv.valid))
    caps = (1024 * 64, False, 7, 0, 320, 256, 64)
    got, ovf, stats = tvcm.merge_stage(*args, dead, 128, *caps)
    assert all(float(c.abs().sum()) == 0.0 for c in got)
    assert int(ovf) == 0 and stats.tolist()[:2] == [0, 0]
    want, ovf, _ = jvcm.merge_stage(
        js, misc, queries, light_verts, num_cells=128, pair_cap=1024 * 64,
        ppm=False, max_path_length=6, min_path_length=4, photon_cap=320,
        query_cap=256, n_paths=64)
    assert int(ovf) == 0
    close(tvcm.merge_stage(*args, lv, 128, 1024 * 64, False, 6, 4, 320, 256,
                           64)[0], want, rtol=3e-5, atol=1e-7)


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
    scene = tload((res, res), SCENE_CONFIGS[0], device="cpu")
    img, _, _, _ = R.render(scene, cfg)
    assert_image_close(img, want, rtol=1e-4 if use_vc else 1e-3)
    tile_cfg = R.RenderConfig(**{**cfg.__dict__, "merge_backend": "auto"})
    tile, _, _, _ = R.render(scene, tile_cfg)
    assert_image_close(img, tile.numpy(), rtol=1e-4)
