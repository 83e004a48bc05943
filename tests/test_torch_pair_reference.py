"""The benchmark's plain pair merge (benchmark/reference/pairs.py) against
the port's pair merge (algorithms/vcm.py::merge_stage) on the CPU: the
same sums from the same light and camera vertices, the same blocks as
``render.render`` with ``merge_backend="xla"``, and, where two probe cells
of a query share a hash bucket, the bucket visited twice, which the cell
merge's reference (benchmark/reference/compute.py) does not do.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pair_reference.py -q
"""

import json

import pytest
import torch

from benchmark.harness import env
from benchmark.reference import compute, pairs
from benchmark.reference.svcm.ops import merge as ref_cell_merge
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.scene.scene import load_cornell_box

torch.set_num_threads(2)

SEED = 2 ** 31 + 4099          # the renderer keys on its low 32 bits
BASE = SEED & 0xFFFFFFFF
FLAGS = {"vcm": (True, False), "ppm": (False, True)}   # (use_vc, ppm)


def _config(res: int, alg: str = "vcm") -> dict:
    """The cell's configuration at ``res`` x ``res``, its merge radius
    widened to 5% of the scene's (0.3% finds almost no photon pair among
    so few paths)."""
    path = env.ROOT / "benchmark" / "configs" / "vcm_cornell_512_xla.json"
    config = json.loads(path.read_text())
    config.update(resolution=[res, res], algorithm=alg, radius_factor=0.05)
    return config


def _vertices(config: dict, iteration: int):
    """The port's light and camera vertices of one iteration -> (port
    scene, reference scene, misc, queries, light vertices, n)."""
    res_x, res_y = config["resolution"]
    n = res_x * res_y
    use_vc, ppm = FLAGS[config["algorithm"]]
    scene = load_cornell_box((res_x, res_y), config["scene_mask"],
                             device="cpu")
    misc = vcm.compute_misc(scene, iteration, n, config["radius_factor"],
                            config["radius_alpha"], use_vc, True)
    verts, queries = vcm.trace_iteration(
        scene, iteration, res_x, res_y, BASE, config["max_path_length"],
        config["min_path_length"], config["radius_factor"],
        config["radius_alpha"], use_vc, ppm, config["rng"])
    return (scene, compute.build_scene(config, "cpu"), misc, queries, verts,
            n)


def _port_merge(scene, misc, queries, verts, n, ppm, config,
                num_cells=None):
    """The port's pair merge at caps nothing overflows -> color V3."""
    pad = lambda x: -(-x // 8) * 8
    color, overflow, _ = vcm.merge_stage(
        scene, misc, queries, verts, 8 * n if num_cells is None else
        num_cells, 4096 * n, ppm, config["max_path_length"],
        config["min_path_length"], pad(verts.valid.numel()),
        pad(queries.valid.numel()), n)
    assert int(overflow) == 0
    return color


def _ref_merge(ref_scene, misc, queries, verts, n, ppm, config,
               num_cells=None):
    return pairs.merge(ref_scene, misc, queries, verts, ppm,
                       config["max_path_length"], config["min_path_length"],
                       n, num_cells)


def _stack(v):
    return torch.stack(list(v), dim=1)


@pytest.mark.parametrize("res,alg,it", [(16, "vcm", 0), (16, "ppm", 2),
                                        (32, "vcm", 5)])
def test_pair_merge_equals_the_port_merge_stage(res, alg, it):
    config = _config(res, alg)
    scene, ref_scene, misc, queries, verts, n = _vertices(config, it)
    ppm = FLAGS[alg][1]
    want = _stack(_port_merge(scene, misc, queries, verts, n, ppm, config))
    got = _stack(_ref_merge(ref_scene, misc, queries, verts, n, ppm,
                            config))
    assert float(want.abs().sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_block_sum_equals_render_with_the_pair_merge():
    config = _config(16)
    scene = load_cornell_box((16, 16), config["scene_mask"], device="cpu")
    cfg = R.RenderConfig(
        algorithm="vcm", iterations=5, resolution=(16, 16), base_seed=BASE,
        max_path_length=config["max_path_length"],
        radius_factor=config["radius_factor"],
        radius_alpha=config["radius_alpha"], merge_backend="xla",
        block_size=2)
    kept = []
    R.render(scene, cfg, accum=torch.zeros((16, 16, 3)), start_iter=3,
             block_cb=lambda accum, done: kept.append(accum.clone()))
    want = kept[-1]
    got = pairs.block_sum(config, BASE, 3, 2, "cpu")
    assert float(want.abs().sum()) > 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def _doubled_paths(verts, queries, misc, num_cells: int, n: int):
    """Paths that own a live query two of whose 8 probed cells share one
    of ``num_cells`` buckets, by the hash alone."""
    flat = lambda a: a.reshape(-1)
    live = flat(verts.valid)
    pos = [flat(c)[live] for c in verts.position]
    mins = [a.min() for a in pos]
    radius = torch.tensor(misc.radius, dtype=torch.float32)
    inv_cell = torch.reciprocal(radius * 2.0)
    q = torch.nonzero(flat(queries.valid)).flatten()
    rel = [(flat(c)[q] - mn) * inv_cell for c, mn in zip(queries.position,
                                                        mins)]
    base = [torch.floor(r).long() for r in rel]
    side = [torch.where(r - torch.floor(r) < 0.5, -1, 1) for r in rel]
    cells = torch.stack([pairs._hash(
        [b + (s if j >> k & 1 else 0) for k, (b, s) in
         enumerate(zip(base, side))], num_cells) for j in range(8)], dim=1)
    same = (cells[:, :, None] == cells[:, None, :]).sum((1, 2)) > 8
    return set(torch.remainder(q[same], n).tolist())


def test_colliding_probe_cells_visit_a_bucket_twice():
    """With 61 buckets many queries probe one bucket from two cells: the
    pair reference equals the port there, and the cell merge's reference,
    which visits each photon once, differs on exactly those queries'
    paths (elsewhere it agrees up to summation order)."""
    config = _config(16)
    scene, ref_scene, misc, queries, verts, n = _vertices(config, 1)
    cells = 61
    want = _stack(_port_merge(scene, misc, queries, verts, n, False, config,
                              cells))
    got = _stack(_ref_merge(ref_scene, misc, queries, verts, n, False,
                            config, cells))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)

    once = _stack(ref_cell_merge.merge_stage(
        ref_scene, misc, queries, verts, False, config["max_path_length"],
        config["min_path_length"], n))
    gap = (got - once).abs().amax(1) > 1e-6 * once.abs().amax(1) + 1e-7
    differ = set(torch.nonzero(gap).flatten().tolist())
    doubled = _doubled_paths(verts, queries, misc, cells, n)
    assert differ and differ <= doubled
    assert (got >= once - 1e-6 * once.abs() - 1e-7).all()  # only more
    rest = torch.tensor(sorted(set(range(n)) - doubled))
    torch.testing.assert_close(got[rest], once[rest], rtol=1e-6, atol=1e-7)


def test_bfloat16_control_differs():
    config = _config(16)
    f32 = pairs.block_sum(config, 7, 0, 2, "cpu")
    bf16 = pairs.block_sum(config, 7, 0, 2, "cpu", dtype=torch.bfloat16)
    assert not torch.equal(f32, bf16)
