"""PyTorch port vs the JAX package: masked occlusion and the kernels'
packed scene block.

``occluded(..., active)`` must equal the JAX ``occluded`` AND the mask,
exactly: on the CPU both sides take the plain sweep, and the answer is a
boolean. The broadcast point, the block layout (which the CUDA source
reads at fixed offsets) and the wrappers' capacity checks are tested here;
the kernels themselves are held against these plain versions on a card
(test_torch_cuda.py).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smallvcm_tpu.ops import intersect as jint
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import diff
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import pathtracer as tpt
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import intersect as tint
from smallvcm_tpu_torch.ops import sweep as S
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_torch_core import close, jv, t, tv, unit_dirs

torch.set_num_threads(2)

SOURCE = (Path(__file__).resolve().parent.parent / "smallvcm_tpu_torch"
          / "csrc" / "intersect_sweep.cu")
_LO = np.array([[-1.27], [-1.25], [-1.28]], np.float32)
_HI = np.array([[1.28], [1.30], [1.28]], np.float32)


def _shadow_rays(seed, n, active_frac=0.35):
    r = np.random.default_rng(seed)
    org = (_LO + (_HI - _LO) * r.random((3, n))).astype(np.float32)
    dist = r.uniform(0.0, 3.0, n).astype(np.float32)
    return org, unit_dirs(r, n), dist, r.random(n) < active_frac


@pytest.mark.parametrize("config", SCENE_CONFIGS)
def test_occluded_masked_matches_jax(config):
    js, ts = jload((8, 8), config), tload((8, 8), config, device="cpu")
    org, d, dist, active = _shadow_rays(20 + config, 4000)
    blocked = np.asarray(jint.occluded(js, jv(org), jv(d), dist))
    assert 0 < blocked.sum() < blocked.size
    got = tint.occluded(ts, tv(org), tv(d), t(dist), t(active))
    close(got, blocked & active)
    close(tint.occluded(ts, tv(org), tv(d), t(dist)), blocked)


def test_inactive_lanes_are_false():
    ts = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    org, d, dist, _ = _shadow_rays(7, 2000)
    dist[:] = 10.0  # past the walls: most rays are blocked
    blocked = tint.occluded(ts, tv(org), tv(d), t(dist))
    assert blocked.float().mean() > 0.5
    for frac in (0.0, 0.35, 1.0):
        active = t(np.random.default_rng(8).random(2000) < frac)
        got = tint.occluded(ts, tv(org), tv(d), t(dist), active)
        assert not bool(got[~active].any())
        assert torch.equal(got[active], blocked[active])


@pytest.mark.parametrize("lead", ["expanded", "unsqueezed"])
def test_broadcast_point_matches_materialized(lead):
    ts = tload((8, 8), SCENE_CONFIGS[1], device="cpu")
    w, n = 3, 500
    org, _, _, _ = _shadow_rays(11, n)
    _, d, dist, active = _shadow_rays(12, w * n)
    point = tv(org)
    view = (V3(*(a[None].expand(w, n) for a in point)) if lead == "expanded"
            else V3(*(a[None] for a in point)))
    d, dist, active = (V3(*(t(c).reshape(w, n) for c in d)),
                       t(dist).reshape(w, n), t(active).reshape(w, n))
    full = V3(*(a[None].repeat(w, 1) for a in point))

    shape, p_flat, _, _, _ = S.occlusion_operands(view, d, dist, active)
    assert shape == (w, n) and p_flat.x.shape == (n,)
    idx = torch.arange(w * n) % n  # the kernel's point[i % n_point]
    for a, b in zip(p_flat, full):
        assert torch.equal(a[idx], b.reshape(-1))
    _, p_full, _, _, _ = S.occlusion_operands(full, d, dist, active)
    assert p_full.x.shape == (w * n,)

    got = tint.occluded(ts, view, d, dist, active)
    want = tint.occluded(ts, full, d, dist, active)
    assert got.shape == (w, n) and torch.equal(got, want)
    assert bool(got.any())


def test_source_block_constants_match():
    src = SOURCE.read_text()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kMaxTri"), const("kMaxSph"), const("kTriFloats"),
            const("kSphFloats")) == (S.MAX_TRI, S.MAX_SPH, S.TRI_FLOATS,
                                     S.SPH_FLOATS)
    # The any-hit launch: the block the plan counts in, and a mask read
    # for every lanes-a-thread the plan can pick.
    assert const("kBlock") == S.OCCLUDED_BLOCK
    assert const("kMaxLanes") == S.MAX_LANES_PER_THREAD
    cases = {int(v) for v in re.findall(r"case (\d+): SVCM_OCCLUDED", src)}
    assert cases == {2 ** k for k in range(S.MAX_LANES_PER_THREAD
                                           .bit_length())}


@pytest.mark.parametrize("n_sm", [1, 132, 144])
def test_occluded_plan_covers_every_lane(n_sm):
    """The launch plan over lane counts from none to 2^31 - 1: V a power of
    two up to the cap, a grid that covers every lane with no empty block,
    the widest window that keeps MIN_BLOCKS_PER_SM blocks an SM, and V
    never shrinking as the lanes grow."""
    per = S.OCCLUDED_BLOCK * S.MIN_BLOCKS_PER_SM * n_sm
    ms = sorted({0, 1, 255, 256, 257, 4096, 262_144, 1_179_648, 2_097_152,
                 2 ** 31 - 1, *(k * per + e for k in (1, 2, 4, 8, 16, 32)
                                for e in (-1, 0, 1))})
    last = 1
    for m in ms:
        v, blocks = S.occluded_plan(m, n_sm)
        window = S.OCCLUDED_BLOCK * v
        assert v in (1, 2, 4) and v <= S.MAX_LANES_PER_THREAD
        assert blocks * window >= m and (blocks - 1) * window < m
        assert v >= last
        last = v
        if v > 1:
            assert blocks >= S.MIN_BLOCKS_PER_SM * n_sm
        if v < S.MAX_LANES_PER_THREAD:
            wider = -(-m // (2 * window))
            assert wider < S.MIN_BLOCKS_PER_SM * n_sm


def test_occluded_plan_edges():
    n_sm = 132
    per = S.OCCLUDED_BLOCK * S.MIN_BLOCKS_PER_SM * n_sm  # blocks at V = 1
    assert S.occluded_plan(0, n_sm) == (1, 0)
    assert S.occluded_plan(1, n_sm) == (1, 1)
    assert S.occluded_plan(S.OCCLUDED_BLOCK + 1, n_sm) == (1, 2)
    # V doubles where the doubled window still fills every SM.
    edge = 2 * per - 2 * S.OCCLUDED_BLOCK
    assert S.occluded_plan(edge, n_sm) == (1, 2 * S.MIN_BLOCKS_PER_SM * n_sm
                                           - 2)
    assert S.occluded_plan(edge + 1, n_sm) == (2, S.MIN_BLOCKS_PER_SM * n_sm)
    assert S.occluded_plan(4 * per, n_sm)[0] == 4
    assert S.occluded_plan(2 ** 31 - 1, n_sm)[0] == S.MAX_LANES_PER_THREAD
    # The main path's calls on an H100's 132 SMs: one pass of rays at two
    # lanes a thread, vertex connections of two to eight passes at four.
    assert S.occluded_plan(262_144, n_sm) == (2, 512)
    assert S.occluded_plan(524_288, n_sm) == (4, 512)
    assert S.occluded_plan(2_097_152, n_sm) == (4, 2048)
    for bad in ((-1, n_sm), (16, 0)):
        with pytest.raises(ValueError):
            S.occluded_plan(*bad)


@pytest.mark.parametrize("config", SCENE_CONFIGS)
def test_pack_scene_puts_every_field_at_its_offset(config):
    ts = tload((8, 8), config, device="cpu")
    block = S.pack_scene(ts)
    data = block.data
    assert data.dtype == torch.float32 and data.device.type == "cpu"
    assert data.shape == (S.BLOCK_FLOATS,)
    assert (block.n_tri, block.n_sph) == (ts.tri_mat.shape[0],
                                          ts.sph_mat.shape[0])
    for k in range(block.n_tri):
        row = data[k * S.TRI_FLOATS:(k + 1) * S.TRI_FLOATS]
        for f, v in enumerate((ts.tri_p0, ts.tri_p1, ts.tri_p2,
                               ts.tri_normal)):
            assert torch.equal(row[3 * f:3 * f + 3],
                               torch.stack([c[k] for c in v]))
    sph0 = S.MAX_TRI * S.TRI_FLOATS
    for k in range(block.n_sph):
        row = data[sph0 + k * S.SPH_FLOATS:sph0 + (k + 1) * S.SPH_FLOATS]
        assert torch.equal(row[:3], torch.stack([c[k] for c in
                                                 ts.sph_center]))
        assert row[3] == ts.sph_radius[k]
    assert not bool(data[block.n_tri * S.TRI_FLOATS:sph0].any())
    assert not bool(data[sph0 + block.n_sph * S.SPH_FLOATS:].any())


def test_scene_block_is_kept_per_scene():
    ts = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    assert S.scene_block(ts) is S.scene_block(ts)
    # A new scene with the same geometry (the gradient path's
    # apply_params) reuses the block; new geometry packs anew.
    params = diff.extract_params(ts)
    relit = diff.apply_params(ts, params._replace(
        light_intensity=params.light_intensity * 2.0))
    assert relit is not ts and S.scene_block(relit) is S.scene_block(ts)
    moved = dataclasses.replace(ts, tri_p0=ts.tri_p0 + 0.5)
    assert S.scene_block(moved) is not S.scene_block(ts)
    assert torch.equal(S.scene_block(moved).data[:3],
                       S.scene_block(ts).data[:3] + 0.5)
    big = dataclasses.replace(ts, sph_radius=ts.sph_radius * 2.0)
    assert S.scene_block(big).data[S.MAX_TRI * S.TRI_FLOATS + 3] == \
        2.0 * S.scene_block(ts).data[S.MAX_TRI * S.TRI_FLOATS + 3]


def _grow(ts, extra_tri, extra_sph):
    cat = lambda a, k: torch.cat([a, a[:1].repeat(k)])
    cat3 = lambda v, k: V3(*(cat(a, k) for a in v))
    return dataclasses.replace(
        ts, tri_p0=cat3(ts.tri_p0, extra_tri),
        tri_p1=cat3(ts.tri_p1, extra_tri), tri_p2=cat3(ts.tri_p2, extra_tri),
        tri_normal=cat3(ts.tri_normal, extra_tri),
        tri_mat=cat(ts.tri_mat, extra_tri),
        sph_center=cat3(ts.sph_center, extra_sph),
        sph_radius=cat(ts.sph_radius, extra_sph),
        sph_mat=cat(ts.sph_mat, extra_sph))


@pytest.mark.parametrize("extra", [(S.MAX_TRI - 20 + 1, 0),
                                   (0, S.MAX_SPH - 2 + 1)])
def test_wrappers_refuse_scene_above_capacity(extra):
    # 20 triangles, 2 spheres
    ts = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    fits = _grow(ts, extra[0] - 1 if extra[0] else 0,
                 extra[1] - 1 if extra[1] else 0)
    S.pack_scene(fits)  # exactly at capacity
    big = _grow(ts, *extra)
    org, d, dist, active = _shadow_rays(3, 16)
    before = (S.sweep_kernel.launches, S.occluded_kernel.launches)
    with pytest.raises(ValueError, match="capacity"):
        S.pack_scene(big)
    with pytest.raises(ValueError, match="capacity"):
        S.sweep_kernel(big, tv(org), tv(d))
    with pytest.raises(ValueError, match="capacity"):
        S.occluded_kernel(big, tv(org), tv(d), t(dist), t(active))
    assert (S.sweep_kernel.launches, S.occluded_kernel.launches) == before
    # The plain versions have no capacity.
    got = tint.occluded(big, tv(org), tv(d), t(dist), t(active))
    assert got.shape == (16,)


@pytest.mark.parametrize("alg", ["vcm", "bpt", "lt", "pt"])
def test_masks_leave_images_unchanged(monkeypatch, alg):
    """Each call site's mask only skips lanes its caller discards: the
    image equals, bit for bit, the one rendered with every shadow ray
    traced (the unmasked occlusion test)."""
    scene = tload((16, 16), SCENE_CONFIGS[0], device="cpu")
    cfg = R.RenderConfig(algorithm=alg, iterations=1, resolution=(16, 16))
    masked, _, _, rays = R.render(scene, cfg)
    unmasked = lambda s, p, d, dist, active=None: tint.occluded(s, p, d, dist)
    monkeypatch.setattr(tvcm, "occluded", unmasked)
    monkeypatch.setattr(tpt, "occluded", unmasked)
    want, _, _, want_rays = R.render(scene, cfg)
    assert float(want.abs().sum()) > 0.0
    assert torch.equal(masked, want) and rays == want_rays
