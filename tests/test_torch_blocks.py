"""The port's block runner (render.py, vcm.render_block_with_stats) on the CPU.

* A block of the port against the JAX package's ``render_block_with_stats``
  (XLA merge, loop-form camera, as tests/test_torch_slice.py runs it) for
  vcm and ppm, at that file's tolerance: rtol 1e-4 / atol 1e-6 on at least
  99% of pixels and the mean to 1e-4 relative; overflow 0 on both sides.
* The merge at static caps, with caps above the live counts, is bit for
  bit the live-count merge (tables exactly the live rows, sentinel rows
  dropped before the scatters), rebuilt here from the plain pieces; the
  scatter that adds +0.0 rows in place of dropped ones gives the bits of
  dropping them.
* Tiny frozen caps overflow, grow and render the same block again, to the
  bytes of generous caps.
* ``_bucket``, the grow rule and ``auto_block_size`` are the JAX package's;
  the caps-cache key has its format and the port's cache round-trips in a
  directory of its own.
* Resuming at a block boundary and in the middle of a schedule is bit
  exact, and so is any partition into blocks.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu import render as JR
from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import checkpoint as ckpt
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.io import framebuffer as tfb
from smallvcm_tpu_torch.ops import merge as M
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_torch_slice import assert_image_close

torch.set_num_threads(2)

RES = 16
N = RES * RES


@pytest.fixture(autouse=True)
def caps_cache(tmp_path, monkeypatch):
    """Each test's merge caps in a cache directory of its own."""
    monkeypatch.setenv("SMALLVCM_TPU_TORCH_CACHE", str(tmp_path / "caps"))
    return tmp_path / "caps" / "caps.json"


@pytest.mark.parametrize("alg,kw", [
    ("vcm", {}),
    ("ppm", dict(radius_factor=0.05)),   # merges at 16x16
])
def test_block_matches_jax_block(alg, kw):
    use_vc, use_vm, lt_only, ppm = R._VCM_FLAGS[alg]
    flags = dict(use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only,
                 ppm=ppm, **kw)
    want, jrays, jovf, jstats, _ = jvcm.render_block_with_stats(
        jload((RES, RES), SCENE_CONFIGS[0]), 0, RES, RES, block=3,
        merge_backend="xla", camera_unroll="off", pair_factor=64.0,
        photon_factor=4.0, query_factor=4.0, **flags)
    got, rays, ovf, stats, lum = tvcm.render_block_with_stats(
        tload((RES, RES), SCENE_CONFIGS[0], device="cpu"), 0, RES, RES, 3,
        photon_factor=4.0, query_factor=4.0, **flags)
    assert int(jovf) == 0 and int(ovf) == 0
    assert abs(int(rays) / int(jrays) - 1.0) < 1e-3
    assert int(stats[1]) > 0 and int(stats[2]) > 0
    assert float(lum) == float(tfb.total_luminance(got))
    assert_image_close(got.numpy(), np.asarray(want))


def _iteration_vertices(alg, radius_factor=0.05):
    """One real 16x16 iteration's light vertices and merge queries."""
    use_vc, _, _, ppm = R._VCM_FLAGS[alg]
    scene = tload((RES, RES), SCENE_CONFIGS[1], device="cpu")
    misc = tvcm.compute_misc(scene, 1, N, radius_factor, 0.75, use_vc, True)
    verts, queries = tvcm.trace_iteration(scene, 1, RES, RES, 1234, 10, 0,
                                          radius_factor, 0.75, use_vc, ppm)
    return scene, misc, queries, verts, ppm


def _live_count_merge(scene, misc, queries, verts, ppm):
    """The live-count merge the port ran before static caps: the tables
    hold exactly the live rows (counted on the host), and the per-query and
    per-path scatters drop sentinel rows by a boolean mask."""
    n_p = int(verts.valid.sum())
    n_q = int(queries.valid.sum())
    t = M.merge_prep(scene, misc, queries, verts, N, photon_cap=n_p,
                     query_cap=n_q)
    assert t.qtab.shape[0] == n_q and t.ptab.shape[0] == n_p
    out = torch.zeros((n_q, 3))
    for qs, ps in M.candidate_pairs(t.ranges):
        d = t.qpos[qs] - t.ppos[ps]
        tlen = t.qpos[qs, 3] + t.ppos[ps, 3]
        keep = torch.nonzero(
            (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
             <= misc.radius_sqr) & (tlen <= 10) & (tlen >= 0)).flatten()
        qs, ps = qs[keep], ps[keep]
        q, p = t.qtab[qs], t.ptab[ps]
        blocks = M._dense_block(
            misc.radius_sqr, misc.mis_vc_weight, lambda j: q[:, j],
            lambda j: p[:, j], max_path_length=10, min_path_length=0,
            ppm=ppm)
        out = out + torch.zeros((n_q, 3)).index_add_(
            0, qs, torch.stack(blocks, dim=1))
    scaled = out.T * t.qtab[:, 29:32].T * misc.vm_normalization
    z = torch.zeros((N, 3)).index_add_(0, t.q_path, scaled.T)
    return z, n_p, n_q


@pytest.mark.parametrize("alg", ["vcm", "bpm", "ppm"])
def test_capped_merge_bit_equal_to_live_count_merge(alg):
    scene, misc, queries, verts, ppm = _iteration_vertices(alg)
    want, n_p, n_q = _live_count_merge(scene, misc, queries, verts, ppm)
    assert float(want.abs().sum()) > 0.0
    for caps in ((n_p + 1, n_q + 7), (2 * n_p, 3 * n_q), (None, None)):
        color, overflow, stats = M.merge_stage(
            scene, misc, queries, verts, ppm, 10, 0, N, *caps,
            with_stats=True)
        got = torch.stack(list(color), dim=1)
        assert torch.equal(got, want), caps
        assert int(overflow) == 0 and stats[1:].tolist() == [n_p, n_q]
    # One row short of either live count overflows, and says so.
    for caps, flag in (((n_p - 1, n_q), 1), ((n_p, n_q - 1), 1),
                       ((n_p - 1, n_q - 1), 2)):
        _, overflow, stats = M.merge_stage(
            scene, misc, queries, verts, ppm, 10, 0, N, *caps,
            with_stats=True)
        assert int(overflow) == flag and stats[1:].tolist() == [n_p, n_q]


def test_scatter_of_sentinel_rows_is_bit_equal_to_dropping_them():
    """+0.0 rows at spread indices in place of dropped sentinel rows: the
    same bits, with non-finite and -0.0 values among the rows."""
    rng = np.random.default_rng(3)
    n_rows, m = 37, 2000
    index = torch.from_numpy(rng.integers(0, n_rows + 1, m))
    index[:400] = n_rows                       # a hot sentinel
    rows = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    rows[index == n_rows] = torch.tensor([np.nan, np.inf, -np.inf])
    rows[5:9] = -0.0
    keep = index < n_rows
    want = torch.zeros((n_rows, 3)).index_add_(0, index[keep], rows[keep])
    got = tfb.deterministic_index_add(n_rows, index, rows)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_forced_overflow_grows_caps_and_rerenders_same_bytes(capsys):
    scene = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    kw = dict(algorithm="vcm", iterations=3, resolution=(RES, RES),
              block_size=3, merge_caps_frozen=True)
    want, _, _, want_rays = R.render(
        scene, R.RenderConfig(photon_factor=9.0, query_factor=9.0, **kw))
    assert "overflow" not in capsys.readouterr().out
    cfg = R.RenderConfig(photon_factor=0.05, query_factor=0.05, **kw)
    got, _, done, rays = R.render(scene, cfg)
    out = capsys.readouterr().out
    assert out.count("merge cap overflow; re-rendering block at "
                     "iteration 0") == 1
    assert done == 3 and rays == want_rays
    assert torch.equal(got, want)
    # Grown to the need (x1.1, bucketed) of the worst iteration.
    assert cfg.photon_factor > 0.05 and cfg.query_factor > 0.05
    n_p, n_q = (max(tvcm.merge_measure_iteration(scene, it, RES, RES)[k]
                    for it in range(3)) for k in (1, 2))
    assert cfg.photon_factor == R._grow(0.05, n_p, N)
    assert cfg.query_factor == R._grow(0.05, n_q, N)


def test_overflow_that_never_stops_growing_raises(monkeypatch):
    scene = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    monkeypatch.setattr(R, "_grow", lambda factor, need, n: factor)
    cfg = R.RenderConfig(algorithm="bpm", iterations=1, resolution=(8, 8),
                         photon_factor=0.05, query_factor=0.05,
                         merge_caps_frozen=True)
    with pytest.raises(RuntimeError, match="still overflow"):
        R.render(scene, cfg)


NEEDS = [0, 1, 1023, 1024, 1025, 1279, 1280, 1281, 5000, 65535, 65536,
         317_000, 690_000, 1_000_003, 4_194_304, 9_999_999]


@pytest.mark.parametrize("n", [64, 4096, 262_144, 4_194_304])
def test_bucket_and_grow_rule_match_jax(n):
    for need in NEEDS:
        assert R._bucket(need, n) == JR._bucket(need, n)
        for factor in (0.05, 1.25, 3.0):
            # render.py:474-477 of the JAX package, inline there.
            jax_grow = max(factor, JR._bucket(need * 1.1, n))
            assert R._grow(factor, need, n) == jax_grow


@pytest.mark.parametrize("res", [(16, 16), (512, 512), (2048, 1024)])
def test_auto_block_size_matches_jax(res):
    for alg in R.ALGORITHMS:
        for block in (0, 1, 5):
            ours = R.auto_block_size(R.RenderConfig(resolution=res,
                                                    block_size=block), alg)
            theirs = JR.auto_block_size(JR.RenderConfig(
                resolution=res, block_size=block), alg)
            assert ours == theirs
    assert (R.DEFAULT_BLOCK, R.DEFAULT_BLOCK_SIMPLE) == (
        JR.DEFAULT_BLOCK, JR.DEFAULT_BLOCK_SIMPLE)
    jdefaults = JR.RenderConfig()
    assert (R.RenderConfig().photon_factor, R.RenderConfig().query_factor,
            R.RenderConfig().merge_caps_frozen) == (
        jdefaults.photon_factor, jdefaults.query_factor,
        jdefaults.merge_caps_frozen)


def test_caps_key_and_cache_round_trip(caps_cache, monkeypatch, tmp_path):
    monkeypatch.setenv("SMALLVCM_TPU_CACHE", str(tmp_path / "jax"))
    for sid, alg, kw in ((0, "vcm", {}), (1, "bpm", dict(base_seed=7)),
                         (3, "ppm", dict(rng_kind="tea", radius_factor=0.01,
                                         max_path_length=6))):
        cfg = R.RenderConfig(algorithm=alg, resolution=(RES, RES), **kw)
        jcfg = JR.RenderConfig(algorithm=alg, resolution=(RES, RES), **kw)
        for backend in ("pallas", "xla"):
            assert R._caps_key(
                tload((RES, RES), SCENE_CONFIGS[sid], device="cpu"), cfg, alg,
                backend) == JR._caps_key(
                    jload((RES, RES), SCENE_CONFIGS[sid]), jcfg, alg, backend)

    scene = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    assert R._caps_cache_file() == caps_cache
    calls = tvcm.merge_measure_iteration.calls
    cfg = R.RenderConfig(algorithm="vcm", resolution=(RES, RES))
    assert R._ensure_merge_caps(scene, cfg, "vcm") == "measured"
    assert tvcm.merge_measure_iteration.calls == calls + 1
    pairs, n_p, n_q = tvcm.merge_measure_iteration(scene, 0, RES, RES)
    assert (cfg.photon_factor, cfg.query_factor) == (
        R._bucket(n_p * 1.03, N), R._bucket(n_q * 1.03, N))
    # The cell key sizes the pair merge's cap too, never below the default.
    assert cfg.pair_factor == max(24.0, R._bucket(pairs * 1.15, N))
    assert cfg.merge_caps_frozen and caps_cache.exists()
    assert not (tmp_path / "jax").exists()

    again = R.RenderConfig(algorithm="vcm", resolution=(RES, RES))
    calls = tvcm.merge_measure_iteration.calls
    assert R._ensure_merge_caps(scene, again, "vcm") == "cached"
    assert tvcm.merge_measure_iteration.calls == calls
    assert R._caps_of(again) == R._caps_of(cfg)
    assert R._ensure_merge_caps(scene, again, "vcm") == "frozen"
    # Another configuration is another key.
    other = R.RenderConfig(algorithm="vcm", resolution=(RES, RES),
                           base_seed=5)
    assert R._ensure_merge_caps(scene, other, "vcm") == "measured"
    caps = dict(pair_factor=30.0, photon_factor=1.5, query_factor=2.5)
    R._save_cached_caps("k", caps)
    assert R._load_cached_caps("k") == caps
    assert R._load_cached_caps(R._caps_key(scene, cfg, "vcm", "pallas")) \
        == R._caps_of(cfg)


@pytest.mark.parametrize("alg", ["vcm", "pt"])
def test_any_partition_into_blocks_is_bit_exact(alg):
    """Blocks add their iterations to the running image one by one: the
    image of a block of 5 is that of five blocks of one."""
    scene = tload((RES, RES), SCENE_CONFIGS[1], device="cpu")
    imgs = []
    for block in (1, 2, 5):
        img, _, done, rays = R.render(scene, R.RenderConfig(
            algorithm=alg, iterations=5, resolution=(RES, RES),
            block_size=block))
        imgs.append((img, rays))
    for img, rays in imgs[1:]:
        assert torch.equal(img, imgs[0][0]) and rays == imgs[0][1]


def test_resume_at_a_block_boundary_is_bit_exact(tmp_path):
    scene = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    path = str(tmp_path / "state.npz")
    cfg = lambda i: R.RenderConfig(algorithm="vcm", iterations=i,
                                   resolution=(RES, RES), block_size=2)
    full, _, _, _ = ckpt.render_resumable(scene, cfg(6))
    ckpt.render_resumable(scene, cfg(4), checkpoint_path=path,
                          checkpoint_every=2)
    assert ckpt.load_checkpoint(path)[1] == 4
    resumed, _, done, _ = ckpt.render_resumable(scene, cfg(6),
                                                checkpoint_path=path)
    assert done == 6 and torch.equal(resumed, full)


def test_resume_mid_schedule_is_bit_exact(tmp_path, monkeypatch):
    """A run of 7 in blocks of 3 (0-2, 3-5, 6) faults after its first
    block, checkpointed there; the resumed run renders 3-5 and 6 and gives
    the uninterrupted image."""
    scene = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    path = str(tmp_path / "state.npz")
    cfg = R.RenderConfig(algorithm="bpm", iterations=7, resolution=(RES, RES),
                         block_size=3)
    full, _, _, _ = ckpt.render_resumable(scene, cfg)
    counter = tmp_path / "faults"
    monkeypatch.setenv("SMALLVCM_TEST_FAULT_AT", "3")
    monkeypatch.setenv("SMALLVCM_TEST_FAULT_COUNTER", str(counter))
    with pytest.raises(RuntimeError, match="injected test fault"):
        ckpt.render_resumable(scene, cfg, checkpoint_path=path,
                              checkpoint_every=1)
    assert counter.read_text() == "1"
    assert ckpt.load_checkpoint(path)[1] == 3
    resumed, _, done, _ = ckpt.render_resumable(scene, cfg,
                                                checkpoint_path=path)
    assert done == 7 and torch.equal(resumed, full)


def test_schedule_and_block_lines(capsys):
    """-i: full blocks, then single iterations, one -v line and one
    block_cb call a block."""
    scene = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    seen = []
    cfg = R.RenderConfig(algorithm="lt", iterations=8, resolution=(8, 8),
                         block_size=3)
    R.render(scene, cfg, verbose=True,
             block_cb=lambda acc, done: seen.append(done))
    assert seen == [3, 6, 7, 8]
    out = capsys.readouterr().out
    for a, b in ((0, 2), (3, 5), (6, 6), (7, 7)):
        assert f"iter {a}..{b}: luminance=" in out
