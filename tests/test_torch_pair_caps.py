"""The port's pair merge at static caps against the JAX package, on the CPU.

* (a) ``vcm.merge_stage`` against the JAX XLA ``vcm.merge_stage`` on the
  same seeded vertices (tests/test_merge_stage.py's ``_random_vertices``)
  at caps that cover and at caps that overflow the photons, the queries,
  the pairs of a chunk and its survivors, in 1, 2 and 4 query chunks, ppm
  on and off: overflow and stats equal as integers, the colour at rtol
  3e-5 / atol 1e-7 (test_torch_pairs.py's bound), under overflow too,
  since the port truncates where JAX does.
* (b) ``vcm.merge_demand_iteration`` equals JAX's exactly on the same
  vertices, and equals ``stats[0]`` of an uncapped merge.
* (c) ``render._ensure_merge_caps`` gives the JAX package's three factors
  for the ``xla`` and the cell (JAX ``pallas``) key, each package with a
  cache directory of its own; an entry without ``pair_factor`` is a miss.
* (d) A ``merge_backend="xla"`` VCM block: forced overflow grows the pair
  factor by JAX's rule and renders the same bytes; any partition into
  blocks is bit exact; the block equals JAX's ``render_block_with_stats``
  at the same caps (test_torch_slice.py's ``assert_image_close``).
* (e) ``diff.render_params`` and ``loss_and_grad`` at explicit caps that
  overflow the pair rows against JAX's (``jax.value_and_grad`` of its
  ``render_params`` under the same L2 loss) at rtol 1e-3.
* (f) Two gloo CPU ranks rendering with the pair merge from tiny caps:
  the summed overflow grows both ranks to the same caps, by JAX's rule
  over the rank's share of the paths, and the image equals the single
  process's within test_torch_sharding.py's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallvcm_tpu import diff as jdiff
from smallvcm_tpu import render as JR
from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import convert, diff
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.parallel import multihost
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_torch_core import close
from .test_torch_merge import _port_misc, _port_vertices
from .test_torch_pairs import _case
from .test_torch_slice import assert_image_close

torch.set_num_threads(2)

RES = 16
N = RES * RES


@pytest.fixture(autouse=True)
def caps_cache(tmp_path, monkeypatch):
    """Each test's caps in cache directories of its own, one a package."""
    monkeypatch.setenv("SMALLVCM_TPU_TORCH_CACHE", str(tmp_path / "port"))
    monkeypatch.setenv("SMALLVCM_TPU_CACHE", str(tmp_path / "jax"))
    return tmp_path


# -- (a) the capped merge -----------------------------------------------------

# (name, (res, seed, span in radii), caps as multiples of n: pair, photon,
# query; None: the case's exact candidate pairs) and the overflow kinds
# each must show. 8x8 seed 2 at 1.5 radii puts more than a quarter of the
# candidates within r, so its survivors overflow while its pairs fit.
CAP_CASES = {
    "covers": ((16, 4, 6.0), (400, 5, 4), ()),
    "photons": ((16, 4, 6.0), (400, 1, 4), ("photons",)),
    "queries": ((16, 4, 6.0), (400, 5, 1), ("queries",)),
    "pairs": ((16, 4, 6.0), (100, 5, 4), ("pairs",)),
    "survivors": ((8, 2, 1.5), (None, 5, 4), ("survivors",)),
    "sparse": ((32, 2, 120.0), (32, 4, 3), ()),
}
# (case, merge chunks, ppm): every case, every chunk count, ppm on and off.
CAP_RUNS = [("covers", 1, False), ("covers", 2, False), ("covers", 4, False),
            ("covers", 1, True), ("photons", 1, False), ("photons", 2, True),
            ("queries", 2, False), ("queries", 4, True), ("pairs", 1, False),
            ("pairs", 4, False), ("pairs", 2, True), ("survivors", 1, False),
            ("survivors", 1, True), ("sparse", 1, False), ("sparse", 4, True)]


def _merges(case, ppm, chunks):
    (res, seed, span), (pf, phf, qf), _ = CAP_CASES[case]
    n = res * res
    js, ts, misc, queries, light_verts = _case(res, seed, span)
    tq, tl, tm = (_port_vertices(queries), _port_vertices(light_verts),
                  _port_misc(misc))
    if pf is None:  # the exact candidate count: nothing but survivors spill
        pair_cap = int(tvcm.merge_stage(ts, tm, tq, tl, 2 * n, 10 ** 7, ppm,
                                        7, 0, 5 * n, 4 * n, n)[2][0])
    else:
        pair_cap = pf * n
    caps = dict(num_cells=2 * n, pair_cap=pair_cap, ppm=ppm,
                max_path_length=7, min_path_length=0, photon_cap=phf * n,
                query_cap=qf * n, n_paths=n, merge_chunks=chunks)
    want = jvcm.merge_stage(js, misc, queries, light_verts, **caps)
    got = tvcm.merge_stage(ts, tm, tq, tl, *caps.values())
    return want, got, dict(n=n, live=(int(tl.valid.sum()),
                                      int(tq.valid.sum())), **caps)


@pytest.mark.parametrize("case,chunks,ppm", CAP_RUNS)
def test_capped_merge_matches_jax(case, chunks, ppm):
    (want, w_ovf, w_stats), (got, ovf, stats), c = _merges(case, ppm, chunks)
    assert int(ovf) == int(w_ovf)
    assert stats.tolist() == np.asarray(w_stats).tolist()
    close(got, want, rtol=3e-5, atol=1e-7)
    # Which caps spill: photons and queries from the live counts, pairs
    # and survivors by elimination (their sum is the rest of overflow).
    n_p, n_q = c["live"]
    spill_p = max(n_p - c["photon_cap"], 0)
    spill_q = max(n_q - c["query_cap"], 0)
    rest = int(ovf) - spill_p - spill_q
    kinds = CAP_CASES[case][2]
    assert (spill_p > 0) == ("photons" in kinds)
    assert (spill_q > 0) == ("queries" in kinds)
    assert (rest > 0) == bool({"pairs", "survivors"} & set(kinds))
    if "survivors" in kinds:
        assert int(stats[0]) == c["pair_cap"]   # every pair had a row
    assert float(sum(v.abs().sum() for v in got)) > 0.0


def test_chunked_merge_is_bit_equal_to_one_chunk():
    """Each query lies in one chunk, whose per-query sums are taken in
    the same order: 1, 2 and 4 chunks give the same bits."""
    js, ts, misc, q, lv = _case(16, 4, 6.0)
    args = (ts, _port_misc(misc), _port_vertices(q), _port_vertices(lv),
            2 * N, 400 * N, False, 7, 0, 5 * N, 4 * N, N)
    one = tvcm.merge_stage(*args)
    for chunks in (2, 4):
        got = tvcm.merge_stage(*args, merge_chunks=chunks)
        assert all(torch.equal(a, b) for a, b in zip(got[0], one[0]))
        assert int(got[1]) == 0 and torch.equal(got[2], one[2])


def test_capped_merge_refuses_indivisible_query_cap():
    js, ts, misc, q, lv = _case(8, 0, 6.0)
    with pytest.raises(ValueError, match="multiple of merge_chunks"):
        tvcm.merge_stage(ts, _port_misc(misc), _port_vertices(q),
                         _port_vertices(lv), 128, 4096, False, 7, 0, 320,
                         250, 64, 4)


# -- (b) the demand -----------------------------------------------------------


@pytest.mark.parametrize("res,seed,span", [(16, 4, 6.0), (32, 2, 120.0)])
def test_merge_demand_matches_jax(res, seed, span):
    n = res * res
    js, ts, misc, q, lv = _case(res, seed, span)
    # The demand takes the radius of the radius factor (the case's 0.05).
    want = jvcm.merge_demand_iteration(
        js, 0, (None, None, q, lv, None, None, None), res, res, 0.05)
    tq, tl = _port_vertices(q), _port_vertices(lv)
    got = tvcm.merge_demand_iteration(ts, 0, (tl, tq), res, res, 0.05)
    assert got.tolist() == np.asarray(want).tolist()
    # Exact: the candidate pairs of the uncapped merge at 8 cells a path.
    stats = tvcm.merge_stage(ts, _port_misc(misc), tq, tl, 8 * n, 10 ** 7,
                             False, 7, 0, 5 * n, 4 * n, n)[2]
    assert got.tolist() == stats.tolist() and int(got[0]) > 0


# -- (c) cap sizing and the cache ---------------------------------------------


@pytest.mark.parametrize("alg,backend", [("vcm", "xla"), ("bpm", "auto")])
def test_ensure_merge_caps_matches_jax(alg, backend):
    kw = dict(radius_factor=0.05) if alg == "bpm" else {}
    scene = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    cfg = R.RenderConfig(algorithm=alg, resolution=(RES, RES),
                         merge_backend=backend, **kw)
    assert R._ensure_merge_caps(scene, cfg, alg) == "measured"
    jcfg = JR.RenderConfig(algorithm=alg, resolution=(RES, RES), **kw)
    use_vc, _, _, ppm = JR._VCM_FLAGS[alg]
    jbackend = "xla" if backend == "xla" else "pallas"
    JR._ensure_merge_caps(jload((RES, RES), SCENE_CONFIGS[0]), jcfg, alg,
                          jbackend, use_vc, ppm, "xla")
    assert R._caps_of(cfg) == {f: getattr(jcfg, f) for f in R.CAPS_FIELDS}
    key = R._caps_key(scene, cfg, alg, jbackend)
    assert R._load_cached_caps(key) == R._caps_of(cfg)
    # A second configuration object reads them back.
    again = R.RenderConfig(algorithm=alg, resolution=(RES, RES),
                           merge_backend=backend, **kw)
    assert R._ensure_merge_caps(scene, again, alg) == "cached"
    assert R._caps_of(again) == R._caps_of(cfg)


def test_cache_entry_without_pair_factor_is_a_miss():
    """An entry written before the pair merge had caps holds two of the
    three factors: it is measured again, never a KeyError."""
    scene = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    cfg = R.RenderConfig(algorithm="vcm", resolution=(8, 8),
                         merge_backend="xla")
    key = R._caps_key(scene, cfg, "vcm", "xla")
    R._save_cached_caps(key, dict(photon_factor=1.5, query_factor=2.5))
    assert R._load_cached_caps(key) is None
    calls = tvcm.merge_measure_iteration.calls
    assert R._ensure_merge_caps(scene, cfg, "vcm") == "measured"
    assert tvcm.merge_measure_iteration.calls == calls + 1
    assert set(R._load_cached_caps(key)) == set(R.CAPS_FIELDS)


# -- (d) blocks through the pair merge ----------------------------------------


def test_xla_block_matches_jax_block():
    kw = dict(photon_factor=4.0, query_factor=4.0)
    want, jrays, jovf, jstats, _ = jvcm.render_block_with_stats(
        jload((RES, RES), SCENE_CONFIGS[0]), 0, RES, RES, block=3,
        merge_backend="xla", camera_unroll="off", pair_factor=64.0, **kw)
    got, rays, ovf, stats, _ = tvcm.render_block_with_stats(
        tload((RES, RES), SCENE_CONFIGS[0], device="cpu"), 0, RES, RES, 3,
        pair_factor=64.0, merge_backend="xla", **kw)
    assert int(jovf) == 0 and int(ovf) == 0
    assert abs(int(rays) / int(jrays) - 1.0) < 1e-3
    # Live counts agree to the few paths that ulp-level drift moves.
    for g, w in zip(stats.tolist()[1:], np.asarray(jstats).tolist()[1:]):
        assert abs(g - w) <= 2
    assert_image_close(got.numpy(), np.asarray(want))


def _xla_cfg(**kw):
    base = dict(algorithm="vcm", iterations=3, resolution=(RES, RES),
                block_size=3, merge_backend="xla", radius_factor=0.05)
    return R.RenderConfig(**{**base, **kw})


def test_forced_pair_overflow_grows_by_jax_rule_and_rerenders(capsys):
    scene = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    big = dict(pair_factor=64.0, photon_factor=9.0, query_factor=9.0,
               merge_caps_frozen=True)
    want, _, _, want_rays = R.render(scene, _xla_cfg(**big))
    assert "overflow" not in capsys.readouterr().out
    cfg = _xla_cfg(**{**big, "pair_factor": 0.05})
    got, _, done, rays = R.render(scene, cfg, verbose=True)
    out = capsys.readouterr().out
    assert out.count("merge cap overflow; re-rendering block at "
                     "iteration 0 with pair_factor=") == 1
    assert done == 3 and rays == want_rays
    assert torch.equal(got, want)
    # JAX's rule, inline there (render.py:474-476), over the block's most
    # candidate pairs of an iteration; photons and queries did not grow.
    pairs = max(tvcm.merge_measure_iteration(
        scene, it, RES, RES, radius_factor=0.05)[0] for it in range(3))
    assert cfg.pair_factor == max(JR._bucket(pairs * 1.1, N),
                                  JR._bucket(0.05 * N * 1.26, N))
    assert (cfg.photon_factor, cfg.query_factor) == (9.0, 9.0)
    # The -v block line shows the merge stats and the grown caps.
    assert f"pairs={pairs} " in out
    assert f"pair_factor={cfg.pair_factor} " in out


@pytest.mark.parametrize("n", [64, 4096, 262_144, 4_194_304])
def test_grow_pairs_matches_jax(n):
    for pairs in (0, 1000, 317_000, 4_776_826, 76_000_000):
        for factor in (0.05, 1.25, 24.0):
            assert R._grow_pairs(factor, pairs, n) == max(
                JR._bucket(pairs * 1.1, n), JR._bucket(factor * n * 1.26, n))


def test_chunk_rule_matches_jax():
    """One chunk per 16M pair rows of the cap (render.py:419-424)."""
    for res in (16, 512, 1024, 2048):
        n = res * res
        for pf in (0.05, 24.0, 96.0):
            cfg = _xla_cfg(resolution=(res, res), pair_factor=pf)
            assert R.merge_chunks(cfg) == max(
                1, int(-(-int(pf * n) // (16 << 20))))
    assert R.merge_chunks(R.RenderConfig(pair_factor=96.0,
                                         resolution=(1024, 1024))) == 1


def test_xla_any_partition_into_blocks_is_bit_exact():
    scene = tload((RES, RES), SCENE_CONFIGS[1], device="cpu")
    imgs = [R.render(scene, _xla_cfg(iterations=4, block_size=b))[0]
            for b in (1, 4)]
    assert torch.equal(imgs[0], imgs[1])


# -- (e) gradients at explicit caps -------------------------------------------

GRAD_RES = 8
GRAD_KW = dict(max_path_length=6, radius_factor=0.3)


# Caps whose pair rows spill (~5,000 candidate pairs at this radius, 1,536
# pair rows: the image is the truncated one on both sides), with photon
# and query factors other than the defaults.
GRAD_CAPS = dict(pair_factor=24.0, photon_factor=2.0, query_factor=2.5)


def test_render_params_and_gradients_at_caps_match_jax():
    caps = GRAD_CAPS
    js = jload((GRAD_RES, GRAD_RES), SCENE_CONFIGS[1])
    jp = jdiff.extract_params(js)
    scene = tload((GRAD_RES, GRAD_RES), SCENE_CONFIGS[1], device="cpu")
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    img = diff.render_params(scene, params, 0, "bpm", GRAD_RES, GRAD_RES,
                             **GRAD_KW, **caps)
    # The caps are the ones used: caps that hold every pair give another
    # image.
    full = diff.render_params(scene, params, 0, "bpm", GRAD_RES, GRAD_RES,
                              **GRAD_KW, pair_factor=128.0)
    assert not torch.equal(img, full)
    # JAX's loss_and_grad (one iteration, the L2 loss against a zero
    # target), with its image kept: one gradient program to compile.
    (jl, want), jg = jax.value_and_grad(lambda p: (lambda im: (
        jnp.mean(im ** 2), im))(jdiff.render_params(
            js, p, 0, "bpm", GRAD_RES, GRAD_RES, **GRAD_KW, **caps)),
        has_aux=True)(jp)
    want = np.asarray(want)
    assert want.mean() > 0.0
    np.testing.assert_allclose(img.numpy(), want, rtol=1e-3, atol=1e-6)
    loss, grad = diff.loss_and_grad(scene, params, torch.zeros_like(img), 0,
                                    "bpm", GRAD_RES, GRAD_RES, **GRAD_KW,
                                    **caps)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    jg = convert.params_from_numpy(jax.tree.map(np.asarray, jg),
                                   device="cpu")
    for g, w in zip(diff._leaves(grad), diff._leaves(jg)):
        assert torch.isfinite(g).all()
        bound = 1e-3 * float(w.abs().max()) + 1e-9
        assert float((g - w).abs().max()) <= bound
    assert float(jg.diffuse.x.abs().max()) > 0.0


# -- (f) two gloo ranks -------------------------------------------------------

SHARD_RES = 16
SHARD_KW = dict(algorithm="vcm", iterations=2, resolution=(SHARD_RES,
                                                           SHARD_RES),
                max_path_length=4, radius_factor=0.1, merge_backend="xla")
TINY = dict(pair_factor=0.05, photon_factor=9.0, query_factor=9.0)


def _rank_grow():
    """Runs in every rank: one block of 2 from tiny pair caps -> the
    image, the block's stats and the caps it grew to."""
    torch.set_num_threads(1)
    scene = tload((SHARD_RES, SHARD_RES), SCENE_CONFIGS[1], device="cpu")
    cfg = R.RenderConfig(**SHARD_KW, **TINY,
                         group=multihost.global_group())
    runner = R._make_block_runner(scene, cfg, "vcm")
    block = runner(0, 2, torch.zeros((SHARD_RES, SHARD_RES, 3)))
    return block.accum, block.stats, R._caps_of(cfg)


def test_two_ranks_grow_alike_and_match_single_process(capsys):
    ranks = multihost.spawn(2, "cpu", _rank_grow)
    (img0, stats0, caps0), (img1, stats1, caps1) = ranks
    assert caps0 == caps1 and stats0 == stats1 and torch.equal(img0, img1)
    n_shard = SHARD_RES * SHARD_RES // 2
    # Summed over the ranks, maxed over the block's iterations.
    assert caps0["pair_factor"] == R._grow_pairs(0.05, stats0[0], n_shard)
    assert caps0["pair_factor"] > 0.05
    assert (caps0["photon_factor"], caps0["query_factor"]) == (9.0, 9.0)
    # The single process at the grown factors (twice the shard's rows).
    scene = tload((SHARD_RES, SHARD_RES), SCENE_CONFIGS[1], device="cpu")
    cfg = R.RenderConfig(**SHARD_KW, **caps0, merge_caps_frozen=True)
    single = R._make_block_runner(scene, cfg, "vcm")(
        0, 2, torch.zeros((SHARD_RES, SHARD_RES, 3)))
    assert "overflow" not in capsys.readouterr().out
    assert float(single.accum.mean()) > 0.0
    torch.testing.assert_close(img0, single.accum, rtol=1e-4, atol=1e-6)
    # The pairs summed over ranks are the single process's: each rank
    # merges its own queries against every photon.
    assert stats0[0] == single.stats[0]
