"""The port's whole slice vs the JAX package: VCM renders, CPU, small sizes.

The port's ``render()`` is held against ``vcm.render_block_with_stats``
(XLA merge, which test_pallas_merge.py pins to the Pallas merge the port
follows). Tolerance: rtol 1e-4 / atol 1e-6 on at least 99% of pixels and
the image mean to 1e-4 relative. The pixel allowance is there because a
1-ulp difference (XLA and torch round transcendentals differently) can
flip a Russian-roulette, refraction or r^2 decision and move one path.

The JAX reference runs the camera loop in its loop form here (the
unrolled form costs ~150 s of XLA compile on the CPU at the default path
length; the two agree to ~1 ulp): the unrolled form is covered at
max_path_length 5 and, at full length, by the golden image rendered with
it (scripts/make_torch_golden.py).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from smallvcm_tpu import cli as jcli
from smallvcm_tpu import render as JR
from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import cli
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.io.framebuffer import load_bmp
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "data" / "torch_golden_vcm_s0_32.npz"
# Generous static caps so the JAX XLA merge never overflows at these sizes.
_CAPS = dict(pair_factor=64.0, photon_factor=4.0, query_factor=4.0)


def assert_image_close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert want.mean() > 0.0
    ok = np.isclose(got, want, rtol=rtol, atol=1e-6).all(axis=-1)
    assert ok.mean() >= 0.99, f"{(~ok).sum()} of {ok.size} pixels differ"
    assert abs(got.mean() / want.mean() - 1.0) <= 1e-4


def _jax_render(res, iters, unroll, **kw):
    scene = jload((res, res), SCENE_CONFIGS[0])
    acc, rays, ovf, _, _ = jvcm.render_block_with_stats(
        scene, 0, res, res, block=iters, merge_backend="xla",
        camera_unroll=unroll, **_CAPS, **kw)
    assert int(ovf) == 0
    return np.asarray(acc) / iters, int(rays)


@pytest.mark.parametrize("unroll,max_path_length", [("off", 10), ("on", 5)])
def test_vcm_render_matches_jax(unroll, max_path_length):
    res, iters = 16, 2
    want, want_rays = _jax_render(res, iters, unroll,
                                  max_path_length=max_path_length)
    cfg = R.RenderConfig(algorithm="vcm", iterations=iters,
                         resolution=(res, res),
                         max_path_length=max_path_length)
    img, _, done, rays = R.render(
        tload((res, res), SCENE_CONFIGS[0], device="cpu"), cfg)
    assert done == iters
    assert abs(rays / want_rays - 1.0) < 1e-3
    assert_image_close(img, want)


@pytest.mark.parametrize("flags", [
    (False, False, True, False),   # lt
    (False, True, False, True),    # ppm (forced, no downgrade)
    (False, True, False, False),   # bpm
    (True, False, False, False),   # bpt
])
def test_vcm_family_iteration_matches_jax(flags):
    """One iteration of each other member of the family, with a larger
    merge radius so that ppm/bpm merge at 16x16. rtol 1e-3: without
    vcm's merging share of the MIS weight, glossy-floor connections carry
    the Phong cosine to the 90th power, which turns few-ulp direction
    differences into up to ~4e-4 relative on single pixels."""
    use_vc, use_vm, lt_only, ppm = flags
    res = 16
    kw = dict(use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only,
              ppm=ppm, radius_factor=0.05)
    want, _ = _jax_render(res, 1, "off", **kw)
    got, _ = tvcm.render_iteration(
        tload((res, res), SCENE_CONFIGS[0], device="cpu"), 0, res, res, **kw)
    assert_image_close(got, want, rtol=1e-3)


def test_vcm_matches_golden_image():
    """The port on the CPU against the JAX image stored in tests/data
    (unrolled camera loop, full path length); needs no JAX."""
    data = np.load(GOLDEN)
    c = json.loads(str(data["config"]))
    res = tuple(c["resolution"])
    cfg = R.RenderConfig(
        algorithm=c["algorithm"], iterations=c["iterations"], resolution=res,
        base_seed=c["base_seed"], max_path_length=c["max_path_length"],
        min_path_length=c["min_path_length"],
        radius_factor=c["radius_factor"], radius_alpha=c["radius_alpha"],
    )
    img, _, _, _ = R.render(
        tload(res, SCENE_CONFIGS[c["scene_id"]], device="cpu"), cfg)
    assert_image_close(img, data["image"])


def test_render_time_budget_and_ppm_downgrade():
    for config in SCENE_CONFIGS:
        assert R.resolve_algorithm(tload((8, 8), config, device="cpu"),
                                   "ppm") == \
            JR.resolve_algorithm(jload((8, 8), config), "ppm")
    scene = tload((8, 8), SCENE_CONFIGS[0], device="cpu")
    cfg = R.RenderConfig(iterations=50, max_time=0.3, resolution=(8, 8))
    img, elapsed, done, rays = R.render(scene, cfg)
    assert 1 <= done < 50 and elapsed >= 0.3 and rays > 0
    assert np.isfinite(img.numpy()).all()


def test_cli_renders_bmp_on_cpu(tmp_path, capsys):
    out = tmp_path / "v.bmp"
    rc = cli.main(["-s", "0", "-a", "vcm", "-i", "2", "--resolution", "8",
                   "8", "-o", str(out), "--device", "cpu", "-v"])
    assert rc == 0
    assert out.stat().st_size == 54 + 8 * 8 * 3
    text = capsys.readouterr().out
    assert text.count("iter ") == 2 and "2 iterations" in text
    assert load_bmp(str(out)).shape == (8, 8, 3)
    for config in SCENE_CONFIGS:
        assert cli.build_default_filename(config, "vcm") == \
            jcli.build_default_filename(config, "vcm")
