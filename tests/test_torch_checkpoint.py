"""The port's checkpoint/resume and CLI surface.

* A resumed render is bitwise equal to an uninterrupted one (pt, vcm, and
  a time-budgeted ``-t`` first run); mismatched settings are refused.
* Checkpoints cross packages: the npz fields are the JAX package's, so
  each package resumes the other's file. The resumed images agree with an
  uninterrupted render of the resuming package at the slice test's bound
  (the prefix was rendered by the other package, ulps apart).
* Every CLI flag the two packages share has the same default, and the
  default output names agree for all seven algorithms.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu import checkpoint as jckpt
from smallvcm_tpu import cli as jcli
from smallvcm_tpu.render import RenderConfig as JConfig
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import checkpoint as ckpt
from smallvcm_tpu_torch import cli
from smallvcm_tpu_torch.io.framebuffer import load_bmp
from smallvcm_tpu_torch.render import ALGORITHMS, RenderConfig
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

from .test_torch_slice import assert_image_close

torch.set_num_threads(2)

RES = (16, 16)


@pytest.mark.parametrize("alg", ["pt", "vcm"])
def test_resume_is_bitwise_exact(alg, tmp_path):
    scene = load_cornell_box(RES, SCENE_CONFIGS[1], device="cpu")
    path = str(tmp_path / "state.npz")
    full, _, iters, _ = ckpt.render_resumable(
        scene, RenderConfig(algorithm=alg, iterations=4, resolution=RES))
    assert iters == 4
    ckpt.render_resumable(
        scene, RenderConfig(algorithm=alg, iterations=2, resolution=RES),
        checkpoint_path=path, checkpoint_every=2)
    accum, done, seed, meta = ckpt.load_checkpoint(path)
    assert done == 2 and seed == 1234 and meta["algorithm"] == alg
    resumed, _, iters, _ = ckpt.render_resumable(
        scene, RenderConfig(algorithm=alg, iterations=4, resolution=RES),
        checkpoint_path=path)
    assert iters == 4
    assert torch.equal(full, resumed)


def test_time_budget_then_resume(tmp_path):
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device="cpu")
    path = str(tmp_path / "t.npz")
    cfg = RenderConfig(algorithm="bpt", max_time=0.5, resolution=(8, 8))
    _, elapsed, k, _ = ckpt.render_resumable(scene, cfg, checkpoint_path=path,
                                             checkpoint_every=1)
    assert k >= 1 and elapsed >= 0.5
    assert ckpt.load_checkpoint(path)[1] == k
    more = RenderConfig(algorithm="bpt", iterations=k + 2, resolution=(8, 8))
    resumed, _, done, _ = ckpt.render_resumable(scene, more,
                                                checkpoint_path=path)
    full, _, _, _ = ckpt.render_resumable(
        scene, RenderConfig(algorithm="bpt", iterations=k + 2,
                            resolution=(8, 8)))
    assert done == k + 2 and torch.equal(resumed, full)


def test_mismatched_checkpoint_is_refused(tmp_path):
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device="cpu")
    path = str(tmp_path / "m.npz")
    ckpt.render_resumable(scene, RenderConfig(algorithm="pt", iterations=1,
                                              resolution=(8, 8)),
                          checkpoint_path=path, checkpoint_every=1)
    for kw, what in [(dict(algorithm="vcm"), "algorithm"),
                     (dict(base_seed=7), "seed"),
                     (dict(max_path_length=5), "max_path_length"),
                     (dict(radius_factor=0.01), "radius_factor")]:
        cfg = RenderConfig(**{**dict(algorithm="pt", iterations=2,
                                     resolution=(8, 8)), **kw})
        with pytest.raises(ValueError, match=f"checkpoint {what} mismatch"):
            ckpt.render_resumable(scene, cfg, checkpoint_path=path)


def test_checkpoints_cross_packages(tmp_path):
    js = jload(RES, SCENE_CONFIGS[1])
    ts = load_cornell_box(RES, SCENE_CONFIGS[1], device="cpu")
    kw = dict(algorithm="pt", resolution=RES)

    # JAX writes, the port resumes.
    jpath = str(tmp_path / "jax.npz")
    jckpt.render_resumable(js, JConfig(iterations=2, **kw),
                           checkpoint_path=jpath, checkpoint_every=2)
    accum, done, seed, meta = ckpt.load_checkpoint(jpath)
    assert done == 2 and seed == 1234 and accum.shape == (16, 16, 3)
    assert meta["resolution"] == [16, 16] and meta["algorithm"] == "pt"
    resumed, _, iters, _ = ckpt.render_resumable(
        ts, RenderConfig(iterations=4, **kw), checkpoint_path=jpath)
    full, _, _, _ = ckpt.render_resumable(ts, RenderConfig(iterations=4,
                                                           **kw))
    assert iters == 4
    assert_image_close(resumed, full.numpy())

    # The port writes, JAX resumes.
    tpath = str(tmp_path / "port.npz")
    ckpt.render_resumable(ts, RenderConfig(iterations=2, **kw),
                          checkpoint_path=tpath, checkpoint_every=2)
    j_accum, j_done, j_seed, j_meta = jckpt.load_checkpoint(tpath)
    np.testing.assert_array_equal(np.asarray(j_accum),
                                  ckpt.load_checkpoint(tpath)[0].numpy())
    assert (j_done, j_seed) == (2, 1234) and j_meta == meta
    j_resumed, _, _ = jckpt.render_resumable(
        js, JConfig(iterations=4, **kw), checkpoint_path=tpath)
    j_full, _, _ = jckpt.render_resumable(js, JConfig(iterations=4, **kw))
    assert_image_close(np.asarray(j_resumed), np.asarray(j_full))


def test_shared_cli_defaults_match_jax():
    mine = vars(cli.make_parser().parse_args([]))
    theirs = vars(jcli.make_parser().parse_args([]))
    shared = set(mine) & set(theirs)
    assert {"scene_id", "algorithm", "max_time", "iterations", "output_name",
            "report", "resolution", "max_path_length", "min_path_length",
            "seed", "radius_factor", "radius_alpha", "rng_kind",
            "merge_backend", "trace_backend", "block_size", "checkpoint",
            "checkpoint_every", "verbose", "devices", "isolate"} <= shared
    for k in shared:
        assert mine[k] == theirs[k], k
    assert set(theirs) - set(mine) == set()
    assert set(mine) - set(theirs) == {"device"}


def test_default_filenames_for_all_algorithms():
    assert ALGORITHMS == ("el", "pt", "lt", "ppm", "bpm", "bpt", "vcm")
    for config in SCENE_CONFIGS:
        for alg in ALGORITHMS:
            assert cli.build_default_filename(config, alg) == \
                jcli.build_default_filename(config, alg)


def test_cli_checkpoint_flags(tmp_path, capsys):
    base = ["-s", "1", "-a", "ppm", "--resolution", "8", "8", "--device",
            "cpu", "--checkpoint", str(tmp_path / "c.npz")]
    assert cli.main(base + ["-i", "2", "--checkpoint-every", "1",
                            "-o", str(tmp_path / "a.bmp")]) == 0
    assert cli.main(base + ["-i", "3", "-o", str(tmp_path / "b.bmp")]) == 0
    assert cli.main(["-s", "1", "-a", "ppm", "--resolution", "8", "8",
                     "--device", "cpu", "-i", "3",
                     "-o", str(tmp_path / "c.bmp")]) == 0
    out = capsys.readouterr().out
    assert "done in" in out and "(3 iterations," in out
    np.testing.assert_array_equal(load_bmp(str(tmp_path / "b.bmp")),
                                  load_bmp(str(tmp_path / "c.bmp")))
