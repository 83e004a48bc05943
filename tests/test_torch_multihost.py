"""Multi-process jobs: parallel/multihost.py and the CLI's --devices.

* Two processes started as a user would start them on two hosts (each
  calls ``multihost.initialize`` with the coordinator's address, here a
  file:// rendezvous in tmp_path, never a fixed TCP port) render one
  sharded VCM iteration; the coordinator's image equals the
  single-process image (rtol 1e-4 / atol 1e-6, the framebuffer sum order).
* ``python -m smallvcm_tpu_torch.cli --device cpu --devices 2 -a pt``
  writes the BMP bytes of ``--devices 1`` (pt is bit for bit).
* ``-t`` with 2 ranks: both ranks end on the same iteration count (rank 0
  decides each step), with the ranks' clocks started apart.
* A checkpointed 2-rank run resumes to the bytes of an uninterrupted run.
* A rank that raises stops the job with that error, even while another
  rank waits in a collective.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from smallvcm_tpu_torch import cli
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.parallel import multihost
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

ROOT = Path(__file__).resolve().parent.parent
RES = 16

_HOST = """
import sys
import numpy as np
import torch
from smallvcm_tpu_torch.parallel import multihost, sharding
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

torch.set_num_threads(1)
group = multihost.initialize(sys.argv[1], 2, int(sys.argv[2]), device="cpu")
scene = load_cornell_box(({res}, {res}), SCENE_CONFIGS[1], device="cpu")
img = sharding.sharded_render_iteration(group, scene, 0, {res}, {res},
                                        max_path_length=3)
if multihost.is_coordinator():
    np.save(sys.argv[3], img.numpy())
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli(*argv, cwd):
    return subprocess.run(
        [sys.executable, "-m", "smallvcm_tpu_torch.cli", "--device", "cpu",
         "-s", "1", "--resolution", str(RES), str(RES),
         "--max-path-length", "4", *argv],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=300)


def test_two_processes_through_initialize_give_single_image(tmp_path):
    init = (tmp_path / "rendezvous").as_uri()
    out = tmp_path / "img.npy"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _HOST.format(res=RES), init, str(pid),
         str(out)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    for p in procs:
        text, _ = p.communicate(timeout=300)
        assert p.returncode == 0, text
    got = np.load(out)
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[1], device="cpu")
    want, _ = vcm.render_iteration(scene, 0, RES, RES, max_path_length=3)
    assert want.mean() > 0.0
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-6)


def test_cli_devices_2_writes_the_bytes_of_devices_1(tmp_path):
    r = _cli("-a", "pt", "-i", "2", "--devices", "2", "-o", "two.bmp",
             cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Devices: 2" in r.stdout and "backend gloo" in r.stdout
    assert r.stdout.count("Saved:") == 1          # the coordinator only
    one = tmp_path / "one.bmp"
    assert cli.main(["--device", "cpu", "-s", "1", "--resolution", str(RES),
                     str(RES), "--max-path-length", "4", "-a", "pt", "-i",
                     "2", "--devices", "1", "-o", str(one)]) == 0
    assert (tmp_path / "two.bmp").read_bytes() == one.read_bytes()


def test_cli_refuses_indivisible_resolution(capsys):
    assert cli.main(["--device", "cpu", "--resolution", "16", "16",
                     "--devices", "3"]) == 1
    assert "Resolution 16x16 (256 paths) not divisible by 3 devices" in \
        capsys.readouterr().out


def _budget_rank(max_time):
    torch.set_num_threads(1)
    group = multihost.global_group()
    # Start the ranks' clocks apart: each rank's own budget would end on a
    # different iteration.
    time.sleep(0.4 * torch.distributed.get_rank())
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device="cpu")
    cfg = R.RenderConfig(algorithm="vcm", iterations=1000,
                         max_time=max_time, resolution=(8, 8),
                         max_path_length=4, group=group)
    img, _, done, _ = R.render(scene, cfg)
    return done, img


def test_time_budget_gives_every_rank_the_same_iteration_count():
    (done0, img0), (done1, img1) = multihost.spawn(2, "cpu", _budget_rank,
                                                   0.6)
    assert done0 == done1 >= 1
    assert torch.equal(img0, img1)


def _failing_rank():
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    # Rank 0 waits in a collective that rank 1 never joins.
    torch.distributed.all_reduce(torch.zeros(1))


def test_a_failing_rank_brings_the_job_down():
    t0 = time.perf_counter()
    # Whichever rank's error is reported first (rank 0's read from its
    # lost peer, or rank 1's own), the job stops with it.
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails|Connection reset|Connection "
                             "closed"):
        multihost.spawn(2, "cpu", _failing_rank)
    assert time.perf_counter() - t0 < 120


def test_checkpointed_two_rank_run_resumes_bitwise(tmp_path):
    ck = ["--checkpoint", "state.npz"]
    r = _cli("-a", "pt", "-i", "2", "--devices", "2", *ck,
             "--checkpoint-every", "2", "-o", "part.bmp", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (tmp_path / "state.npz").exists()
    r = _cli("-a", "pt", "-i", "4", "--devices", "2", *ck, "-v",
             "-o", "resumed.bmp", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("iter ") == 2 and "(4 iterations" in r.stdout
    full = tmp_path / "full.bmp"
    assert cli.main(["--device", "cpu", "-s", "1", "--resolution", str(RES),
                     str(RES), "--max-path-length", "4", "-a", "pt", "-i",
                     "4", "-o", str(full)]) == 0
    assert (tmp_path / "resumed.bmp").read_bytes() == full.read_bytes()


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is None
    assert multihost.initialize("localhost:1234", 1, 0) is None
    assert multihost.global_group() is None and multihost.is_coordinator()
    assert multihost._init_url(None) == "env://"
    assert multihost._init_url("h:5") == "tcp://h:5"
    assert multihost._init_url("file:///x") == "file:///x"
    assert multihost.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.rank_device("cuda", 1)
