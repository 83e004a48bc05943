"""The port's supervisor (isolate.py) under injected faults, on the CPU.

tests/test_isolate.py's three cases through the port's CLI (``--device
cpu``, 16x16), with the SMALLVCM_TEST_FAULT_* hooks
(render.py::_maybe_inject_test_fault):

* one fault: the supervisor respawns from the checkpoint and the image is
  byte for byte the uninterrupted run's;
* ``MAX_FAULTS`` faults, each after checkpoint progress: the supervisor
  gives up with a non-zero exit and says why. The JAX supervisor switched to ``--merge-backend xla`` here;
  the port's never switches the merge backend (that would swap the merge
  kernel out), which a recorded run of the supervisor checks too;
* faults with no checkpoint progress: it gives up after
  ``MAX_STALLED_FAULTS`` faults, fewer than ``MAX_FAULTS``, instead of
  spinning.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

from smallvcm_tpu_torch import cli, isolate

ROOT = Path(__file__).resolve().parent.parent
BASE = ["-s", "0", "-a", "vcm", "-i", "4", "--resolution", "16", "16",
        "--max-path-length", "4", "--device", "cpu", "--devices", "1"]


def _env(counter, at, times):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env.update(SMALLVCM_TEST_FAULT_AT=str(at),
               SMALLVCM_TEST_FAULT_TIMES=str(times),
               SMALLVCM_TEST_FAULT_COUNTER=str(counter))
    return env


def _supervised(argv, env):
    return subprocess.run(
        [sys.executable, "-m", "smallvcm_tpu_torch.cli", *argv,
         "--isolate", "on"], env=env, capture_output=True, text=True,
        timeout=600)


def test_supervised_fault_recovers_bit_exact(tmp_path):
    ref, out = tmp_path / "ref.bmp", tmp_path / "out.bmp"
    counter = tmp_path / "faults"
    assert cli.main(BASE + ["-o", str(ref)]) == 0
    r = _supervised(BASE + ["--checkpoint", str(tmp_path / "ckpt.npz"),
                            "--checkpoint-every", "1", "-o", str(out)],
                    _env(counter, 2, 1))
    assert r.returncode == 0, r.stderr[-2000:]
    assert counter.read_text() == "1"          # the fault really fired
    assert "respawning from checkpoint" in r.stdout
    assert out.read_bytes() == ref.read_bytes()


def test_supervisor_gives_up_after_max_faults(tmp_path):
    counter = tmp_path / "faults"
    r = _supervised(BASE + ["--checkpoint", str(tmp_path / "ckpt.npz"),
                            "--checkpoint-every", "1",
                            "-o", str(tmp_path / "out.bmp")],
                    _env(counter, 2, 99))
    assert r.returncode != 0
    assert counter.read_text() == str(isolate.MAX_FAULTS)
    assert "giving up, the merge backend is never switched" in r.stdout
    assert not (tmp_path / "out.bmp").exists()


def test_supervisor_never_switches_the_merge_backend(monkeypatch, capsys):
    """Every child command line is the user's: no merge-backend flag is
    added however many faults the children report."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        return SimpleNamespace(returncode=1,
                               stderr="RuntimeError: CUDA error: test")

    monkeypatch.setattr(isolate.subprocess, "run", fake_run)
    monkeypatch.setattr(isolate, "_checkpoint_iteration",
                        lambda path: len(cmds))    # progress every time
    assert isolate.run_supervised(BASE + ["--merge-backend", "pallas"]) == 1
    assert len(cmds) == isolate.MAX_FAULTS
    for cmd in cmds:
        assert cmd.count("--merge-backend") == 1
        assert cmd[cmd.index("--merge-backend") + 1] == "pallas"
    assert "giving up" in capsys.readouterr().out


def test_supervisor_gives_up_without_progress(tmp_path):
    """Faults at iteration 1 before any checkpoint (saves every 8
    iterations): the supervisor stops after MAX_STALLED_FAULTS faults,
    before MAX_FAULTS, and returns non-zero."""
    assert isolate.MAX_STALLED_FAULTS < isolate.MAX_FAULTS
    counter = tmp_path / "faults"
    r = _supervised(BASE + ["--checkpoint", str(tmp_path / "ckpt.npz"),
                            "-o", str(tmp_path / "out.bmp")],
                    _env(counter, 1, 99))
    assert r.returncode != 0
    assert "no checkpoint progress; giving up" in r.stdout
    assert int(counter.read_text()) == isolate.MAX_STALLED_FAULTS
    assert not (tmp_path / "out.bmp").exists()
