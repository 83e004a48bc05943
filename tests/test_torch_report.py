"""The port's --report: index.html and the 28-combination run.

``_write_html`` must write the JAX package's index.html byte for byte for
the same state, and the CLI's summary line must be what the report
parses. The full run (28 CLI subprocesses on the CPU) is marked slow, as
tests/test_report.py is.
"""

import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from smallvcm_tpu import report as jreport
from smallvcm_tpu_torch import cli, report
from smallvcm_tpu_torch.render import ALGORITHMS
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _state():
    state = {}
    for scene_id, config in enumerate(SCENE_CONFIGS):
        for k, alg in enumerate(ALGORITHMS):
            if (scene_id + k) % 5 == 3:
                continue   # a partial state: some combos not rendered yet
            state[cli.build_default_filename(config, alg)] = {
                "elapsed": 0.125 * (k + 1) + scene_id, "iters": k + 1,
                "scene": scene_id, "alg": alg}
    return state


def test_index_html_byte_identical_to_jax(tmp_path, monkeypatch):
    args = Namespace(resolution=(64, 48))
    monkeypatch.chdir(tmp_path)
    jreport._write_html(_state(), args)
    want = (tmp_path / "index.html").read_bytes()
    (tmp_path / "index.html").unlink()
    report._write_html(_state(), args)
    assert (tmp_path / "index.html").read_bytes() == want
    assert b"gglm_c_vcm.bmp" in want


def test_done_line_parses(tmp_path, capsys):
    assert cli.main(["-a", "el", "--resolution", "8", "8", "--device", "cpu",
                     "-i", "2", "-o", str(tmp_path / "e.bmp")]) == 0
    m = report._DONE_RE.search(capsys.readouterr().out)
    assert m and int(m.group(2)) == 2 and float(m.group(1)) >= 0.0


def test_failed_combo_is_not_retried(tmp_path, monkeypatch):
    """A failing combination raises once; nothing reruns it on another
    backend."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "boom")

    monkeypatch.setattr(report.subprocess, "run", fake_run)
    args = Namespace(resolution=(8, 8), seed=1234, max_path_length=10,
                     min_path_length=0, radius_factor=0.003,
                     radius_alpha=0.75, max_time=-1.0, iterations=1,
                     device="cpu")
    with pytest.raises(RuntimeError, match="rc=1"):
        report._render_combo(0, "vcm", str(tmp_path / "x.bmp"), args)
    assert len(calls) == 1
    assert "--merge-backend" not in calls[0]
    assert calls[0][calls[0].index("--device") + 1] == "cpu"


@pytest.mark.parametrize("max_time,jobs", [(-1.0, report.REPORT_JOBS),
                                           (2.0, 1)])
def test_combos_run_concurrently_only_without_time_budget(
        tmp_path, monkeypatch, capsys, max_time, jobs):
    """With -i, REPORT_JOBS combinations render at once; with -t one at a
    time. Either way the log and the state list all 28 in report order."""
    import threading
    import time

    lock = threading.Lock()
    live, peak = [0], [0]

    def fake_combo(scene_id, alg, filename, args):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.02)
        Path(filename).write_bytes(b"BM")
        with lock:
            live[0] -= 1
        return 0.5, 1

    monkeypatch.setattr(report, "_render_combo", fake_combo)
    monkeypatch.chdir(tmp_path)
    args = Namespace(resolution=(8, 8), seed=1234, max_path_length=10,
                     min_path_length=0, radius_factor=0.003,
                     radius_alpha=0.75, max_time=max_time, iterations=1,
                     device="cpu")
    report.full_report(args)
    assert peak[0] == jobs
    out = capsys.readouterr().out
    names = [cli.build_default_filename(c, a)
             for c in SCENE_CONFIGS for a in ALGORITHMS]
    assert set(json.loads(Path("report_state.json").read_text())) == \
        set(names)
    assert out.count("done in 0.50 s") == 28
    assert [ln.split("...")[0] for ln in out.splitlines()
            if ln.startswith("Running")] == \
        [f"Running {report.ALGORITHM_NAMES[a]}"
         for _ in SCENE_CONFIGS for a in ALGORITHMS]


@pytest.mark.slow
def test_report_complete_and_resumes(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ROOT) + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else str(ROOT))

    def run():
        return subprocess.run(
            [sys.executable, "-m", "smallvcm_tpu_torch.cli", "--report",
             "-i", "1", "--resolution", "16", "16", "--device", "cpu"],
            cwd=str(tmp_path), env=env, capture_output=True, text=True)

    proc = run()
    assert proc.returncode == 0, proc.stderr[-800:]
    bmps = sorted(p.name for p in tmp_path.glob("*.bmp"))
    assert len(bmps) == 28, bmps
    index = (tmp_path / "index.html").read_text()
    assert all(b in index for b in bmps)
    state = json.loads((tmp_path / "report_state.json").read_text())
    assert len(state) == 28 and all(r["iters"] == 1 for r in state.values())

    victim = bmps[5]
    (tmp_path / victim).unlink()
    proc = run()
    assert proc.returncode == 0, proc.stderr[-800:]
    assert (tmp_path / victim).exists()
    assert proc.stdout.count("already done") == 27
