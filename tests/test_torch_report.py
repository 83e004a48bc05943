"""The port's --report: index.html and the 28-combination run.

``_write_html`` must write the JAX package's index.html byte for byte for
the same state. The report renders every combination in its own process
(``cli.render_one``): a stub render holds its order, state and failure
handling; the whole run at 8x8 holds its images against fresh CLI
processes' and its resume.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
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


# The CLI's "done in 1.23 s (4 iterations, 5678 rays)" line.
DONE_RE = re.compile(r"done in ([0-9.]+) s \((\d+) iterations?[,)]")


def test_done_line_parses(tmp_path, capsys):
    assert cli.main(["-a", "el", "--resolution", "8", "8", "--device", "cpu",
                     "-i", "2", "-o", str(tmp_path / "e.bmp")]) == 0
    m = DONE_RE.search(capsys.readouterr().out)
    assert m and int(m.group(2)) == 2 and float(m.group(1)) >= 0.0


def _args(*extra):
    return cli.make_parser().parse_args(
        ["--report", "--resolution", "8", "8", "--device", "cpu", *extra])


NAMES = [cli.build_default_filename(c, a)
         for c in SCENE_CONFIGS for a in ALGORITHMS]


@pytest.fixture
def stub_render(monkeypatch):
    """Install ``fake`` as the report's render; nothing to release then
    (a gc.collect() a combination costs ~0.1 s with JAX loaded)."""
    monkeypatch.setattr(report, "_release", lambda device: None)
    return lambda fake: monkeypatch.setattr(cli, "render_one", fake)


def _running_lines(out):
    return [ln.split("...")[0] for ln in out.splitlines()
            if ln.startswith("Running")]


def test_failed_combo_is_reported_not_retried(tmp_path, monkeypatch, capsys,
                                              stub_render):
    """A combination whose render raises is reported once and never
    rendered again; the others still render, the run exits 1, and the
    state lacks only that combination."""
    victim = cli.build_default_filename(SCENE_CONFIGS[1], "bpt")
    calls = []

    def fake_render(args, scene_id, alg, filename, device):
        calls.append(filename)
        if filename == victim:
            raise RuntimeError("kernel launch failed")
        Path(filename).write_bytes(b"BM")
        return 0.5, 1

    stub_render(fake_render)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        report.full_report(_args("-i", "1"))
    assert exc.value.code == 1
    assert calls == NAMES
    out = capsys.readouterr().out
    assert out.count("FAILED (RuntimeError: kernel launch failed)") == 1
    assert out.count("done in 0.50 s") == 27
    assert f"INCOMPLETE: 1 combination(s) failed ({victim})" in out
    state = json.loads(Path(report.STATE_FILE).read_text())
    assert set(state) == set(NAMES) - {victim}
    assert victim not in (tmp_path / "index.html").read_text()


@pytest.mark.parametrize("budget", [("-i", "3"), ("-t", "2.5")])
def test_combos_render_in_order_one_at_a_time(tmp_path, monkeypatch, capsys,
                                              stub_render, budget):
    """With -i or -t the combinations render one after another in report
    order in this process, on the report's device, with the report's
    flags; the state and index.html are rewritten after each one."""
    seen = []

    def fake_render(args, scene_id, alg, filename, device):
        # Everything before this combination is saved and in the HTML.
        state = json.loads(Path(report.STATE_FILE).read_text()) \
            if seen else {}
        assert list(state) == [s[2] for s in seen]
        if seen:
            assert seen[-1][2] in Path("index.html").read_text()
        assert device == torch.device("cpu")
        assert (args.iterations, args.max_time) == (
            (3, -1.0) if budget[0] == "-i" else (1, 2.5))
        seen.append((scene_id, alg, filename))
        Path(filename).write_bytes(b"BM")
        return 0.5, 4

    stub_render(fake_render)
    monkeypatch.chdir(tmp_path)
    report.full_report(_args(*budget))
    assert seen == [(s, a, cli.build_default_filename(c, a))
                    for s, c in enumerate(SCENE_CONFIGS) for a in ALGORITHMS]
    out = capsys.readouterr().out
    assert out.count("done in 0.50 s") == 28
    assert _running_lines(out) == [f"Running {report.ALGORITHM_NAMES[a]}"
                                   for _ in SCENE_CONFIGS for a in ALGORITHMS]
    state = json.loads(Path(report.STATE_FILE).read_text())
    assert list(state) == NAMES
    settings = report._effective_settings(_args(*budget))
    assert all(r["iters"] == 4 and r["settings"] == settings
               for r in state.values())

    # A second run with the same flags renders nothing; other flags
    # render everything again.
    seen.clear()
    report.full_report(_args(*budget))
    assert seen == [] and capsys.readouterr().out.count("already done") == 28
    stub_render(lambda *a: (0.25, 1))
    report.full_report(_args(*budget, "--seed", "7"))
    assert capsys.readouterr().out.count("done in 0.25 s") == 28


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """The whole --report at 8x8 -i 1 in this process, on the CPU, while
    fresh CLI subprocesses render scene 0's el, pt and vcm with the same
    flags -> (report dir, subprocess dir, the report's stdout, its
    seconds)."""
    rep = tmp_path_factory.mktemp("report")
    ref = tmp_path_factory.mktemp("cli")
    flags = ["--resolution", "8", "8", "-i", "1", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()),
               SMALLVCM_TPU_TORCH_CACHE=str(ref / "caps"))
    env["PYTHONPATH"] = (str(ROOT) + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else str(ROOT))
    procs = {alg: subprocess.Popen(
        [sys.executable, "-m", "smallvcm_tpu_torch.cli", "-s", "0", "-a",
         alg, "-o", str(ref / f"{alg}.bmp"), *flags], cwd=str(ref), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for alg in ("el", "pt", "vcm")}
    cwd = os.getcwd()
    cache = os.environ.get("SMALLVCM_TPU_TORCH_CACHE")
    os.environ["SMALLVCM_TPU_TORCH_CACHE"] = str(rep / "caps")
    buf = io.StringIO()
    try:
        os.chdir(rep)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["--report", *flags]) == 0
        secs = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        if cache is None:
            del os.environ["SMALLVCM_TPU_TORCH_CACHE"]
        else:
            os.environ["SMALLVCM_TPU_TORCH_CACHE"] = cache
    for alg, proc in procs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, (alg, err[-800:])
    return rep, ref, buf.getvalue(), secs


@pytest.mark.parametrize("alg", ["el", "pt", "vcm"])
def test_report_bmp_equals_fresh_cli(full_run, alg):
    """The in-process report writes what a fresh CLI process writes with
    the same flags, byte for byte."""
    rep, ref, _, _ = full_run
    name = cli.build_default_filename(SCENE_CONFIGS[0], alg)
    got = (rep / name).read_bytes()
    assert got == (ref / f"{alg}.bmp").read_bytes()
    assert len(got) == 54 + 8 * 8 * 3


def test_report_complete_and_resumes(full_run, monkeypatch, capsys):
    """All 28 combinations render in one process at 8x8 -i 1; a re-run
    renders only what is missing."""
    rep, _, out, secs = full_run
    bmps = sorted(p.name for p in rep.glob("*.bmp"))
    assert bmps == sorted(NAMES)
    index = (rep / "index.html").read_text()
    assert all(b in index for b in bmps)
    state = json.loads((rep / report.STATE_FILE).read_text())
    assert list(state) == NAMES
    assert all(r["iters"] == 1 and r["elapsed"] > 0 for r in state.values())
    assert out.count("done in") == 28 and "FAILED" not in out

    victim = NAMES[5]
    before = (rep / victim).read_bytes()
    (rep / victim).unlink()
    monkeypatch.chdir(rep)
    monkeypatch.setenv("SMALLVCM_TPU_TORCH_CACHE", str(rep / "caps"))
    assert cli.main(["--report", "--resolution", "8", "8", "-i", "1",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("already done") == 27 and out.count("done in") == 1
    assert (rep / victim).read_bytes() == before
