"""A run's last line: its five keys, the checks last; and a run without a
card, or without the program beside the benchmark, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import env, main
from benchmark.tests.conftest import TINY, tiny_context

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_line_has_the_five_keys_and_is_correct(cell):
    line = main.run_cell(tiny_context(cell))
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"], name
    json.dumps(line)


def _run(cwd, extra_env=None):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    e.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vcm.s0.512",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=e, timeout=300)


def test_no_card_no_result():
    r = _run(env.ROOT)
    assert r.returncode != 0
    assert "correct" not in r.stdout


def test_benchmark_alone_is_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the program is missing: no result."""
    shutil.copy(env.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(env.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert "correct" not in r.stdout


def test_checks_print_last_on_stderr(capsys, monkeypatch):
    """main() prints the checks as the last lines of stderr and the line
    last on stdout (the card's look and the driver stood in for)."""
    from benchmark.harness.checks import Check
    from benchmark.harness.context import Outcome

    outcome = Outcome(record=dict(setup_s=1.0, window_s=2.0, iterations=8,
                                  peak_bytes=2 ** 30),
                      checks=[Check("img_max_gap", 0.0, 1e-3)], attempted=8,
                      failed=0, device=dict(platform="gpu", kind="card",
                                            count=1, memory_peak_bytes=1))
    monkeypatch.setattr(env, "check_cards", lambda n: None)
    monkeypatch.setattr(main, "run_driver", lambda ctx: outcome)
    assert main.main(["--workload", "vcm.s0.512", "--seed", "1",
                      "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["metrics"]["ms_per_iter"]["value"] == 250.0
    assert err.strip().splitlines()[-1].startswith("check img_max_gap")
