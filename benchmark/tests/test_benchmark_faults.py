"""A run with its timed path broken underneath comes out not correct: once
for each fault a cell can have (the card's look skipped, on the CPU at a
tiny size); and the control, the reference in bfloat16 in the program's
place, fails the same limits."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import env, main
from benchmark.tests.conftest import tiny_context

F = "benchmark.tests.faults:"


@pytest.mark.parametrize("cell,fault", [
    ("vcm.s0.512", "render_unchanged"),
    ("vcm.s0.512", "render_half"),
    ("vcm.s0.512", "render_altered"),
    ("pt.s0.512", "pt_half"),
])
def test_fault_is_not_correct(cell, fault, restore_faults):
    line = main.run_cell(tiny_context(cell, fault=F + fault, seconds=1.0))
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("fault", ["exchange_left_out",
                                   "sharded_unchanged"])
def test_sharded_fault_is_not_correct(fault):
    line = main.run_cell(tiny_context("vcm.s0.1024.x4", fault=F + fault))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["vcm.s0.512"])
def test_control_fails_and_program_passes(cell, capsys):
    """benchmark/control.py at a tiny size: the program's readings are
    under every limit, the bfloat16 control's over one of them."""
    from benchmark import control

    assert control.main(["--workload", cell, "--device", "cpu", "--res",
                         "12", "--seconds", "0.3", "--seeds", "3", "4",
                         "--controls", "1"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])["summary"]
    assert all(s["lower"] <= s["limit"] for s in summary.values())
    assert any(s["upper"] > s["limit"] for s in summary.values())


@pytest.mark.cuda
def test_vcm_cell_on_the_card():
    """The main path's cell at its stated size, on a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vcm.s0.512",
         "--seed", str(2 ** 31 + 11), "--seconds", "3", "--trace", "1"],
        cwd=env.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
