"""The cell ``vcm.s0.512.grad`` (VCM gradient steps through the pair merge)
on the CPU at a tiny size: it resolves by name, its driver runs in a copy
of the benchmark, its check passes the program and refuses the bfloat16
control and a planted gradient fault, and its readers find nothing where
the step's stamps are absent."""

import json
import shutil
import sys

import pytest
import torch

from benchmark.harness import env, main, spec
from benchmark.harness.context import Context
from benchmark.tests.conftest import SEED

CELL = "vcm.s0.512.grad"
GRAD_METRICS = ("stage_ms.grad_forward", "stage_ms.grad_backward")
F = "benchmark.tests.grad_faults:"


def _context(cell=None, trace: bool = False, fault=None) -> Context:
    """The cell at 8x8: its merge radius widened to 5% of the scene's so
    that the few paths merge, a target of 2 iterations, blocks of 2."""
    cell = cell or spec.cell_spec(spec.load_benchmark(env.ROOT), CELL)
    cell.config.update(resolution=[8, 8], radius_factor=0.05)
    cell.config["target"] = dict(cell.config["target"], iterations=2)
    cell.traffic = dict(cell.traffic, block=2)
    return Context(cell=cell, seed=SEED, seconds=0.2, trace=trace,
                   device="cpu", start_epoch=env.process_start_epoch(),
                   fault=fault)


def test_the_cell_resolves_to_the_gradient_step_and_its_metrics():
    cell = spec.cell_spec(spec.load_benchmark(env.ROOT), CELL)
    assert cell.chips == 1
    assert cell.traffic["driver"] == "grad_steps"
    assert cell.traffic["block"] == 8
    c = cell.config
    assert c["merge_backend"] == "xla" and c["n_iterations"] == 1
    assert c["loss"] == "l2" and c["reduced"] == []
    assert c["target"] == {"iterations": 64, "merge_backend": "auto",
                           "seed_offset": 1}
    assert c["start"] == {"diffuse_scale": 0.5}
    assert set(c["limits"]["grad"]) == {"loss_rel_gap", "grad_max_gap",
                                        "grad_rel_l1"}
    base = spec.cell_spec(spec.load_benchmark(env.ROOT), "vcm.s0.512.xla")
    same = ("algorithm", "scene_mask", "resolution", "max_path_length",
            "min_path_length", "radius_factor", "radius_alpha", "rng",
            "merge_backend")
    assert {k: c[k] for k in same} == {k: base.config[k] for k in same}
    assert cell.end_to_end == ["ms_per_iter", "peak_gib", "setup_s"]
    assert set(cell.per_layer) == {
        "block_ms_p90", "host_syncs_per_block", "host_launch_calls_per_iter",
        "kernels_per_iter", "idle_share.render", "idle_share.replays",
        "caps_measure_s", "graph_capture_s", "library_load_s",
        "sweep_roofline", *GRAD_METRICS}


def test_the_cell_runs_and_its_check_refuses_the_bfloat16_control():
    ctx = _context()
    driver = spec.load_driver(ctx.traffic)
    outcome = main.run_driver(ctx)
    assert outcome.checks and all(c.ok for c in outcome.checks), \
        outcome.checks
    assert outcome.failed == 0 and outcome.attempted >= 2
    assert outcome.record["truncated_steps"] == 0
    assert outcome.record["mean_loss"] > 0.0
    control = driver.control_checks(ctx, outcome.replay, torch.bfloat16)
    assert not all(c.ok for c in control), control


@pytest.mark.parametrize("fault", ["grad_leaf_scaled", "grad_loss_offset"])
def test_a_fault_in_the_step_is_not_correct(fault, restore_faults):
    line = main.run_cell(_context(fault=F + fault))
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1


def test_the_cell_is_found_and_runs_in_a_copy_of_the_benchmark(tmp_path):
    """The cell's files found by name in a copy of the benchmark, and a
    traced line on the CPU: correct, without the device's metrics."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(env.ROOT / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((env.ROOT / "BENCHMARK.json").read_text())
    cell = spec.cell_spec(bench, CELL, bench_dir)
    assert cell.bench_dir == bench_dir
    line = main.run_cell(_context(cell, trace=True))
    assert line["correct"] is True and line["failed"] == 0
    assert list(line["checks"]) == ["loss_rel_gap", "grad_max_gap",
                                    "grad_rel_l1"]
    assert not set(GRAD_METRICS) & set(line["metrics"])


def test_the_gaps_of_a_step():
    from benchmark.drivers.grad_steps import grad_gaps

    want = [torch.tensor([1.0, -2.0, 0.0]), torch.zeros(2)]
    same = grad_gaps(0.5, want, 0.5, want)
    assert same == dict(loss_rel_gap=0.0, grad_max_gap=0.0, grad_rel_l1=0.0)
    got = [torch.tensor([1.0, -2.0, 1e-3]), torch.zeros(2)]
    gaps = grad_gaps(0.51, got, 0.5, want)
    assert gaps["loss_rel_gap"] == pytest.approx(0.02)
    # The floor is 1e-3 of the leaf's mean |g_r|, 1.0.
    assert gaps["grad_max_gap"] == pytest.approx(1.0)
    assert gaps["grad_rel_l1"] == pytest.approx(1e-3 / 3.0)
    # A leaf whose reference is zero throughout takes every leaf's mean,
    # 0.6.
    got = [want[0], torch.tensor([0.0, 1e-3])]
    assert grad_gaps(0.5, got, 0.5, want)["grad_max_gap"] == \
        pytest.approx(1.0 / 0.6)
    # A value's lane mass widens its own denominator by MASS_SHARE of it:
    # the third value, 1e-3 off, over 0 + 1e-3 + 0.1 * 0.09.
    got = [torch.tensor([1.0, -2.0, 1e-3]), torch.zeros(2)]
    mass = [torch.tensor([1.0, 2.0, 0.09]), torch.zeros(2)]
    assert grad_gaps(0.5, got, 0.5, want, mass)["grad_max_gap"] == \
        pytest.approx(0.1)
    with pytest.raises(ValueError):
        grad_gaps(0.5, got, 0.5, want, mass[:1] + [torch.zeros(3)])
    nan = [torch.tensor([1.0, float("nan"), 0.0]), torch.zeros(2)]
    assert grad_gaps(0.5, nan, 0.5, want)["grad_max_gap"] == float("inf")
    with pytest.raises(ValueError):
        grad_gaps(0.5, want[:1], 0.5, want)


def _summary(stages):
    return dict(counters={}, spans={}, stages=stages, bounces={},
                idle=dict(share_median=None, blocks=0, gaps_s={}), ranks=[])


@pytest.mark.parametrize("name", GRAD_METRICS)
def test_grad_readers_find_nothing_without_the_stamps(name, monkeypatch):
    from smallvcm_tpu_torch import trace

    reader = spec.load_reader(name)
    traced = {"profile": {"kernels": 1}}
    assert reader.read({}) is None
    with monkeypatch.context() as m:
        m.delitem(sys.modules, "smallvcm_tpu_torch.trace")
        assert reader.read(traced) is None        # a port without the trace
    # A render's stamps, as a port without the step's stamps gives them.
    monkeypatch.setattr(trace, "summary", lambda: _summary(
        {"light_walk": dict(median_ms=5.0)}))
    assert reader.read(traced) is None
    monkeypatch.setattr(trace, "summary", lambda: _summary(
        {"grad_forward": dict(median_ms=40.0),
         "grad_backward": dict(median_ms=90.0)}))
    assert reader.read({}) is None                # not a traced run
    assert reader.read(traced) == {"stage_ms.grad_forward": 40.0,
                                   "stage_ms.grad_backward": 90.0}[name]
