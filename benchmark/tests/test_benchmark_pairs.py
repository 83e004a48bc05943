"""The cell ``vcm.s0.512.xla`` (VCM through the pair merge) on the CPU at a
tiny size: it resolves by name, runs through ``render_blocks_pairs``, its
check passes the program and refuses the bfloat16 control, and the pair
merge's readers find nothing where its stamps are absent."""

import sys

import pytest
import torch

from benchmark.harness import env, main, spec
from benchmark.harness.context import Context
from benchmark.tests.conftest import SEED

CELL = "vcm.s0.512.xla"
PAIR_METRICS = ("stage_ms.pair_tables", "stage_ms.pair_expand",
                "stage_ms.pair_shade", "surv_rows_live")


def _context(trace: bool = False) -> Context:
    """The cell at 12x12, its merge radius widened to 5% of the scene's so
    that the few paths find photon pairs."""
    cell = spec.cell_spec(spec.load_benchmark(env.ROOT), CELL)
    cell.config.update(resolution=[12, 12], radius_factor=0.05)
    return Context(cell=cell, seed=SEED, seconds=0.5, trace=trace,
                   device="cpu", start_epoch=env.process_start_epoch())


def test_the_cell_resolves_to_the_pair_merge_and_its_metrics():
    cell = spec.cell_spec(spec.load_benchmark(env.ROOT), CELL)
    assert cell.chips == 1
    assert cell.config["merge_backend"] == "xla"
    assert cell.config["reduced"] == []
    assert cell.traffic["driver"] == "render_blocks_pairs"
    assert cell.end_to_end == ["ms_per_iter", "peak_gib", "setup_s"]
    assert set(cell.per_layer) == {
        "block_ms_p90", "host_syncs_per_block", "host_launch_calls_per_iter",
        "kernels_per_iter", "sweep_roofline", "idle_share.render",
        "stage_ms.light_walk", "stage_ms.camera_walk", "stage_ms.merge",
        "idle_share.replays", "caps_measure_s", "graph_capture_s",
        "library_load_s", "rerendered_blocks", *PAIR_METRICS}
    base = spec.cell_spec(spec.load_benchmark(env.ROOT), "vcm.s0.512")
    same = {k: v for k, v in cell.config.items()
            if k not in ("source", "deployment", "merge_backend", "assumed",
                         "limits")}
    assert same == {k: base.config[k] for k in same}


def test_the_cell_runs_and_its_check_refuses_the_bfloat16_control():
    ctx = _context()
    driver = spec.load_driver(ctx.traffic)
    outcome = main.run_driver(ctx)
    assert outcome.checks and all(c.ok for c in outcome.checks)
    assert outcome.failed == 0 and outcome.attempted >= 8
    assert "merge_counts" not in outcome.record
    control = driver.control_checks(ctx, outcome.replay, torch.bfloat16)
    assert not all(c.ok for c in control)


def test_a_traced_line_on_the_cpu_is_correct_without_device_metrics():
    line = main.run_cell(_context(trace=True))
    assert line["correct"] is True
    assert not set(PAIR_METRICS) & set(line["metrics"])


def _summary(stages, counters):
    return dict(counters=counters, spans={}, stages=stages, bounces={},
                idle=dict(share_median=None, blocks=0, gaps_s={}), ranks=[])


def _stage(ms, count=None):
    out = dict(median_ms=ms, min_ms=ms, max_ms=ms, iterations=3)
    if count is not None:
        out["count"] = count
    return out


PAIR_STAGES = {"pair_tables": _stage(2.0), "pair_expand": _stage(3.0, 900.0),
               "pair_shade": _stage(4.0, 150.0), "merge": _stage(9.0)}
WANT = {"stage_ms.pair_tables": 2.0, "stage_ms.pair_expand": 3.0,
        "stage_ms.pair_shade": 4.0, "surv_rows_live": 25.0}


@pytest.mark.parametrize("name", PAIR_METRICS)
def test_pair_readers_find_nothing_without_the_stamps(name, monkeypatch):
    from smallvcm_tpu_torch import trace

    reader = spec.load_reader(name)
    traced = {"profile": {"kernels": 1}}
    assert reader.read({}) is None
    with monkeypatch.context() as m:
        m.delitem(sys.modules, "smallvcm_tpu_torch.trace")
        assert reader.read(traced) is None        # a port without the trace
    # The cell merge's stamps, as the parent's port gives them.
    cell_merge = {"merge_prep": _stage(5.0), "merge_kernel": _stage(0.5),
                  "merge": _stage(5.5)}
    monkeypatch.setattr(trace, "summary", lambda: _summary(
        cell_merge, {"render.rerendered_blocks": 0}))
    assert reader.read(traced) is None
    monkeypatch.setattr(trace, "summary", lambda: _summary(
        PAIR_STAGES, {"vcm.pair_surv_rows": 600}))
    assert reader.read({}) is None                # not a traced run
    assert reader.read(traced) == pytest.approx(WANT[name])
