"""The cell ``vcm.s1.512`` (VCM on the ``--report`` scene 1) on the CPU at a
tiny size: it resolves by name to scene 0's cell with scene 1's mask, runs
through ``render_blocks``, its check passes the program and refuses the
bfloat16 control; and the cell merge's two readers of the photon map,
``photon_rows_live`` and ``merge_ns_per_pair``, on planted summaries."""

import sys

import pytest
import torch

from benchmark.harness import env, main, spec
from benchmark.harness.context import Context
from benchmark.tests.conftest import SEED

CELL = "vcm.s1.512"
MERGE_METRICS = ("photon_rows_live", "merge_ns_per_pair")


def _context(trace: bool = False) -> Context:
    cell = spec.cell_spec(spec.load_benchmark(env.ROOT), CELL)
    cell.config["resolution"] = [12, 12]
    return Context(cell=cell, seed=SEED, seconds=0.5, trace=trace,
                   device="cpu", start_epoch=env.process_start_epoch())


def test_the_cell_is_scene_0s_cell_on_scene_1():
    bench = spec.load_benchmark(env.ROOT)
    cell = spec.cell_spec(bench, CELL)
    base = spec.cell_spec(bench, "vcm.s0.512")
    assert cell.chips == 1 and cell.config["reduced"] == []
    assert cell.config["scene_mask"] == 273     # floor, mirror, ceiling
    assert cell.traffic == base.traffic
    assert cell.end_to_end == base.end_to_end
    assert cell.per_layer == base.per_layer
    assert set(MERGE_METRICS) <= set(cell.per_layer)
    same = lambda c: {k: v for k, v in c.items()
                      if k not in ("source", "deployment", "scene_mask",
                                   "limits")}
    assert same(cell.config) == same(base.config)
    for name in MERGE_METRICS:
        assert {"vcm.s0.512", "vcm.s0.1024.x4", CELL} == set(next(
            m for m in bench["per_layer"] if m["name"] == name)["workloads"])


def test_the_cell_runs_and_its_check_refuses_the_bfloat16_control():
    ctx = _context()
    driver = spec.load_driver(ctx.traffic)
    outcome = main.run_driver(ctx)
    assert outcome.checks and all(c.ok for c in outcome.checks)
    assert outcome.failed == 0 and outcome.attempted >= 8
    control = driver.control_checks(ctx, outcome.replay, torch.bfloat16)
    assert not all(c.ok for c in control)


def test_a_traced_line_on_the_cpu_is_correct_without_device_metrics():
    line = main.run_cell(_context(trace=True))
    assert line["correct"] is True
    assert not set(MERGE_METRICS) & set(line["metrics"])


def _summary(stages, counters):
    return dict(counters=counters, spans={}, stages=stages, bounces={},
                idle=dict(share_median=None, blocks=0, gaps_s={}), ranks=[])


def _stage(ms, count=None):
    out = dict(median_ms=ms, min_ms=ms, max_ms=ms, iterations=3)
    if count is not None:
        out["count"] = count
    return out


def _cell_merge(scale):
    """The cell merge's stamps with their counts: 500 live photons of
    2,000 rows, 0.5 ms of kernel and sums over 250,000 pairs, scaled."""
    return _summary({"merge_prep": _stage(4.0, 500.0 * scale),
                     "merge_kernel": _stage(0.5 * scale, 250000.0),
                     "merge": _stage(4.0 + 0.5 * scale)},
                    {"merge.photon_rows": 2000})


WANT = {"photon_rows_live": 25.0, "merge_ns_per_pair": 2.0}


@pytest.mark.parametrize("name", MERGE_METRICS)
def test_merge_readers_on_planted_summaries(name, monkeypatch):
    from smallvcm_tpu_torch import trace

    reader = spec.load_reader(name)
    traced = {"profile": {"kernels": 1}}
    assert reader.read({}) is None
    with monkeypatch.context() as m:
        m.delitem(sys.modules, "smallvcm_tpu_torch.trace")
        assert reader.read(traced) is None        # a port without the trace
    # The cell merge's stamps without counts, as the parent's port gives them.
    monkeypatch.setattr(trace, "summary", lambda: _summary(
        {"merge_prep": _stage(4.0), "merge_kernel": _stage(0.5),
         "merge": _stage(4.5)}, {"render.rerendered_blocks": 0}))
    assert reader.read(traced) is None
    # The pair merge's stamps alone.
    monkeypatch.setattr(trace, "summary", lambda: _summary(
        {"pair_tables": _stage(2.0), "pair_expand": _stage(3.0, 900.0),
         "pair_shade": _stage(4.0, 150.0), "merge": _stage(9.0)},
        {"vcm.pair_surv_rows": 600, "merge.photon_rows": 2000}))
    assert reader.read(traced) is None
    monkeypatch.setattr(trace, "summary", lambda: _cell_merge(1.0))
    assert reader.read({}) is None                # not a traced run
    assert reader.read(traced) == pytest.approx(WANT[name])
    # Two ranks: the most of either.
    ranks = [_cell_merge(1.0), _cell_merge(1.5)]
    monkeypatch.setattr(trace, "summary", lambda: dict(_cell_merge(9.0),
                                                       ranks=ranks))
    assert reader.read(traced) == pytest.approx(1.5 * WANT[name])
