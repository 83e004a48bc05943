"""One run of one cell: the driver, then the metric readers, then the
result line (the last line of stdout) and the checks (the last lines of
stderr)."""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile

from . import env, spec
from .context import Context, Outcome


def eprint(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def metrics_of(names, record: dict, bench_dir=spec.BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of the readers that find something."""
    out = {}
    for name in names:
        reader = spec.load_reader(name, bench_dir)
        value = reader.read(record)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            raise RuntimeError(f"metric {name} read {value}")
        out[name] = {"value": value, "unit": reader.UNIT}
    return out


def result_line(ctx: Context, outcome: Outcome) -> dict:
    names = ctx.cell.per_layer if ctx.trace else ctx.cell.end_to_end
    metrics = metrics_of(names, outcome.record, ctx.cell.bench_dir)
    if not ctx.trace and outcome.device.get("platform") == "gpu":
        missing = [n for n in names if n not in metrics]
        if missing:
            raise RuntimeError(f"end-to-end metrics not measured: {missing}")
    line = {
        "correct": bool(outcome.checks) and all(c.ok for c in
                                                outcome.checks),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": outcome.device,
    }
    if ctx.trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line


def run_driver(ctx: Context) -> Outcome:
    """Run the cell's driver in a caps directory of its own: the merge caps
    are measured in every run from its own seed."""
    caps = tempfile.mkdtemp(prefix="svcm_bench_caps_")
    old = os.environ.get("SMALLVCM_TPU_TORCH_CACHE")
    os.environ["SMALLVCM_TPU_TORCH_CACHE"] = caps
    try:
        outcome = spec.load_driver(ctx.traffic).run(ctx)
    finally:
        shutil.rmtree(caps, ignore_errors=True)
        if old is None:
            os.environ.pop("SMALLVCM_TPU_TORCH_CACHE", None)
        else:
            os.environ["SMALLVCM_TPU_TORCH_CACHE"] = old
    return outcome


def run_cell(ctx: Context) -> dict:
    """Run the cell -> the result line (a dict)."""
    return result_line(ctx, run_driver(ctx))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json on this machine's "
                    "cards and print one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    start = env.process_start_epoch()
    env.set_cache_dirs()
    root = env.ROOT
    cell = spec.cell_spec(spec.load_benchmark(root), args.workload)
    env.check_cards(cell.chips)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), start_epoch=start)
    return run_and_print(ctx)


def run_and_print(ctx: Context) -> int:
    """Run the cell and print its checks and its line -> 0; or, where
    this process or a rank of the run loaded JAX or the JAX package, say
    so and print no line -> 3."""
    try:
        line = run_cell(ctx)
        found = env.forbidden_modules()
    except env.ForbiddenModules as e:
        found = e.modules
    if found:
        eprint("modules of JAX or the JAX package were loaded: "
               + ", ".join(found))
        return 3
    for name, c in line["checks"].items():
        eprint(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
               f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    print(json.dumps(line), flush=True)
    return 0
