"""What a cell is, found by name: ``BENCHMARK.json`` names the cell's
configuration and traffic, whose files sit in ``configs/`` and
``traffic/``; every metric has a reader in ``metrics/<name>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # metric names, in BENCHMARK.json's order
    per_layer: list
    bench_dir: Path = BENCH_DIR


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def cell_spec(bench: dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (known: "
                         f"{', '.join(sorted(cells))})")
    w = cells[name]
    config = json.loads((bench_dir / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m["name"] for m in bench["end_to_end"]
           if _reports(m, name, ())]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _reports(m, name, e2e)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                bench_dir)


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of metric ``name``: metrics/<name>.py, which
    defines UNIT, LAYER (None for an end-to-end metric), MOVES and
    ``read(record) -> float | None``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.exists():
        raise SystemExit(f"metric {name!r} has no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(traffic: dict):
    """The driver module that the traffic file names."""
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def apply_fault(fault) -> None:
    """Plant a fault in the timed path: ``fault`` names a function as
    "module:function" (the harness's own tests only; None in a run)."""
    if fault:
        module, fn = fault.split(":")
        getattr(importlib.import_module(module), fn)()
