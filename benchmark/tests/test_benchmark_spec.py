"""BENCHMARK.json against the contract's shape, and every configuration,
traffic mix and metric reader found by name."""

import json
import re
import shutil

import pytest

from benchmark.harness import env, spec

BENCH = json.loads((env.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fit_the_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_used_and_files_present():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = json.loads((env.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    c = spec.cell_spec(BENCH, cell)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    assert spec.load_driver(c.traffic).LIMITS in c.config["limits"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_reader_found_by_name_agrees_with_benchmark_json(metric):
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                 if m["name"] == metric)
    reader = spec.load_reader(metric)
    assert reader.UNIT == entry["unit"]
    assert reader.LAYER == entry.get("layer")
    assert reader.MOVES == entry.get("moves")
    assert reader.read({}) is None


def test_a_throwaway_cell_is_found_and_runs(tmp_path):
    """A new cell, configuration, traffic mix and per-layer metric, added
    as files and entries only, in a copy of the benchmark."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(env.ROOT / "benchmark", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((bench_dir / "configs" / "pt_cornell_512.json")
                     .read_text())
    cfg.update(resolution=[8, 8], max_path_length=4)
    (bench_dir / "configs" / "pt_cornell_8.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "two_blocks.json").write_text(json.dumps(
        {"driver": "render_blocks", "why": "a throwaway mix"}))
    (bench_dir / "metrics" / "blocks_seen.py").write_text(
        'UNIT = "count"\nLAYER = "block runner (render.py)"\n'
        'MOVES = "ms_per_iter"\n\n\ndef read(rec):\n'
        '    return rec.get("iterations")\n')
    bench["configs"].append({"name": "pt_cornell_8", "source": "https://x",
                             "file": "benchmark/configs/pt_cornell_8.json",
                             "reduced": [], "why": "throwaway"})
    bench["workloads"].append({"name": "pt.tiny", "config": "pt_cornell_8",
                               "traffic": "two_blocks", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"]:
        if m["name"] == "ms_per_iter":
            m["workloads"].append("pt.tiny")
    bench["per_layer"].append({"name": "blocks_seen", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "block runner (render.py)",
                               "moves": "ms_per_iter",
                               "workloads": ["pt.tiny"]})
    cell = spec.cell_spec(bench, "pt.tiny", bench_dir)
    assert cell.config["resolution"] == [8, 8]
    assert cell.end_to_end == ["ms_per_iter", "peak_gib", "setup_s"]
    assert cell.per_layer == ["blocks_seen"]

    from benchmark.harness import main
    from benchmark.harness.context import Context

    ctx = Context(cell=cell, seed=5, seconds=0.2, trace=True, device="cpu",
                  start_epoch=env.process_start_epoch())
    line = main.run_cell(ctx)
    assert line["correct"] is True
    assert line["metrics"]["blocks_seen"]["value"] >= 64
