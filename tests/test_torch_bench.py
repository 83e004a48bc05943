"""bench_torch.py, the port's counterpart of bench.py, on the CPU.

* Its counts against bench.py's own count call, rendered by the JAX
  package (tests/data/torch_golden_bench_32.json: scene 0, 32x32, the
  iteration with index 1, the XLA merge). They are not equal, and the
  gap is JAX's own: JAX's one-program iteration (the golden) and JAX's
  stage-by-stage programs differ by 2 rays and 1 camera query, because
  XLA fuses each program's multiply-adds its own way. The port equals
  JAX's stage programs' rays, photons and queries exactly. Its pair merge
  counts exactly as JAX's does on the same photons and queries; the pair
  count still differs by 1-2, because photon positions drift by a few ulp
  at the first vertex and up to ~2.4e-3 after specular bounces, and the
  pair merge's count moves with the probe cells of those positions.
* The JSON contract of the CPU rehearsal, ``--full`` with ``--history``,
  ``--device cuda`` without a card, the median/spread helper, the
  profiler's stage split on synthetic events, and every timing before the
  first profiler session; the pair count's caps (the block runner's,
  with ``pair_factor``) in the JSON line and the history record.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.io.framebuffer import new_fb_planes as jnew_fb
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch import graphs
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_bench_32.json"
RES = 32
N = RES * RES
SEED = 1234
MAX_PATH = 10
# Measured gaps between the port and the golden (JAX's one-program
# iteration): rays 12,688 vs 12,686, live queries 2,740 vs 2,739, pair-merge
# candidates 3,065 vs 3,066; live photons equal.
RAYS_GAP = 2
QUERIES_GAP = 1
PAIRS_GAP = 1

_spec = importlib.util.spec_from_file_location("bench_torch",
                                               ROOT / "bench_torch.py")
bench_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_torch)


def _run(*argv, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _np(v):
    return np.stack([np.asarray(c) for c in v])


def _stored(tree) -> tvcm.StoredVertices:
    """JAX StoredVertices -> the port's, on the CPU."""
    leaf = lambda a: torch.from_numpy(np.array(a))
    return tvcm.StoredVertices(*(
        tvcm.V3(*map(leaf, f)) if isinstance(f, tuple) else leaf(f)
        for f in tree))._replace(mat_id=torch.from_numpy(
            np.asarray(tree.mat_id, np.int64)))


@pytest.fixture(scope="module")
def golden():
    g = json.loads(GOLDEN.read_text())
    assert g["overflow"] == 0
    assert g["config"]["iteration"] == bench_torch.COUNT_ITERATION
    assert g["config"]["merge_backend"] == "xla"
    return g


@pytest.fixture(scope="module")
def port():
    """The port's iteration 1 at 32x32: bench_torch's counts, and the
    stages' outputs."""
    ts = tload((RES, RES), SCENE_CONFIGS[0], device="cpu")
    cfg = R.RenderConfig(algorithm="vcm", resolution=(RES, RES))
    rays, prof = bench_torch.profile_iteration(ts, cfg)
    assert prof is None
    caps = bench_torch.merge_caps(ts, cfg)
    counts = bench_torch.pair_counts(ts, RES, rays, caps)
    it = bench_torch.COUNT_ITERATION
    misc = tvcm.compute_misc(ts, it, N, 0.003, 0.75, True, True)
    pix = torch.arange(N)
    walk = [graphs._scalar(v, "cpu")
            for v in (it, misc.mis_vm_weight, misc.mis_vc_weight)]
    verts, _, _, light_rays = tvcm.light_walk(
        ts, pix, *walk, misc.light_sub_path_count, RES, RES, SEED, MAX_PATH,
        0, True, True, False)
    _, queries, cam_rays = tvcm.camera_walk(
        ts, verts, pix, *walk, misc.light_sub_path_count, RES, SEED,
        MAX_PATH, 0, True, True, False)
    _, overflow, stats = tvcm._merge(ts, misc, queries, verts, False,
                                     MAX_PATH, 0, N, "xla", "allgather",
                                     None)
    assert int(overflow) == 0
    return SimpleNamespace(scene=ts, misc=misc, rays=rays, counts=counts,
                           caps=caps,
                           verts=verts, queries=queries, stats=stats,
                           stage_rays=int(light_rays) + int(cam_rays))


def test_bench_counts_against_jax_bench_call(golden, port):
    """bench_torch's rays and pair-merge candidates of iteration 1 against
    bench.py's call, within the measured gaps (the next test shows where
    they come from)."""
    assert port.stage_rays == port.rays
    assert port.counts["candidate_pairs_pair_merge"] == int(port.stats[0])
    assert port.counts["pair_merge_overflow"] == 0
    assert abs(port.rays - golden["rays"]) <= RAYS_GAP
    assert abs(port.counts["candidate_pairs_pair_merge"]
               - golden["candidate_pairs"]) <= PAIRS_GAP
    assert int(port.stats[1]) == golden["live_photons"]
    assert abs(int(port.stats[2]) - golden["live_queries"]) <= QUERIES_GAP
    # The cell merge sorts by the full cell key: no hash collisions, far
    # fewer candidates than the pair merge's 8-buckets-a-path hash.
    assert 0 < port.counts["candidate_pairs_cell_merge"] \
        < port.counts["candidate_pairs_pair_merge"]


def test_bench_count_gap_is_jax_program_fusion(golden, port):
    """JAX's stage programs (jitted one by one, the loop camera form that
    bench.py's call takes on the CPU) give the port's rays, photons and
    queries exactly, and differ from JAX's one-program golden by the gap;
    the merges agree on the same inputs; the pair gap is photon drift."""
    js = jload((RES, RES), SCENE_CONFIGS[0])
    it = bench_torch.COUNT_ITERATION
    misc = jvcm.compute_misc(js, it, N, 0.003, 0.75, True, True)
    assert [float(x) for x in misc] == list(port.misc)
    pix = jnp.arange(N, dtype=jnp.uint32)
    verts, _, light_rays = jax.jit(lambda p: jvcm.trace_light_paths(
        js, misc, p, it, jnew_fb(RES, RES), SEED, MAX_PATH, 0, True, True,
        False, "threefry"))(pix)
    out = jax.jit(lambda v, p: jvcm._camera_stage(
        js, misc, v, p, it, RES, SEED, MAX_PATH, 0, True, True, False,
        "threefry", "allgather", None, False))(verts, pix)
    queries, cam_rays = out[1], out[-1]
    jstats = [int(x) for x in np.asarray(jax.jit(
        lambda q, v: jvcm.merge_stage(js, misc, q, v, 8 * N, 64 * N, False,
                                      MAX_PATH, 0, 4 * N, 4 * N, N, 1))(
        queries, verts)[-1])]

    # JAX against itself: the stage programs and the golden's one program.
    jrays = int(light_rays) + int(cam_rays)
    assert (jrays, jstats[1], jstats[2]) == (12688, 1180, 2740)
    assert (golden["rays"], golden["live_photons"],
            golden["live_queries"]) == (12686, 1180, 2739)
    assert abs(jstats[0] - golden["candidate_pairs"]) <= PAIRS_GAP

    # The port equals JAX's stage programs path for path.
    assert port.rays == jrays
    assert np.array_equal(port.verts.valid.numpy(), np.asarray(verts.valid))
    assert np.array_equal(port.queries.valid.numpy(),
                          np.asarray(queries.valid))
    assert [int(x) for x in port.stats[1:]] == jstats[1:]

    # The port's pair merge counts as JAX's on JAX's photons and queries,
    # and JAX's photons alone carried into the port's give JAX's count.
    merge = lambda q, v: [int(x) for x in tvcm._merge(
        port.scene, port.misc, q, v, False, MAX_PATH, 0, N, "xla",
        "allgather", None)[-1]]
    assert merge(_stored(queries), _stored(verts)) == jstats
    assert merge(port.queries, _stored(verts)) == jstats
    assert merge(_stored(queries), port.verts)[0] == int(port.stats[0])
    assert abs(int(port.stats[0]) - jstats[0]) == 2

    # Photon drift: a few ulp at the first vertex, growing with bounces.
    valid = np.asarray(verts.valid)
    jpos, tpos = _np(verts.position), _np([c.numpy() for c in
                                          port.verts.position])
    err = np.abs(jpos - tpos).max(0)
    first = err[0][valid[0]] / np.spacing(np.abs(jpos[:, 0]).max())
    assert first.max() <= 8.0                          # measured 8.0
    assert 1e-3 < err[valid].max() < 3e-3             # measured 2.39e-3


def test_metric_string_is_bench_py_s():
    """At 512x512 the metric is letter for letter bench.py's (read from
    its text: bench.py imports jax and is not imported here)."""
    text = (ROOT / "bench.py").read_text()
    literal = re.search(r'"metric": "(rays/sec/chip[^"]*)"', text).group(1)
    assert bench_torch.metric_name(512) == literal
    assert bench_torch.REFERENCE_VCM_SCENE0_SECONDS == float(re.search(
        r"REFERENCE_VCM_SCENE0_SECONDS = ([\d.]+)", text).group(1))


FIELDS = ("metric", "value", "unit", "vs_baseline", "impl", "device",
          "ms_per_iter", "ms_per_iter_min", "ms_per_iter_max", "repeats",
          "iters", "first_iter_s", "second_iter_s", "capture_s",
          "rays_per_iter", "candidate_pairs_pair_merge",
          "pair_merge_overflow", "merge_caps",
          "candidate_pairs_cell_merge", "launches_per_iter",
          "host_launch_calls_per_iter", "device_ms_per_iter", "busy_share",
          "stages", "kernels", "kernel_launches", "peak_allocated_gib",
          "peak_reserved_gib", "image_mean")
DEVICE_FIELDS = ("capture_s", "launches_per_iter",
                 "host_launch_calls_per_iter", "device_ms_per_iter",
                 "busy_share", "stages", "kernels", "kernel_launches",
                 "peak_allocated_gib", "peak_reserved_gib")
SMALL = ("--device", "cpu", "--res", "16", "--iters", "1", "--repeats", "2",
         "--warmup", "1")


def test_json_line_contract_on_cpu():
    out = _run(*SMALL)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(FIELDS) <= set(rec)
    assert not {"vpu_f32_pct", "hbm_pct"} & set(rec)
    assert rec["metric"] == "rays/sec/chip (VCM, scene 0, 16x16)"
    assert rec["unit"] == "rays/s" and rec["impl"] == "smallvcm_tpu_torch"
    assert rec["device"] == "cpu"
    assert all(rec[k] is None for k in DEVICE_FIELDS)
    assert rec["repeats"] == 2 and rec["iters"] == 1
    assert rec["first_iter_s"] > 0 and rec["second_iter_s"] > 0
    assert rec["ms_per_iter_min"] <= rec["ms_per_iter"] \
        <= rec["ms_per_iter_max"]
    assert rec["rays_per_iter"] > 0 and rec["value"] > 0
    assert rec["value"] == round(rec["rays_per_iter"]
                                 / (rec["ms_per_iter"] / 1e3))
    assert rec["vs_baseline"] == pytest.approx(
        1.6 / (rec["ms_per_iter"] / 1e3), rel=1e-12)
    assert np.isfinite(rec["image_mean"])
    assert out.stderr.splitlines()[0].startswith("[card] cpu")
    # The pair count's caps: the runner's, with the chunk rule's count.
    caps = rec["merge_caps"]
    assert set(caps) == {"pair_factor", "photon_factor", "query_factor",
                         "merge_chunks"}
    assert caps["pair_factor"] >= 24.0 and caps["merge_chunks"] == 1
    assert rec["pair_merge_overflow"] == 0


def test_full_appends_one_history_record(tmp_path):
    before = (ROOT / "BENCH_HISTORY.jsonl").read_bytes()
    own = ROOT / "BENCH_TORCH_HISTORY.jsonl"
    own_before = own.read_bytes() if own.exists() else None
    history = tmp_path / "h.jsonl"
    out = _run(*SMALL, "--full", "--history", str(history))
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.splitlines()) == 1
    recs = [json.loads(x) for x in history.read_text().splitlines()]
    assert len(recs) == 1
    algs = recs[0]["algorithms"]
    assert list(algs) == list(R.ALGORITHMS)
    for alg, r in algs.items():
        assert r["resolved"]["rng"] == "threefry"
        assert r["resolved"]["route"] == "plain"
        assert r["repeats"] == 2 and len(r["per_iter_ms"]) == 2
        assert r["first_iter_s"] > 0 and r["vs_ref_cpu"] > 0
        assert r["launches_per_iter"] is None and r["busy_share"] is None
    assert algs["pt"]["resolved"]["merge"] is None
    assert algs["vcm"]["resolved"]["merge"] == "cell"
    assert algs["pt"]["resolved"]["caps"] is None
    for alg in ("ppm", "bpm", "vcm"):
        assert algs[alg]["resolved"]["caps"]["pair_factor"] >= 24.0
    assert algs["vcm"]["resolved"]["caps"] == recs[0]["vcm"]["merge_caps"]
    assert recs[0]["vcm"] == json.loads(out.stdout)
    assert (ROOT / "BENCH_HISTORY.jsonl").read_bytes() == before
    assert (own.read_bytes() if own.exists() else None) == own_before


def test_cuda_without_a_card_fails_with_no_json_line():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run("--res", "16", timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_median_spread():
    assert bench_torch.median_spread([3.0, 1.0, 2.0]) == dict(
        median=2.0, min=1.0, max=3.0, n=3)
    assert bench_torch.median_spread([4.0, 1.0, 2.0, 10.0]) == dict(
        median=3.0, min=1.0, max=10.0, n=4)
    assert bench_torch.median_spread([5.5]) == dict(median=5.5, min=5.5,
                                                    max=5.5, n=1)
    with pytest.raises(ValueError):
        bench_torch.median_spread([])


def _event(name, device, start, end=None, id=0, us=0.0):
    return SimpleNamespace(
        name=name, device_type=device, id=id, device_time_total=us,
        time_range=SimpleNamespace(start=start, end=start if end is None
                                   else end))


def test_split_profile_attributes_by_launch_time():
    """Each kernel goes to the range open when its CUDA API call ran;
    outside the stages but inside the iteration it is rest; a kernel with
    no API call, or one outside every range, is unattributed; Memcpy/Memset
    and the ranges' own device annotations are not launches."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event("bench::iteration", cpu, 0, 100),
        _event("bench::light", cpu, 10, 30),
        _event("bench::camera", cpu, 30, 60),
        _event("bench::merge", cpu, 60, 80),
        _event("cudaLaunchKernel", cpu, 5, id=1),
        _event("cudaLaunchKernel", cpu, 12, id=2),
        _event("cudaLaunchKernel", cpu, 40, id=3),
        _event("cudaLaunchKernel", cpu, 45, id=4),
        _event("cudaLaunchKernel", cpu, 70, id=5),
        _event("cudaMemcpyAsync", cpu, 71, id=6),
        _event("cudaLaunchKernel", cpu, 90, id=7),
        _event("cudaLaunchKernel", cpu, 101, id=8),
        _event("aten::add", cpu, 96, id=9),
        _event("elementwise_kernel", gpu, 6, id=1, us=1000.0),
        _event("elementwise_kernel", gpu, 13, id=2, us=2000.0),
        _event("intersect_sweep_kernel(Scene, float const*)", gpu, 41, id=3,
               us=300.0),
        _event("occluded_sweep_kernel", gpu, 46, id=4, us=400.0),
        _event("merge_cells_kernel", gpu, 72, id=5, us=500.0),
        _event("Memcpy DtoH (Device -> Pinned)", gpu, 72, id=6, us=50.0),
        _event("reduce_kernel", gpu, 91, id=7, us=60.0),
        _event("late_kernel", gpu, 102, id=8, us=80.0),
        _event("orphan_kernel", gpu, 97, id=9, us=70.0),
        _event("bench::light", gpu, 12, 30),
    ]
    got = bench_torch.split_profile(events)
    assert got["launches"] == 8
    # Launch calls inside the iteration: ids 1-5 and 7 (8 starts after it).
    assert got["host_launch_calls"] == 6
    assert got["device_ms"] == pytest.approx(4.41)
    st = got["stages"]
    assert (st["light"]["launches"], st["light"]["device_ms"]) == (1, 2.0)
    assert st["light"]["host_ms_profiled"] == pytest.approx(0.02)
    assert (st["camera"]["launches"], st["camera"]["device_ms"]) == (2, 0.7)
    assert (st["merge"]["launches"], st["merge"]["device_ms"]) == (1, 0.5)
    assert st["rest"]["launches"] == 2
    assert st["rest"]["device_ms"] == pytest.approx(1.06)
    assert st["unattributed"]["launches"] == 2
    assert st["unattributed"]["device_ms"] == pytest.approx(0.15)
    assert got["kernels"] == {
        "intersect_sweep": dict(launches=1, device_ms=0.3),
        "occluded_sweep": dict(launches=1, device_ms=0.4),
        "merge_cells": dict(launches=1, device_ms=0.5),
        "uniform_slots": dict(launches=0, device_ms=0.0)}
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        bench_torch.split_profile(events[:13])


def test_split_profile_counts_graph_launches():
    """A graph's kernels share the correlation id of its cudaGraphLaunch:
    they go to the stage of that one host launch call, which counts once
    however many kernels the graph holds; its copy nodes are copies."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event("bench::iteration", cpu, 0, 100),
        _event("bench::light", cpu, 10, 30),
        _event("bench::camera", cpu, 30, 60),
        _event("bench::merge", cpu, 60, 80),
        _event("cudaLaunchKernel", cpu, 11, id=1),
        _event("cudaGraphLaunch", cpu, 20, id=2),
        _event("cudaGraphLaunch", cpu, 40, id=3),
        _event("cudaLaunchKernelExC", cpu, 65, id=4),
        _event("cuLaunchKernel", cpu, 66, id=5),
        _event("cudaStreamSynchronize", cpu, 90, id=6),
        _event("elementwise_kernel", gpu, 12, id=1, us=10.0),
        *(_event("elementwise_kernel", gpu, 21 + i, id=2, us=100.0)
          for i in range(5)),
        _event("intersect_sweep_kernel", gpu, 27, id=2, us=20.0),
        *(_event("reduce_kernel", gpu, 41 + i, id=3, us=200.0)
          for i in range(7)),
        _event("occluded_sweep_kernel", gpu, 49, id=3, us=30.0),
        _event("merge_cells_kernel", gpu, 67, id=5, us=40.0),
        _event("sort_kernel", gpu, 66, id=4, us=5.0),
        # A graph's copy node runs as a kernel named memcpy*: a copy.
        _event("memcpy128", gpu, 22, id=2, us=3.0),
        _event("memcpy32_post", gpu, 42, id=3, us=3.0),
        _event("Memset (Unknown)", gpu, 43, id=3, us=3.0),
    ]
    got = bench_torch.split_profile(events)
    assert got["launches"] == 17 and got["host_launch_calls"] == 5
    st = got["stages"]
    assert (st["light"]["launches"], st["light"]["host_launch_calls"]) \
        == (7, 2)
    assert (st["camera"]["launches"], st["camera"]["host_launch_calls"]) \
        == (8, 1)
    assert (st["merge"]["launches"], st["merge"]["host_launch_calls"]) \
        == (2, 2)
    assert st["unattributed"]["launches"] == 0
    assert st["camera"]["device_ms"] == pytest.approx(1.43)
    assert got["kernels"]["intersect_sweep"] == dict(launches=1,
                                                      device_ms=0.02)


def test_every_timing_comes_before_the_first_profile(tmp_path, monkeypatch):
    """--full times all seven algorithms before it profiles any: a
    profiled process launches more slowly afterwards."""
    calls = []

    def fake_time(scene, cfg, iters, repeats, warmup):
        calls.append(("time", cfg.algorithm))
        return dict(first_iter_s=1.0, second_iter_s=0.5, capture_s=None,
                    warmup_ms=[], per_iter_ms=[2.0, 4.0], kernel_launches={},
                    peak_allocated_gib=None, peak_reserved_gib=None,
                    image_mean=0.1)

    def fake_profile(scene, cfg, iteration=1):
        calls.append(("profile", cfg.algorithm))
        return 100, None

    monkeypatch.setattr(bench_torch, "time_algorithm", fake_time)
    monkeypatch.setattr(bench_torch, "profile_iteration", fake_profile)
    monkeypatch.setattr(
        bench_torch, "pair_counts", lambda scene, res, rays, caps: dict(
            candidate_pairs_pair_merge=7, pair_merge_overflow=0,
            candidate_pairs_cell_merge=5))
    history = tmp_path / "h.jsonl"
    assert bench_torch.main(["--device", "cpu", "--res", "8", "--full",
                             "--history", str(history)]) == 0
    algs = list(R.ALGORITHMS)
    assert calls == [("time", a) for a in algs] + [("profile", a)
                                                   for a in algs]
    rec = json.loads(history.read_text())
    assert rec["vcm"]["ms_per_iter"] == 3.0
    assert rec["vcm"]["value"] == round(100 / 3e-3)
