#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: rays/sec/chip (+ full-suite mode).

The counterpart of ``bench.py`` for ``smallvcm_tpu_torch``; imports torch,
numpy and the port, nothing of JAX or of the JAX package. Default: VCM on
scene 0 at 512x512 on one card, in this process, through
``smallvcm_tpu_torch.render.render``, and ONE JSON line on stdout:

  {"metric": "rays/sec/chip (VCM, scene 0, 512x512)", "value": N,
   "unit": "rays/s", "vs_baseline": N, "impl": "smallvcm_tpu_torch",
   "device": "<card>", "ms_per_iter": ..., ...}

Everything else goes to stderr, the card's name and power limit first.

Timing. The first iteration (index 0) pays for the kernels' build and
module load and is reported on its own (``first_iter_s``). On a card the
second (index 1) captures the trace stages' CUDA graphs (graphs.py) and
is reported on its own too (``second_iter_s``, of which ``capture_s`` is
the captures' host seconds). Then single iterations run until two in a
row agree within 30%, at most ``--warmup`` of them. Then ``--repeats``
calls of ``render()`` with ``--iters`` iterations each, the iteration
index and the accumulator carried from one call to the next; each call's
own ``elapsed`` (synchronised at both ends) over its iterations is one
sample. Reported: the median ms/iteration and its spread (min, max,
repeats), and the peak device memory from the first iteration to the last
repeat (``torch.cuda.max_memory_allocated`` and
``max_memory_reserved``: a graph's private pool stays reserved between
replays; under ``--full`` the reserved peak includes the graphs of the
algorithms timed before). A timed repeat is ONE block of ``--iters``
iterations (``RenderConfig.block_size``, bench.py's ``BLOCK = 8``): on a
card each iteration is one replay of its CUDA graph and the block reads
the host once, at its end (render.py). The merge caps are measured (or
read from the port's cache) before the first iteration.

Counts, from the iteration with index 1 (bench.py's ``start_iteration=1``):
``rays_per_iter`` is ``render()``'s ray count, path segments plus enabled
shadow/connection rays (bench.py:16-20); ``candidate_pairs_pair_merge`` is
the pair merge's candidate count, read as bench.py:100-109 reads it from
the JAX package's XLA merge: ``stats[0]`` of one
``render_block_with_stats(..., merge_backend="xla")`` iteration at the
runner's caps and the chunk rule's ``merge_chunks``; the line's
``merge_caps`` names those caps (bench.py:133-141); and
``candidate_pairs_cell_merge`` is the default cell merge's, the candidates
its kernel walks.

Profile, on a card, after every timing of the run (a process that has
been profiled launches more slowly afterwards; PERF.md, PR 7): one
iteration (index 1), a block of one, under ``torch.profiler`` (CPU and
CUDA), with a ``record_function`` range around the whole ``render()``.
Kernel launches are the CUDA events other than copies and fills
(COPY_EVENTS, as chip_smoke.py counts them). ``host_launch_calls_per_iter``
counts the CUDA runtime's launch calls of that iteration
(``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaGraphLaunch``): what
the host issues, where ``launches_per_iter`` counts the kernels the device
runs. The stage split (``stages``) profiles the same iteration
again under ``graphs.eager()`` (the whole iteration is one graph
launch, which has no stages), with ranges around the light walk
(``vcm.light_walk``), the camera stage (``vcm.camera_walk``) and the
merge (``vcm._merge``): each kernel goes to the stage whose range was open
when the CPU called the CUDA API to launch it; ``rest`` is the iteration
outside the three stages (the splat flush and the framebuffer sums). A
kernel the profiler gives no launch time inside a range is counted as
``unattributed`` and said on stderr. Then three blocks of ``--iters``
iterations through render.py's block runner: ``host_syncs_per_block``
counts the synchronising operations of the first (run under
``torch.cuda.set_sync_debug_mode("warn")``, each one a warning); the
second, profiled, gives ``block_host_launch_calls_per_iter`` (its launch
calls over its iterations); the third, unprofiled with CUDA events around
each graph replay, gives ``busy_share``: the device time inside the
replays over the device time from the first replay's start to the last
one's end. (Until the iteration was one graph, busy_share divided the
profiled iteration's device ms by the unprofiled median: the profiler
lengthens each kernel a little, so on a device busy all the time that
ratio read above 1; and under the profiler the device waits between a
graph's kernels, so a profiled block reads far below 1.) On ``--device
cpu`` every device field is null.

``--full`` times all seven algorithms in this process, one after the
other, and appends one record to BENCH_TORCH_HISTORY.jsonl (or
``--history``); ``--alg A`` times A (and VCM, for the metric) and appends
the same way. The JSON line is always VCM's.

    python bench_torch.py                       # on the card
    python bench_torch.py --full
    python bench_torch.py --device cpu --res 16 --iters 1 --repeats 2 \\
        --warmup 1
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

REFERENCE_VCM_SCENE0_SECONDS = 1.6  # BASELINE.md, the reference binary

# The reference binary's CPU seconds/iteration (BASELINE.md table), scene 0,
# 512x512, for the per-algorithm vs_ref_cpu columns.
REFERENCE_SECONDS = {
    "el": 0.07, "pt": 0.60, "lt": 0.32, "ppm": 0.52, "bpm": 1.17,
    "bpt": 1.11, "vcm": 1.60,
}

SCENE_ID = 0
COUNT_ITERATION = 1
SETTLE = 0.3                  # two warm-up iterations within 30% = settled
HISTORY = ROOT / "BENCH_TORCH_HISTORY.jsonl"
RANGE = "bench::"
# (label, function of algorithms/vcm.py) for the profiled stage split.
STAGES = (("light", "light_walk"), ("camera", "camera_walk"),
          ("merge", "_merge"))
# Device events that copy or fill rather than compute. A CUDA graph runs
# a device-to-device copy node as a kernel named memcpy*, where the eager
# path's copy is a "Memcpy DtoD" event: both are copies.
COPY_EVENTS = ("Memcpy", "Memset", "memcpy")
# CUDA API calls that launch work: a kernel each, or a whole graph.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch")
# Wrapper counter name -> the CUDA function it launches.
KERNELS = {"intersect_sweep": "intersect_sweep_kernel",
           "occluded_sweep": "occluded_sweep_kernel",
           "merge_cells": "merge_cells_kernel",
           "uniform_slots": "uniform_slots_kernel"}


def metric_name(res: int) -> str:
    return f"rays/sec/chip (VCM, scene {SCENE_ID}, {res}x{res})"


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def median_spread(values) -> dict:
    """{median, min, max, n} of a list of samples."""
    if not values:
        raise ValueError("no samples")
    return dict(median=statistics.median(values), min=min(values),
                max=max(values), n=len(values))


def card_line(dev) -> str:
    """nvidia-smi's name and power limit of the card ``dev`` names."""
    if dev.type != "cuda":
        return "cpu (no card: the device fields are null)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[min(dev.index or 0, len(out) - 1)].strip()


def resolved_config(scene, cfg) -> dict:
    """What ``render()`` runs for ``cfg``: the algorithm after the ppm
    downgrade, the merge (none, the cell merge or the pair merge) and its
    caps (:func:`merge_caps`), the kernels' route and the generator."""
    from smallvcm_tpu_torch import render as R

    alg = R.resolve_algorithm(scene, cfg.algorithm)
    merge = caps = None
    if alg in ("ppm", "bpm", "vcm"):
        merge = "pair" if cfg.merge_backend == "xla" else "cell"
        caps = merge_caps(scene, cfg)
    return dict(algorithm=alg, merge=merge, caps=caps, rng=cfg.rng_kind,
                route="cuda" if scene.device.type == "cuda" else "plain")


def kernel_counters():
    from smallvcm_tpu_torch.core import rng
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    return dict(intersect_sweep=S.sweep_kernel,
                occluded_sweep=S.occluded_kernel,
                merge_cells=M.merge_cells_kernel,
                uniform_slots=rng.uniform_slots_kernel)


def time_algorithm(scene, cfg, iters: int, repeats: int,
                   warmup: int) -> dict:
    """First- and second-iteration seconds (the second captures the
    graphs on a card), settle loop, then ``repeats`` timed calls of
    ``iters`` iterations -> samples, the wrapper launch counts of the timed
    calls, the captures' host seconds, peak memory and the image mean."""
    import torch

    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R

    on_card = scene.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(scene.device)
    graphs.stage.capture_s = 0.0
    state = dict(accum=None, done=0)

    def keep(accum, done):
        state["accum"] = accum

    def run(n: int) -> float:
        _, elapsed, done, _ = R.render(
            scene, dataclasses.replace(cfg, iterations=state["done"] + n),
            accum=state["accum"], start_iter=state["done"], block_cb=keep)
        state["done"] = done
        return elapsed

    first_s = run(1)
    second_s = run(1)
    capture_s = graphs.stage.capture_s
    settle, prev = [], None
    for _ in range(warmup):
        dt = run(1)
        settle.append(dt)
        if prev is not None and abs(dt - prev) <= SETTLE * max(dt, prev):
            break
        prev = dt
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    per_iter_ms = [1e3 * run(iters) / iters for _ in range(repeats)]
    launches = {name: fn.launches for name, fn in counters.items()}
    mean = float(state["accum"].mean()) / state["done"]
    if not math.isfinite(mean):
        raise RuntimeError(f"{cfg.algorithm}: image mean is {mean}")
    gib = lambda b: b / 2 ** 30
    return dict(first_iter_s=first_s, second_iter_s=second_s,
                capture_s=capture_s if on_card else None,
                warmup_ms=[1e3 * s for s in settle],
                per_iter_ms=per_iter_ms, kernel_launches=launches,
                peak_allocated_gib=gib(torch.cuda.max_memory_allocated(
                    scene.device)) if on_card else None,
                peak_reserved_gib=gib(torch.cuda.max_memory_reserved(
                    scene.device)) if on_card else None,
                image_mean=mean)


@contextlib.contextmanager
def stage_ranges(record_function):
    """Put a ``record_function`` range around each function of STAGES in
    algorithms/vcm.py while the block runs."""
    from smallvcm_tpu_torch.algorithms import vcm

    real = {name: getattr(vcm, name) for _, name in STAGES}

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(RANGE + label):
                return fn(*args, **kwargs)
        return call

    try:
        for label, name in STAGES:
            setattr(vcm, name, ranged(label, real[name]))
        yield
    finally:
        for name, fn in real.items():
            setattr(vcm, name, fn)


def _is_launch(name: str) -> bool:
    """A CUDA event that is a kernel: not a copy or fill, nor the device
    side of a bench range."""
    return not name.startswith((*COPY_EVENTS, RANGE))


def split_profile(events) -> dict:
    """torch.profiler events of one ranged iteration -> launches, host
    launch calls, device ms, the split by stage and by kernel of this port.

    A kernel's launch time is the start of the CUDA API call with its
    correlation id (``cudaLaunchKernel`` and the like, or the
    ``cudaGraphLaunch`` of the graph that holds it; the ctypes kernels
    have no aten op to link to); its stage is the STAGES range open at that
    time, else ``rest`` inside the iteration's range, else none. A launch
    call counts where it starts, the same way."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = {}
    for e in cpu:
        if e.name.startswith(RANGE):
            ranges.setdefault(e.name[len(RANGE):], []).append(
                (e.time_range.start, e.time_range.end))
    api_start = {e.id: e.time_range.start for e in cpu
                 if e.name.startswith("cu")}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and _is_launch(e.name)]
    if not kernels:
        raise RuntimeError("profiler: no CUDA kernel recorded")
    calls = [e.time_range.start for e in cpu
             if e.name.startswith(LAUNCH_CALLS)]

    def stage_of(t):
        if t is None:
            return "unattributed"
        for label, _ in STAGES:
            if any(a <= t <= b for a, b in ranges.get(label, ())):
                return label
        if any(a <= t <= b for a, b in ranges.get("iteration", ())):
            return "rest"
        return "unattributed"

    stages = {label: dict(launches=0, host_launch_calls=0, device_ms=0.0,
                          host_ms_profiled=sum(b - a for a, b in
                                               ranges.get(label, ())) / 1e3)
              for label, _ in STAGES}
    for label in ("rest", "unattributed"):
        stages[label] = dict(launches=0, host_launch_calls=0, device_ms=0.0)
    for t in calls:
        stages[stage_of(t)]["host_launch_calls"] += 1
    by_kernel = {name: dict(launches=0, device_ms=0.0) for name in KERNELS}
    for k in kernels:
        ms = k.device_time_total / 1e3
        s = stages[stage_of(api_start.get(k.id))]
        s["launches"] += 1
        s["device_ms"] += ms
        for name, fn_name in KERNELS.items():
            if fn_name in k.name:
                by_kernel[name]["launches"] += 1
                by_kernel[name]["device_ms"] += ms
    left = stages["unattributed"]
    if left["launches"]:
        eprint(f"[profile] {left['launches']} kernel launches "
               f"({left['device_ms']:.3f} device ms) have no launch time "
               f"inside a {RANGE}* range: counted as unattributed")
    return dict(launches=len(kernels),
                host_launch_calls=sum(s["host_launch_calls"] for label, s in
                                      stages.items()
                                      if label != "unattributed"),
                device_ms=sum(k.device_time_total for k in kernels) / 1e3,
                stages=stages, kernels=by_kernel)


def block_host_counts(scene, cfg, start: int, k: int) -> dict:
    """Three blocks of ``k`` iterations from ``start`` through render.py's
    block runner, on a card -> {"host_syncs": the synchronising operations
    of the first (``torch.cuda.set_sync_debug_mode("warn")``: each one
    warns), "sync_sites": the file:line each warned at,
    "host_launch_calls": the CUDA runtime's launch calls of the second
    (profiled, CPU activity only), "busy_share": of the third, the device
    time inside its graph replays over the device time from the first
    replay's start to the last one's end (CUDA events around each replay,
    no profiler: on one stream the replays' spans are disjoint, so it is at
    most 1, and below 1 by the device's waits on the host between
    iterations)}. The runner is built first: a merge cap measurement is
    not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R

    alg = R.resolve_algorithm(scene, cfg.algorithm)
    run = R._make_block_runner(scene, cfg, alg)
    res_x, res_y = cfg.resolution
    accum = torch.zeros((res_y, res_x, 3), device=scene.device)
    torch.cuda.synchronize(scene.device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(start, k, accum)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    torch.cuda.synchronize(scene.device)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(start, k, accum)
    torch.cuda.synchronize(scene.device)

    spans = []
    replay = graphs._Graph.replay

    def timed(self, *args):
        ends = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        ends[0].record()
        out = replay(self, *args)
        ends[1].record()
        spans.append(ends)
        return out

    graphs._Graph.replay = timed
    try:
        run(start, k, accum)
    finally:
        graphs._Graph.replay = replay
    torch.cuda.synchronize(scene.device)
    if len(spans) != k:
        raise RuntimeError(f"{len(spans)} graph replays in a block of {k}")
    return dict(
        host_syncs=len(sites), sync_sites=sites,
        host_launch_calls=sum(e.name.startswith(LAUNCH_CALLS)
                              for e in prof.events()),
        busy_share=sum(a.elapsed_time(b) for a, b in spans)
        / spans[0][0].elapsed_time(spans[-1][1]))


def profile_iteration(scene, cfg, iteration: int = COUNT_ITERATION):
    """``render()`` of the one iteration ``iteration`` -> (its ray count,
    on a card split_profile of it with the eager stage split as
    ``stages`` and a block of ``cfg.block_size`` from it, else None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R

    one = dataclasses.replace(cfg, iterations=iteration + 1)
    if scene.device.type != "cuda":
        return R.render(scene, one, start_iter=iteration)[3], None

    def profiled():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(RANGE + "iteration"):
                rays = R.render(scene, one, start_iter=iteration)[3]
            torch.cuda.synchronize(scene.device)
        return rays, split_profile(prof.events())

    t0 = time.perf_counter()
    rays, out = profiled()
    t1 = time.perf_counter()
    with graphs.eager(), stage_ranges(record_function):
        out["stages"] = profiled()[1]["stages"]
    t2 = time.perf_counter()
    block = cfg.block_size or R.auto_block_size(cfg, cfg.algorithm)
    counts = block_host_counts(scene, cfg, iteration, block)
    eprint(f"[profile] {cfg.algorithm}: profiled iteration {t1 - t0:.1f} s, "
           f"eager stage split {t2 - t1:.1f} s, three blocks of {block} "
           f"{time.perf_counter() - t2:.1f} s")
    out.update(block=block, host_syncs_per_block=counts["host_syncs"],
               block_host_launch_calls_per_iter=(
                   counts["host_launch_calls"] / block),
               busy_share=counts["busy_share"])
    return rays, out


def merge_caps(scene, cfg) -> dict:
    """The block runner's merge caps for ``cfg`` (sized by its first
    render, then read from the port's cache) and the pair merge's chunk
    count at them (bench.py:103)."""
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.algorithms import vcm

    cfg = dataclasses.replace(cfg)
    R._ensure_merge_caps(scene, cfg, R.resolve_algorithm(scene,
                                                          cfg.algorithm))
    n = cfg.resolution[0] * cfg.resolution[1]
    return dict(R._caps_of(cfg),
                merge_chunks=vcm.merge_chunks_for(cfg.pair_factor, n))


def pair_counts(scene, res: int, rays: int, caps: dict) -> dict:
    """The two merges' candidate pairs of the VCM iteration with index
    COUNT_ITERATION: the pair merge's at ``caps`` (merge_caps), as
    bench.py counts them, and the cell merge's over its slot counts; each
    run's ray count must equal ``rays``."""
    from smallvcm_tpu_torch.algorithms import vcm

    _, r_pair, overflow, stats = vcm.render_block_with_stats(
        scene, COUNT_ITERATION, res, res, 1, merge_backend="xla", **caps)[:4]
    _, r_cell, _, cell_stats = vcm.render_block_with_stats(
        scene, COUNT_ITERATION, res, res, 1, merge_backend="auto",
        photon_factor=None, query_factor=None)[:4]
    for backend, r in (("xla", r_pair), ("auto", r_cell)):
        if int(r) != rays:
            raise RuntimeError(f"{backend} merge run: {int(r)} rays, "
                               f"render() counted {rays}")
    return dict(candidate_pairs_pair_merge=int(stats[0]),
                pair_merge_overflow=int(overflow),
                candidate_pairs_cell_merge=int(cell_stats[0]))


def bench_config(alg: str, res: int, block: int):
    """``alg`` at res x res, ``block`` iterations a block (a timed repeat
    is one block)."""
    from smallvcm_tpu_torch import render as R

    return R.RenderConfig(algorithm=alg, resolution=(res, res),
                          block_size=block)


def algorithm_record(scene, alg: str, args, t: dict) -> dict:
    """One algorithm's record from its timing ``t`` (time_algorithm) and
    its profiled iteration."""
    cfg = bench_config(alg, args.res, args.iters)
    ms = median_spread(t["per_iter_ms"])
    rays, prof = profile_iteration(scene, cfg)
    on_card = prof is not None
    return dict(
        ms_per_iter=ms["median"], ms_per_iter_min=ms["min"],
        ms_per_iter_max=ms["max"], repeats=ms["n"], iters=args.iters,
        per_iter_ms=t["per_iter_ms"], first_iter_s=t["first_iter_s"],
        second_iter_s=t["second_iter_s"], capture_s=t["capture_s"],
        warmup_ms=t["warmup_ms"],
        vs_ref_cpu=REFERENCE_SECONDS[alg] / (ms["median"] / 1e3),
        rays_per_iter=rays,
        launches_per_iter=prof["launches"] if on_card else None,
        host_launch_calls_per_iter=(prof["host_launch_calls"] if on_card
                                    else None),
        block=args.iters,
        host_syncs_per_block=(prof["host_syncs_per_block"] if on_card
                              else None),
        block_host_launch_calls_per_iter=(
            prof["block_host_launch_calls_per_iter"] if on_card else None),
        device_ms_per_iter=prof["device_ms"] if on_card else None,
        busy_share=prof["busy_share"] if on_card else None,
        stages=prof["stages"] if on_card else None,
        kernels=prof["kernels"] if on_card else None,
        kernel_launches=t["kernel_launches"] if on_card else None,
        peak_allocated_gib=t["peak_allocated_gib"],
        peak_reserved_gib=t["peak_reserved_gib"],
        image_mean=t["image_mean"], resolved=resolved_config(scene, cfg))


def log_record(alg: str, r: dict) -> None:
    line = (f"{alg}: {r['ms_per_iter']:.3f} ms/iter median (min "
            f"{r['ms_per_iter_min']:.3f}, max {r['ms_per_iter_max']:.3f}, "
            f"{r['repeats']} repeats of {r['iters']}); first iteration "
            f"{r['first_iter_s']:.2f} s; {r['vs_ref_cpu']:.2f}x reference "
            f"CPU; {r['rays_per_iter']} rays at iteration "
            f"{COUNT_ITERATION}; image mean {r['image_mean']:.6f}; "
            f"{r['resolved']}")
    if r["launches_per_iter"] is not None:
        line += (f"; second iteration {r['second_iter_s']:.2f} s (captures "
                 f"{r['capture_s']:.2f} s); {r['launches_per_iter']} "
                 f"launches from {r['host_launch_calls_per_iter']} host "
                 f"launch calls (in a block of {r['block']}: "
                 f"{r['block_host_launch_calls_per_iter']:.2f} an "
                 f"iteration, {r['host_syncs_per_block']} host syncs), "
                 f"{r['device_ms_per_iter']:.3f} device ms, "
                 f"busy share {r['busy_share']:.4f}; peak "
                 f"{r['peak_allocated_gib']:.3f} GiB allocated, "
                 f"{r['peak_reserved_gib']:.3f} GiB reserved")
    eprint(line)


def log_split(alg: str, r: dict) -> None:
    if r["stages"] is None:
        return
    parts = [f"{label} {s['device_ms']:.3f} ms / {s['launches']} / "
             f"{s['host_launch_calls']}" for label, s in r["stages"].items()]
    eprint(f"[split] {alg} (device ms / launches / host launch calls): "
           + ", ".join(parts))
    parts = [f"{name} {k['device_ms']:.4f} ms / {k['launches']}"
             for name, k in r["kernels"].items()]
    eprint(f"[kernels] {alg} (device ms / launches): " + ", ".join(parts))


def result_line(rec: dict, pairs: dict, device: str, res: int,
                caps: dict) -> dict:
    """bench.py's JSON line for VCM, plus the port's fields; ``caps`` are
    the merge caps the pair count was read at."""
    rays_per_s = rec["rays_per_iter"] / (rec["ms_per_iter"] / 1e3)
    baseline = rec["rays_per_iter"] / REFERENCE_VCM_SCENE0_SECONDS
    keys = ("ms_per_iter", "ms_per_iter_min", "ms_per_iter_max", "repeats",
            "iters", "block", "first_iter_s", "second_iter_s",
            "rays_per_iter")
    device_keys = ("capture_s", "launches_per_iter",
                   "host_launch_calls_per_iter", "host_syncs_per_block",
                   "block_host_launch_calls_per_iter", "device_ms_per_iter",
                   "busy_share", "stages", "kernels", "kernel_launches",
                   "peak_allocated_gib", "peak_reserved_gib")
    return {"metric": metric_name(res), "value": round(rays_per_s),
            "unit": "rays/s", "vs_baseline": rays_per_s / baseline,
            "impl": "smallvcm_tpu_torch", "device": device,
            **{k: rec[k] for k in keys}, **pairs, "merge_caps": caps,
            **{k: rec[k] for k in device_keys},
            "image_mean": rec["image_mean"]}


def parse_args(argv=None):
    from smallvcm_tpu_torch.render import ALGORITHMS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; without a card it "
                         "raises)")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8,
                    help="iterations per timed repeat, run as one block")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=6,
                    help="at most this many settle iterations")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--full", action="store_true",
                      help="time all seven algorithms, append history")
    mode.add_argument("--alg", choices=ALGORITHMS,
                      help="time this algorithm too, append history")
    ap.add_argument("--history", type=Path, default=HISTORY,
                    help="JSON-lines file --full/--alg append to")
    args = ap.parse_args(argv)
    for name in ("res", "iters", "repeats"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")
    if args.warmup < 0:
        ap.error("--warmup must be >= 0")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from smallvcm_tpu_torch.device import resolve_device
    from smallvcm_tpu_torch.render import ALGORITHMS
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    dev = resolve_device(args.device)
    card = card_line(dev)
    eprint(f"[card] {card}")
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    scene = load_cornell_box((args.res, args.res), SCENE_CONFIGS[SCENE_ID],
                             device=dev)
    algs = list(ALGORITHMS) if args.full else \
        ([args.alg] if args.alg else [])
    if "vcm" not in algs:
        algs.append("vcm")
    # Every timing comes before the first profiler session: a process
    # that has been profiled launches more slowly afterwards.
    timings = {alg: time_algorithm(scene,
                                   bench_config(alg, args.res, args.iters),
                                   args.iters, args.repeats, args.warmup)
               for alg in algs}
    records = {}
    for alg in algs:
        records[alg] = algorithm_record(scene, alg, args, timings[alg])
        log_record(alg, records[alg])
        log_split(alg, records[alg])
    vcm_rec = records["vcm"]
    caps = vcm_rec["resolved"]["caps"]
    pairs = pair_counts(scene, args.res, vcm_rec["rays_per_iter"], caps)
    eprint(f"[pairs] vcm iteration {COUNT_ITERATION}: pair merge "
           f"{pairs['candidate_pairs_pair_merge']} at {caps} (overflow "
           f"{pairs['pair_merge_overflow']}), cell merge "
           f"{pairs['candidate_pairs_cell_merge']} candidate pairs")
    line = result_line(vcm_rec, pairs, device, args.res, caps)
    if args.full or args.alg:
        record = dict(ts=time.time(), impl="smallvcm_tpu_torch",
                      device=device, card=card, torch=torch.__version__,
                      cuda=torch.version.cuda, scene=SCENE_ID, res=args.res,
                      iters=args.iters, repeats=args.repeats,
                      warmup=args.warmup, algorithms=records, vcm=line)
        with open(args.history, "a") as f:
            f.write(json.dumps(record) + "\n")
        eprint(f"[history] appended to {args.history}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
