#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smallvcm_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each one raises on failure; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/ and report the build time;
3. the ray sweeps against their plain PyTorch versions, bit for bit: the
   closest-hit entry on 262,144 random rays in scene 0 (time, bound and
   the issue ceiling without FMA); then one 512x512 scene-0 VCM iteration
   with every intersect and occluded call recorded: the closest-hit entry
   on every bounce and the any-hit entry on every shadow-ray call (also
   in CUDA graph replays with each call's masks and points), with rays,
   active fraction, kernel ms and bound per call site, the 2,097,152-ray
   connection launch as recorded, with one live lane and with every lane
   active, and the sweeps' device ms and the kernel
   launches of one iteration from torch.profiler (the iteration as one
   graph, and eagerly); the RNG kernel (csrc/rng_slots.cu) against
   ``_uniform_slots_plain`` bit for bit on 262,144 path ids (0, 2**32 - 1
   and ids above 2**32 among them), 2-5 slots, Threefry and TEA, the
   stream as a device tensor and as an int, with each call's time, the
   plain chain's and the bound from the kernel's SASS instructions
   (cuobjdump), and their totals over one VCM iteration's 31 calls; the
   BSDF kernel (csrc/bsdf.cu) against the plain chains bit for bit (NaNs
   equal) on scene 0's materials: setup, evaluate, pdf, sample and
   sample_with_pdf over 262,144 lanes, evaluate over an expanded [8, N]
   camera state and setup_evaluate over [8, N], each call's time against
   its bytes bound, and the totals over one VCM iteration's walk calls;
   the lights kernel (csrc/lights.cu) against the plain chains bit for
   bit (NaNs equal): illuminate, emit and get_radiance over 262,144 lanes
   on scenes 0-3 (directional, area, point and background lights), each
   call's time against its bytes bound;
4. the cell merge's preparation (csrc/merge_prep.cu) against
   ``merge_prep_plain`` on one real 512x512 scene-0 VCM iteration at the
   main path's static caps, and on a four-rank photon table (four
   iterations' light vertices side by side, as the all-gather gives) at
   the four-card cell's photon cap: every MergeTables field as raw bits,
   a bitwise second launch, 17 launches a call, its time, the plain
   chain's and its bytes bound; the merge kernel against its plain
   version on every row of the kernel-built tables of that iteration
   (dead rows zero; the live count, r^2 and the MIS weight read from
   device memory), a bitwise second launch, its candidate-pair counts and
   its bound; the cell size formed on the device against the host's at
   the main path's radii;
5. the golden image (tests/data/torch_golden_vcm_s0_32.npz, rendered by
   the JAX package) against the port's render on the card, and a bitwise
   repeat of that render;
6. the main path through the CLI entry: VCM, scene 0, 512x512, 8
   iterations at the default block (one block of 8) -> BMP, image mean
   against the reference, kernel launch counts (the merge's once and
   the preparation's 17 times an iteration), and the same render with ``--block 1``: the same BMP bytes,
   ms/iteration and rays/s from its per-iteration lines;
7. eye light (2 iterations) and path tracing (8 iterations) at 512x512
   through the CLI: ms/iteration, rays/s, image mean against the
   reference, sweep launches, a bitwise second run; their 32x32 JAX
   golden images;
8. lt, ppm, bpm and bpt at 512x512, 2 iterations each, through the CLI:
   ms/iteration and image mean against the reference;
9. VCM 512x512 through the pair-expansion merge (``merge_backend="xla"``)
   against the cell kernel's render: means, pixels, merge launches; VCM
   with the TEA generator; ``trace_backend="xla"`` refused on the card;
10. checkpoint/resume through the CLI: -i 2 then -i 4 resumed gives the
    BMP bytes of an uninterrupted -i 4;
11. gradients: loss_and_grad against the JAX gradient golden at 32x32
    (pt, bpm); three forward+backward steps of pt and vcm at full size
    (eager, captured, replayed: the step is one CUDA graph) with time,
    peak memory and sweep launches; the sweep kernel's autograd Function
    against the plain sweep's autograd on 262,144 rays;
12. ``--report -i 1 --resolution 64 64`` on the card, every combination
    in this process: 28 BMPs and index.html, its time beside the
    subprocess report; scene 0's seven BMPs byte for byte those of fresh
    CLI processes with the same flags; device memory reserved after the
    report at most one combination's peak above the level before it;
13. sharding: two gloo ranks sharing cuda:0 (``multihost.spawn``, a
    file:// rendezvous) render VCM 512x512 with the all-gather and with
    the ring photon exchange and pt, 2 iterations each, against the
    single-process renders (pt bit for bit, VCM within rtol 1e-4 / atol
    1e-6), with every rank's kernel launch counts, ms per iteration and
    the exchange's bytes and wall ms; one sharded gradient step (vcm with
    the all-gather, pt) at 128x128 against ``loss_and_grad``; where two
    cards are visible, ``--devices 2`` (NCCL) against ``--devices 1``;
    the native codec's bytes against the numpy writers' for the VCM
    image; ``--isolate on`` with one injected fault gives the BMP bytes of
    an uninterrupted run;
14. the matrix: all 4 scenes x 7 algorithms at 32x32, 2 iterations, with
    the kernels, against the JAX images in
    tests/data/torch_golden_matrix_32.npz under the criterion of
    tests/test_torch_matrix.py, and the nine merging pairs of scenes 1-3
    again through the pair merge; one line a pair (pixels, max |err|, mean,
    launches); the golden images through ``save_hdr`` -> ``load_hdr``
    within half an RGBE quantum;
15. the bench: ``python3 bench_torch.py`` (VCM, scene 0, 512x512, its
    defaults) as a subprocess; its stdout must be one JSON line with every
    field finite, ``rays_per_iter`` equal to phase 6's rays of iteration
    1, ``launches_per_iter`` within 1% of phase 3's profiled count, a busy
    share (the device time inside a block's graph replays over their
    span, CUDA events) in (0, 1], every
    kernel launched, a timed repeat one block of 8
    with one host sync and at most BLOCK_HOST_CALLS_MAX host launch calls
    an iteration, its pair-merge count read at the runner's caps (named in
    ``merge_caps``) with no overflow; the line and its (eager) stage split
    are logged;
16. graphs against eager: scene 0 at 512x512, vcm and pt iterations 0-3,
    el, lt, ppm, bpm and bpt 0-2, each algorithm on a fresh scene, a block
    of one an iteration through render.py's block runner with the
    iteration (VCM family) or pass (el, pt) as a CUDA graph (graphs.py:
    iteration 0 eager, 1 captures, later ones replay) and under
    ``graphs.eager()``: images bit for bit, rays and the kernels'
    ``.launches`` equal, ms/iteration both ways, the host launch calls of
    one profiled block both ways (at most 100 for vcm and pt on the graphs)
    and its device events by name, and the captures' host seconds;
17. blocks: VCM 512x512 ``-i 8`` at the auto block through ``render()``,
    cold and warm: ms/iteration, one capture, one host sync a block
    (``torch.cuda.set_sync_debug_mode``), host launch calls an iteration,
    the merge launched once an iteration, peak memory, the caps; the same
    render with ``--block 1`` and under ``graphs.eager()`` bit for bit
    (blocks add their iterations to the running image one by one, so the
    bound is 0); iteration 3 replayed from the iteration graph against the
    eager iteration with ``merge_cells_plain`` (rtol 1e-4, atol 1e-6);
    tiny frozen caps (0.05) grow and re-render the block to the same bytes;
    a second process reads the caps from the cache and measures nothing;
    ppm and bpm in a block of 8; el and pt in a block of 64 with one host
    sync; ``scripts/torch_scaling.py --res 2048 --ranks 1`` through the
    block runner: peak memory on one card;
18. the pair merge at static caps (``--merge-backend xla``): VCM 512x512
    ``-i 8`` through the CLI (one block) and ``render()``, cold and warm:
    ms/iteration, one capture and its seconds, one host sync a block, host
    launch calls an iteration, peak memory, the caps; ``--block 1`` and
    ``graphs.eager()`` bit for bit; a tiny pair factor (0.05) grows by the
    JAX package's rule and re-renders to the same bytes; the image against
    the cell merge's (mean within 1e-3, pixels at rtol 1e-3); iteration 1's
    candidate pairs equal to phase 15's; the profiled iteration's device
    ms and eager stage split; VCM 1024x1024 ``-i 2`` at the chunk rule's
    ``merge_chunks`` (> 1, inside the iteration graph) bit for bit equal
    to one chunk (eager); phase 11 again with caps (the gradient golden at
    measured caps, a 512x512 step at the measured caps against phase 11's
    time and memory); phase 13 again with caps (two gloo ranks on one card
    from a tiny pair factor: the overflow summed over ranks grows both to
    the same caps, by JAX's rule over a rank's paths, and the image equals
    the single process's at those caps within rtol 1e-4 / atol 1e-6);
19. sharded iterations as one CUDA graph on NCCL, in processes of their
    own (no other code of this script sees a process group): a one-rank
    NCCL group on cuda:0 renders VCM 512x512 ``-i 8`` through
    ``render()`` with the cell merge and with the pair merge, and pt ``-i
    64``, cold and warm: one capture, one host sync a block, host launch
    calls an iteration at most BLOCK_HOST_CALLS_MAX, the merge kernel once
    an iteration, the NCCL and copy events of a profiled iteration,
    ms/iteration, peak memory; each image bit for bit the warm run's and
    the single process's at the same caps, and its first 8 iterations
    bit for bit ``graphs.eager()``'s; the cell merge from caps 0.05
    overflows, grows and renders the same bytes. Where two or more cards
    are visible, two (and four) NCCL ranks render VCM with both exchanges
    and pt, bit for bit their gloo twins (eager) and within rtol
    1e-4 / atol 1e-6 of the single process, with each rank's ms/iteration,
    then ``scripts/torch_scaling.py --ranks 1 2 4``; with one card it says
    so and claims no scaling. Every group is joined under a deadline sized
    from its cases and bounded by what is left of the script's time (as
    is torch_scaling.py); a group that overruns has its ranks' stacks
    dumped and their output raised, and each group logs how long its ranks
    took to leave it.

Every phase prints its time (``[time]``) and the script its total, which
must stay inside the 1200 s its check allows. Phases 6-19 run on the
graph path wherever it applies (every render of two or more iterations
captures at its second); phase 3 records its call sites and profiles
under ``graphs.eager()``, since a replay runs no Python. The merge caps
are cached in a directory of this run alone.

The last three lines are the card's name and power limit, a JSON object
with per-kernel numbers (time, plain time, bound, launches per path) and
the result line ``{"ok": true, "device": {...}}``. It exits non-zero, with
no result, when there is no CUDA device or when the package is not
beside this script.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
GOLDEN = DATA / "torch_golden_vcm_s0_32.npz"
GRAD_GOLDEN = DATA / "torch_golden_grad_s1_32.npz"
REFERENCE_MEAN = 0.10758   # PARITY.md: scene 0, vcm, reference binary
MEAN_TOL = 0.03
# PARITY.md, scene 0, the reference binary's image means.
PARITY_MEAN = dict(el=0.52085, pt=0.08275, lt=0.08488, ppm=0.10747,
                   bpm=0.10769, bpt=0.10308, vcm=0.10758)
RES = 512
GRAD_RES = 512       # full-size gradient step (pt and vcm, 1 iteration)
SEED = 1234
SHARD_RANKS = 2
SHARD_GRAD_RES = 128
# Phase 13's sharded renders: (name, algorithm, photon exchange).
SHARD_CASES = (("vcm_allgather", "vcm", "allgather"),
               ("vcm_ring", "vcm", "ring"), ("pt", "pt", "allgather"))

# A kernel's bound is the larger of its bytes over the card's memory rate
# and its operations over the card's f32 rate (H100 SXM, NVIDIA's data
# sheet, at 700 W; the kernels do f32 arithmetic outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per ray and primitive in csrc/intersect_sweep.cu (adds,
# multiplies, one divide or square root; compares and selects are not
# counted): a triangle's edge vectors, three signed volumes and n.d take
# 56 on every ray, its numerator and division 6 more only where the ray's
# line crosses it (inside and n.d != 0); a sphere's quadratic up to the
# discriminant takes 25, the square root, the root and two divisions 5
# more only where the discriminant is >= 0.
SWEEP_OPS_TRI = 56
SWEEP_OPS_TRI_CROSS = 6
SWEEP_OPS_SPH = 25
SWEEP_OPS_SPH_ROOT = 5
# csrc/merge_cells.cu: a candidate's r^2 and path-length test; a passing
# pair's BSDF, MIS weight and accumulation (exp and log count one each),
# which reads 25 more query fields (3-27: frame, lobes, pdf and MIS
# factors, colours, exponent) and 9 more photon fields (in_dir,
# throughput, d_vcm, d_vm, continuation).
MERGE_OPS_CANDIDATE = 9
MERGE_OPS_PASS = 71
MERGE_QUERY_FIELDS = 25
MERGE_PHOTON_FIELDS = 9
# csrc/merge_prep.cu: the launches of one preparation (3 slot passes, 4
# sort passes of 3 launches, 2 bakes), and the bytes its bound counts
# (prep_bytes): a slot's validity read twice (bbox, keys), a live photon's
# position twice and a live query's once, PREP_SORT_PASSES radix passes
# that read and write an int32 key and slot over the live slots, a cap
# row's 14 f32 fields, int64 material id and int32 sorted slot read once,
# and the rows written once (ppos 16 + ptab 64 bytes a photon row; qpos 16
# + qtab 128 + ranges 32 + q_path 8 a query row). The ranges' searches read
# the L2-resident sorted key column and are not counted.
PREP_LAUNCHES = 17
PREP_SORT_PASSES = 4
PREP_ROW_IN = 14 * 4 + 8 + 4
PREP_PHOTON_ROW_OUT = 16 + 64
PREP_QUERY_ROW_OUT = 16 + 128 + 32 + 8
# csrc/rng_slots.cu is integer work, so its bound is instruction issue and
# not the f32 rate: each SM issues one warp instruction a clock on each of
# its four sub-partitions, at the H100 SXM's boost clock.
ISSUE_WARP_INSTRUCTIONS_PER_SM_CLOCK = 4
SM_CLOCK_HZ = 1.98e9
# One VCM iteration's uniform_slots calls on the main path, n_slots ->
# calls (scripts/torch_dispatch_split.py counts them by slots;
# tests/test_torch_cuda.py counts 31 launches an iteration).
RNG_VCM_CALLS = {2: 1, 3: 10, 4: 19, 5: 1}
# csrc/bsdf.cu is bound by bytes: (read, written) a lane, each operand
# byte counted once (f32 4, an int64 material id 8, a mask 1; sample reads
# three of its four uniforms), by op. An expanded camera state of a
# connection window is read once from its [N] base (the state's 65 bytes
# of evaluate's 77).
BSDF_LANE_BYTES = {"setup": (33, 82), "evaluate": (77, 24),
                   "sample": (89, 45), "setup_evaluate": (45, 28)}
BSDF_STATE_BYTES = 65
# One VCM iteration's BSDF calls at the walks' shapes (tests/
# test_torch_cuda.py counts 73 launches an iteration): over [N] lanes,
# 19 bounces (9 light, 10 camera) of setup, evaluate and sample; the
# connection windows, [w, N] for w = 8 down to 1, of evaluate (an
# expanded camera state) and setup_evaluate.
BSDF_VCM_BOUNCES = 19
BSDF_VCM_WINDOWS = tuple(range(8, 0, -1))
# csrc/lights.cu is bound by bytes: (read, written) a lane by op, the
# int64 light id 8 bytes, a position or direction 12, a uniform 4, an
# output plane 4 (emit's two flags 1 each).
LIGHT_LANE_BYTES = {"illuminate": (28, 40), "emit": (24, 50),
                    "get_radiance": (20, 20)}
# One VCM iteration's light calls over [N] lanes (pt makes the same but
# emit): NEE and hit emission at each of 10 camera bounces, one emit.
LIGHT_VCM_CALLS = {"illuminate": 10, "emit": 1, "get_radiance": 10}


# The script's own time limit (the card's check runs it under 1200 s):
# spawned groups and subprocesses get what is left of it, less EXIT_MARGIN_S
# for the lines after them.
SCRIPT_LIMIT_S = 1200.0
EXIT_MARGIN_S = 20.0
_T0 = time.monotonic()


def time_left() -> float:
    """Seconds this script may still spend before its limit."""
    return _T0 + SCRIPT_LIMIT_S - EXIT_MARGIN_S - time.monotonic()


def log(*a):
    print(*a, flush=True)


def time_cuda(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches (warm).

    The device first spins for about twice the host time of the
    repetitions, so the launches queue up behind it and run back to back:
    the events time the device work, not the host's Python and launch cost
    between the calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s * reps))  # cycles, <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: int, n_ops: int):
    """(least milliseconds the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def random_rays(torch, dev, n, seed):
    """Phase 3's random rays: origins uniform in the box, unit directions."""
    from smallvcm_tpu_torch.core.vec3 import V3

    g = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([-1.27, -1.25, -1.28], device=dev)
    hi = torch.tensor([1.28, 1.30, 1.28], device=dev)
    o = lo[:, None] + (hi - lo)[:, None] * torch.rand(
        (3, n), generator=g, device=dev)
    d = torch.randn((3, n), generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    return V3(*o.contiguous()), V3(*d.contiguous())


def check_closest(torch, S, scene, org, dirn, tag: str):
    """The closest-hit kernel against sweep_plain on these rays: distances
    bit for bit, primitive ids equal except where the two nearest
    distances tie within 1 ulp -> (max |dist err|, prim mismatches)."""
    dk, pk = S.sweep_kernel(scene, org, dirn)
    dp, pp = S.sweep_plain(scene, org, dirn)
    torch.cuda.synchronize()
    err = float((dk - dp).abs().max()) if dk.numel() else 0.0
    if not torch.equal(dk, dp):
        raise AssertionError(f"{tag}: closest-hit distances differ from "
                             f"sweep_plain (max |err| {err})")
    mism = pk != pp
    n_mism = int(mism.sum())
    if n_mism:
        all_t = torch.cat([S.tri_distances(scene, org, dirn),
                           S.sphere_distances(scene, org, dirn)], dim=1)
        t2 = torch.topk(all_t, 2, dim=1, largest=False).values
        ulp = torch.nextafter(t2[:, 0], torch.full_like(t2[:, 0], 3e38)) \
            - t2[:, 0]
        if not bool(((t2[:, 1] - t2[:, 0]) <= ulp)[mism].all()):
            raise AssertionError(
                f"{tag}: {n_mism} primitive mismatches, not all ties")
    return err, n_mism


def sweep_ops(torch, scene, org, dirn):
    """Operations of the kernels' deferred form per (ray, primitive) on
    these rays -> [R, T + S] int64: which lines cross a triangle and which
    spheres have a non-negative discriminant, by the plain version's
    formulas (ops/sweep.py::tri_distances, sphere_distances)."""
    from smallvcm_tpu_torch.core.vec3 import cross, dot

    o, d = org.expand(1), dirn.expand(1)
    ao, bo, co = (p.expand(0) - o for p in (scene.tri_p0, scene.tri_p1,
                                            scene.tri_p2))
    v0, v1, v2 = (dot(cross(a, b), d) for a, b in ((co, bo), (bo, ao),
                                                    (ao, co)))
    inside = ((v0 < 0.0) & (v1 < 0.0) & (v2 < 0.0)) | (
        (v0 >= 0.0) & (v1 >= 0.0) & (v2 >= 0.0))
    crosses = inside & (dot(scene.tri_normal.expand(0), d) != 0.0)
    oc = o - scene.sph_center.expand(0)
    r = scene.sph_radius[None, :]
    a, bq, c = dot(d, d), 2.0 * dot(d, oc), dot(oc, oc) - r * r
    root = bq * bq - 4.0 * a * c >= 0.0
    return torch.cat([SWEEP_OPS_TRI + SWEEP_OPS_TRI_CROSS * crosses.long(),
                      SWEEP_OPS_SPH + SWEEP_OPS_SPH_ROOT * root.long()], 1)


def closest_work(torch, S, scene, org, dirn):
    """(bytes, operations) the closest-hit bound counts for these rays:
    rays in (6 f32), dist (f32) and prim (int64) out, the scene block
    once; every primitive's operations on every ray."""
    n = org.x.shape[0]
    return (n * (6 * 4 + 4 + 8) + 4 * S.BLOCK_FLOATS,
            int(sweep_ops(torch, scene, org, dirn).sum()))


def check_sweep(torch, dev):
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    n = RES * RES
    org, dirn = random_rays(torch, dev, n, SEED)
    n_tri, n_sph = scene.tri_mat.shape[0], scene.sph_mat.shape[0]
    err, n_mism = check_closest(torch, S, scene, org, dirn, "sweep")
    ms = time_cuda(torch, lambda: S.sweep_kernel(scene, org, dirn), 50)
    plain_ms = time_cuda(torch, lambda: S.sweep_plain(scene, org, dirn), 10)
    n_bytes, n_ops = closest_work(torch, S, scene, org, dirn)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    issue_ms = 1e3 * n_ops / (F32_OPS_PER_S / 2)
    log(f"[sweep] {n} rays x ({n_tri} triangles, {n_sph} spheres): "
        f"max|dist err|={err:.3g} prim mismatches (ties)={n_mism}  kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms; bound {1e3 * b_ms:.2f} us "
        f"by {b_by} ({n_bytes} B, {n_ops} ops = {n_ops / n:.1f} a ray), "
        f"kernel at "
        f"{100 * b_ms / ms:.1f}% of it; issue ceiling without FMA "
        f"{1e3 * issue_ms:.2f} us, kernel at {100 * issue_ms / ms:.1f}%")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def record_iteration(torch, scene, cfg):
    """Render one iteration of ``cfg`` eagerly while recording the
    arguments of every ``intersect`` and ``occluded`` call made by
    algorithms/vcm.py -> {"intersect": [(call site, args)], "occluded":
    [...]}."""
    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.algorithms import vcm

    calls = {"intersect": [], "occluded": []}
    real = {name: getattr(vcm, name) for name in calls}

    def recorder(name):
        def rec(scene, *args):
            calls[name].append((sys._getframe(1).f_code.co_name, args))
            return real[name](scene, *args)
        return rec

    try:
        for name in calls:
            setattr(vcm, name, recorder(name))
        with graphs.eager():
            R.render(scene, cfg)
    finally:
        for name, fn in real.items():
            setattr(vcm, name, fn)
    torch.cuda.synchronize()
    return calls


def profile_iteration(torch, scene, cfg):
    """torch.profiler over one warm render of ``cfg`` (its trace stages
    replayed from their graphs: two renders before it warm up and capture)
    -> (device ms by kernel name, kernel launches, device ms in all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bench_torch import COPY_EVENTS
    from smallvcm_tpu_torch import render as R

    for _ in range(2):
        R.render(scene, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        R.render(scene, cfg)
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
        launches += not e.name.startswith(COPY_EVENTS)
    return by_name, launches, sum(by_name.values())


def occlusion_work(torch, S, scene, p, d, dist, active):
    """(bytes, operations) the any-hit bound counts for one call: the mask
    and the answer of every lane; direction, dist and point of the active
    lanes (each distinct point once); per active ray the origin and tmax (7
    operations) and the primitives its loop tests before the first blocker,
    taken from the plain version's distances, each at its deferred-form
    count (sweep_ops)."""
    from smallvcm_tpu_torch.core.vec3 import V3

    m, n_point = dist.shape[0], p.x.shape[0]
    idx = torch.arange(m, device=dist.device)[active]
    n_act = idx.numel()
    n_pts = int(torch.unique(idx % n_point).numel())
    n_bytes = 2 * m + n_act * 16 + n_pts * 12
    n_prim = scene.tri_mat.shape[0] + scene.sph_mat.shape[0]
    k = torch.arange(n_prim, device=dist.device)
    n_ops = 7 * n_act
    for part in torch.split(idx, 1 << 20):
        dd = V3(*(a[part] for a in d))
        org = V3(*(a[part % n_point] for a in p)) + dd * S.EPS_RAY
        tmax = dist[part] - 2.0 * S.EPS_RAY
        all_t = torch.cat([S.tri_distances(scene, org, dd),
                           S.sphere_distances(scene, org, dd)], dim=1)
        below = all_t < tmax[:, None]
        first = torch.where(below.any(1), below.int().argmax(1), n_prim - 1)
        first = torch.where(S.BIG_DIST < tmax, -1, first)
        tested = k[None, :] <= first[:, None]
        n_ops += int((sweep_ops(torch, scene, org, dd) * tested).sum())
    return n_bytes, n_ops


def check_occlusion_replays(torch, S, scene, shapes) -> int:
    """The any-hit kernel in CUDA graph replays: for each (lanes, points)
    shape of the iteration's calls, one graph captured on copies of its
    first call's operands, then replayed with every call of that shape
    copied in, the first last, each replay's answer held against
    occluded_plain bit for bit -> replays."""
    from smallvcm_tpu_torch.core.vec3 import V3

    replays = 0
    for group in shapes.values():
        first = group[0]
        static = (V3(*(a.clone() for a in first[0])),
                  V3(*(a.clone() for a in first[1])), first[2].clone(),
                  first[3].clone())
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            S.occluded_kernel(scene, *static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = S.occluded_kernel(scene, *static)
        dst = (*static[0], *static[1], static[2], static[3])
        for p, d, dist, active in group[1:] + group[:1]:
            for a, b in zip(dst, (*p, *d, dist, active)):
                a.copy_(b)
            graph.replay()
            want = S.occluded_plain(scene, p, d, dist, active)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(
                    f"occlusion in a graph replay ({dist.numel()} lanes): "
                    f"{int((out != want).sum())} lanes differ from "
                    "occluded_plain")
            replays += 1
        del graph
    return replays


def check_occlusion(torch, dev):
    """Phase 3, real rays: record one 512x512 scene-0 VCM iteration's
    intersect and occluded calls; hold the closest-hit kernel against
    sweep_plain on every bounce and the any-hit kernel against
    occluded_plain on every shadow-ray call, bit for bit, eagerly and in
    graph replays with each call's masks and points; time both per call
    site, the any-hit one beside its bound; time the 2,097,152-ray
    connection launch as recorded, with one live lane and with every lane
    active; profile the sweeps' device time and the launches of one
    iteration, with its trace stages as graphs and eagerly."""
    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.core.vec3 import V3
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    cfg = R.RenderConfig(algorithm="vcm", iterations=1, resolution=(RES, RES))
    R._ensure_merge_caps(scene, cfg, "vcm")   # measured here, not recorded
    calls = record_iteration(torch, scene, cfg)

    hit_ms = 0.0
    for _, (org, dirn) in calls["intersect"]:
        check_closest(torch, S, scene, org, dirn, "sweep (bounce rays)")
        hit_ms += time_cuda(torch, lambda: S.sweep_kernel(scene, org, dirn),
                            20)
    n_hit = sum(c[1][0].x.numel() for c in calls["intersect"])

    sites, tot = {}, dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0)
    biggest, shapes = None, {}
    for site, args in calls["occluded"]:
        _, p, d, dist, active = S.occlusion_operands(*args)
        got = S.occluded_kernel(scene, p, d, dist, active)
        want = S.occluded_plain(scene, p, d, dist, active)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"occlusion at {site}: kernel differs from "
                                 f"occluded_plain on "
                                 f"{int((got != want).sum())} lanes")
        ms = time_cuda(torch, lambda: S.occluded_kernel(scene, p, d, dist,
                                                        active), 20)
        org = V3(*(a.repeat(dist.numel() // a.numel()) for a in p))
        hit = time_cuda(torch, lambda: S.sweep_kernel(scene, org, d), 20)
        plain_ms = time_cuda(torch, lambda: S.occluded_plain(
            scene, p, d, dist, active), 1)
        n_bytes, n_ops = occlusion_work(torch, S, scene, p, d, dist, active)
        r = sites.setdefault(site, dict(calls=0, rays=0, active=0, ms=0.0,
                                        closest_hit_ms=0.0, bytes=0, ops=0))
        for key, v in (("calls", 1), ("rays", dist.numel()),
                       ("active", int(active.sum())), ("ms", ms),
                       ("closest_hit_ms", hit), ("bytes", n_bytes),
                       ("ops", n_ops)):
            r[key] += v
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bytes"] += n_bytes
        tot["ops"] += n_ops
        shapes.setdefault((dist.numel(), p.x.numel()), []).append(
            (p, d, dist, active))
        if biggest is None or dist.numel() > biggest[2].numel():
            biggest = (p, d, dist, active, org)
    for site, r in sites.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        log(f"[occlusion] {site}: {r['calls']} calls, {r['rays']} rays, "
            f"active {r['active'] / r['rays']:.3f}; any-hit kernel "
            f"{r['ms']:.4f} ms, bound {1e3 * r['bound_ms']:.2f} us by "
            f"{r['bound_by']}, kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it; closest-hit "
            f"kernel on the same rays {r['closest_hit_ms']:.4f} ms")
    n_replays = check_occlusion_replays(torch, S, scene, shapes)

    p, d, dist, active, org = biggest
    one = torch.zeros_like(active)
    one[int(active.nonzero()[0, 0])] = True
    every = torch.ones_like(active)
    big = {name: time_cuda(torch, lambda: S.occluded_kernel(
        scene, p, d, dist, mask), 20)
        for name, mask in (("masked", active), ("one_lane", one),
                           ("all_active", every))}
    big["closest_hit"] = time_cuda(torch, lambda: S.sweep_kernel(
        scene, org, d), 20)
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"])
    log(f"[occlusion] {dist.numel()} connection rays in one launch (active "
        f"{float(active.float().mean()):.3f}): any-hit {big['masked']:.4f} "
        f"ms, one live lane {big['one_lane']:.4f} ms, every lane active "
        f"{big['all_active']:.4f} ms, closest hit "
        f"{big['closest_hit']:.4f} ms")
    log(f"[occlusion] {len(calls['occluded'])} calls of one iteration, every "
        f"lane equal to occluded_plain, eagerly and in {n_replays} graph "
        f"replays: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.3f} ms; bound {1e3 * b_ms:.2f} us by {b_by} "
        f"({tot['bytes']} B, {tot['ops']} ops), kernel at "
        f"{100 * b_ms / tot['ms']:.1f}% of it; closest hit on the "
        f"{len(calls['intersect'])} bounces ({n_hit} rays, distances bit "
        f"for bit): {hit_ms:.4f} ms")

    by_name, launches, device_ms = profile_iteration(torch, scene, cfg)
    with graphs.eager():
        _, eager_launches, eager_ms = profile_iteration(torch, scene, cfg)
    sweeps = {k: v for k, v in by_name.items() if "sweep_kernel" in k}
    if not sweeps:
        raise AssertionError("profiler: no sweep kernel on the device")
    log(f"[profile] vcm {RES}x{RES} one iteration: sweep device "
        f"{sum(sweeps.values()):.4f} ms ({sweeps}), {launches} kernel "
        f"launches, {device_ms:.2f} device ms (graphs); eagerly "
        f"{eager_launches} kernel launches, {eager_ms:.2f} device ms")
    return dict(max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                per_site=sites, connection_launch_ms=big,
                graph_replays=n_replays, closest_hit_bounce_ms=hit_ms,
                sweep_device_ms_per_iteration=sum(sweeps.values()),
                launches_per_iteration=launches,
                eager_launches_per_iteration=eager_launches)


def sass_instructions(pattern: str):
    """SASS instructions of the built library's one function whose name
    matches ``pattern`` (cuobjdump beside nvcc; every branch counted once,
    padding NOPs and the trailing branch to itself left out), or None
    without cuobjdump."""
    from smallvcm_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_cuda.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    found, ops = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            ops = [] if re.search(pattern, line) else None
            if ops is not None:
                found.append(ops)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                     line)
        if ops is not None and m and m.group(1) != "NOP":
            ops.append(m.group(1))
    if len(found) != 1 or not found[0]:
        raise AssertionError(f"cuobjdump: {len(found)} functions match "
                             f"{pattern!r}")
    ops = found[0]
    return len(ops) - (ops[-1] == "BRA")


def rng_bound_ms(torch, dev, n: int, n_slots: int, instructions):
    """(least milliseconds a uniform_slots call over ``n`` path ids could
    take, "bytes" or "issue"): the ids read and the floats written over the
    memory rate, against one thread a pair of slots issuing
    ``instructions`` (None: bytes alone)."""
    t_bytes = (8 * n + 4 * n * n_slots) / HBM_BYTES_PER_S
    warps = math.ceil(n * ((n_slots + 1) // 2) / 32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t_issue = 0.0 if instructions is None else warps * instructions / (
        sms * ISSUE_WARP_INSTRUCTIONS_PER_SM_CLOCK * SM_CLOCK_HZ)
    return 1e3 * max(t_bytes, t_issue), ("bytes" if t_bytes >= t_issue
                                         else "issue")


def _bits_differ(torch, got, want) -> str:
    """'' where ``got`` is ``want`` bit for bit (any NaN equal to any NaN),
    else how many lanes differ and by how many ulps at most."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{got.shape} {got.dtype} against {want.shape} {want.dtype}"
    got, want = got.contiguous(), want.contiguous()
    if got.dtype != torch.float32:
        bad = int((got != want).sum())
        return f"{bad} lanes" if bad else ""
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    bad = (gi != wi) & ~(torch.isnan(got) & torch.isnan(want))
    if not bool(bad.any()):
        return ""
    ulps = int((gi[bad].long() - wi[bad].long()).abs().max())
    return f"{int(bad.sum())} lanes, up to {ulps} ulps"


def check_bsdf(torch, dev):
    """Phase 3, the BSDF: csrc/bsdf.cu's calls against the plain chains
    (``ops/bsdf.py::setup_plain`` and its siblings) bit for bit, NaNs
    equal, on scene 0's materials at the main path's shapes: setup,
    evaluate, sample and sample_with_pdf over 262,144 lanes (hits and
    misses, material ids -1 to the last), evaluate over a connection
    window's expanded [8, N] camera state and setup_evaluate over a
    contiguous [8, N] one; each call's device us against its bytes bound,
    the plain chain's ms, and the totals over one VCM iteration's calls
    (BSDF_VCM_BOUNCES, BSDF_VCM_WINDOWS), kernel and plain chain each
    timed at every window width."""
    from smallvcm_tpu_torch.core.vec3 import V3
    from smallvcm_tpu_torch.ops import bsdf as B
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    mats = scene.materials
    n, w = RES * RES, BSDF_VCM_WINDOWS[0]
    g = torch.Generator(device=dev).manual_seed(SEED)

    def lanes(shape):
        d = [torch.randn((3, *shape), generator=g, device=dev)
             for _ in range(3)]
        ray, nrm, gen = (V3(*(x / x.norm(dim=0))) for x in d)
        mat = torch.randint(-1, mats.ior.shape[0], shape, generator=g,
                            device=dev)
        hit = torch.rand(shape, generator=g, device=dev) < 0.85
        return ray, nrm, mat, hit, gen

    ray, nrm, mat, hit, gen = lanes((n,))
    u = torch.rand((n, 4), generator=g, device=dev)
    us = (u[:, 0], u[:, 1], u[:, 2])
    state = B.setup_plain(mats, ray, nrm, mat, hit)
    bro = lambda a: a.unsqueeze(0).expand(w, n)
    wide = B.BsdfState(*(V3(*map(bro, f)) if isinstance(f, V3) else bro(f)
                         for f in state))
    wray, wnrm, wmat, whit, wgen = lanes((w, n))
    wstate = B.setup_plain(mats, wray, wnrm, wmat, whit)

    def sample_pdf_plain():
        o = B.sample_plain(mats, state, *us, False)
        return (*o, B.pdf(mats, state, o[1])[1])

    # (name, op for the bytes, kernel call, plain call, lanes read as a
    # whole state, lanes)
    cases = (
        ("setup", "setup", lambda: B.setup(mats, ray, nrm, mat, hit),
         lambda: B.setup_plain(mats, ray, nrm, mat, hit), n, n),
        ("evaluate", "evaluate", lambda: B.evaluate(mats, state, gen),
         lambda: B.evaluate_plain(mats, state, gen), n, n),
        ("sample", "sample", lambda: B.sample(mats, state, *us, False),
         lambda: B.sample_plain(mats, state, *us, False), n, n),
        ("sample_with_pdf", "sample",
         lambda: B.sample_with_pdf(mats, state, *us, False),
         sample_pdf_plain, n, n),
        (f"evaluate [{w}, N], expanded state", "evaluate",
         lambda: B.evaluate(mats, wide, wgen),
         lambda: B.evaluate_plain(mats, wide, wgen), n, w * n),
        (f"setup_evaluate [{w}, N]", "setup_evaluate",
         lambda: B.setup_evaluate(mats, wray, wnrm, wmat, whit, wgen),
         lambda: (*B.evaluate_plain(mats, wstate, wgen), wstate.cont_prob),
         w * n, w * n),
    )

    def bytes_of(op, state_lanes, n_lanes):
        read, written = BSDF_LANE_BYTES[op]
        if state_lanes == n_lanes:
            return n_lanes * (read + written)
        return (state_lanes * BSDF_STATE_BYTES
                + n_lanes * (read - BSDF_STATE_BYTES + written))

    calls = {}
    for name, op, kernel, plain, state_lanes, n_lanes in cases:
        launches = B.bsdf_kernel.launches
        got, want = kernel(), plain()
        if B.bsdf_kernel.launches != launches + 1:
            raise AssertionError(f"bsdf {name}: "
                                 f"{B.bsdf_kernel.launches - launches} "
                                 "launches, not one")
        got, want = list(B._leaves(got)), list(B._leaves(want))
        diffs = {k: d for k, (a, b) in enumerate(zip(got, want))
                 if (d := _bits_differ(torch, a, b))}
        if len(got) != len(want) or diffs:
            raise AssertionError(f"bsdf {name}: output planes differ from "
                                 f"the plain chain's: {diffs}")
        ms = time_cuda(torch, kernel, 200)
        plain_ms = time_cuda(torch, plain, 5)
        b_ms, b_by = bound_ms(bytes_of(op, state_lanes, n_lanes), 0)
        calls[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           lanes=n_lanes)
        log(f"[bsdf] {name} x {n_lanes} lanes, bit for bit: kernel "
            f"{1e3 * ms:.2f} us, plain {plain_ms:.3f} ms; bound "
            f"{1e3 * b_ms:.2f} us by {b_by}, kernel at "
            f"{100 * b_ms / ms:.1f}% of it")

    # One VCM iteration's walks: the [N] calls, and each window width.
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for name in ("setup", "evaluate", "sample_with_pdf"):
        for k in tot:
            tot[k] += BSDF_VCM_BOUNCES * calls[name][k]
    windows = []
    for width in BSDF_VCM_WINDOWS:
        sl = lambda a: a[:width]
        sv = lambda v: V3(*map(sl, v))
        wd = B.BsdfState(*(sv(f) if isinstance(f, V3) else sl(f)
                           for f in wide))
        ev = lambda: B.evaluate(mats, wd, sv(wgen))
        se = lambda: B.setup_evaluate(mats, sv(wray), sv(wnrm), sl(wmat),
                                      sl(whit), sv(wgen))
        ev_plain = lambda: B.evaluate_plain(mats, wd, sv(wgen))

        def se_plain():
            b = B.setup_plain(mats, sv(wray), sv(wnrm), sl(wmat), sl(whit))
            return (*B.evaluate_plain(mats, b, sv(wgen)), b.cont_prob)

        ms = time_cuda(torch, ev, 100) + time_cuda(torch, se, 100)
        plain_ms = time_cuda(torch, ev_plain, 5) + time_cuda(torch, se_plain,
                                                             5)
        b_ms = (bound_ms(bytes_of("evaluate", n, width * n), 0)[0]
                + bound_ms(bytes_of("setup_evaluate", width * n,
                                    width * n), 0)[0])
        windows.append(dict(width=width, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms))
        for k in tot:
            tot[k] += windows[-1][k]
    n_calls = 3 * BSDF_VCM_BOUNCES + 2 * len(BSDF_VCM_WINDOWS)
    log(f"[bsdf] connection windows (evaluate + setup_evaluate) by width: "
        + ", ".join(f"{x['width']}: {1e3 * x['ms']:.1f} us, plain "
                    f"{x['plain_ms']:.3f} ms (bound "
                    f"{1e3 * x['bound_ms']:.1f} us)" for x in windows))
    log(f"[bsdf] one VCM iteration's {n_calls} walk calls: kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.2f} ms, bound "
        f"{1e3 * tot['bound_ms']:.1f} us by bytes, kernel at "
        f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of it")
    return dict(max_abs_err=0.0, **tot, bound_by="bytes", library_ms=None,
                calls=calls, windows=windows)


def check_lights(torch, dev):
    """Phase 3, the lights: csrc/lights.cu's three ops against the plain
    chains (``ops/lights.py::illuminate_plain`` and its siblings) bit for
    bit, NaNs equal, over 262,144 lanes (light ids -1 to the last) on each
    scene's light kind; each call's device us against its bytes bound and
    the plain chain's ms, and the totals over one VCM iteration's calls on
    scene 0 (LIGHT_VCM_CALLS)."""
    from smallvcm_tpu_torch.core.vec3 import V3
    from smallvcm_tpu_torch.ops import lights as L
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    n = RES * RES
    g = torch.Generator(device=dev).manual_seed(SEED)
    calls = {}
    for scene_id, config in enumerate(SCENE_CONFIGS):
        scene = load_cornell_box((RES, RES), config).to(dev)
        lights, sphere = scene.lights, scene.scene_sphere
        idx = torch.randint(-1, lights.kind.shape[0], (n,), generator=g,
                            device=dev)
        pos = V3(*(torch.rand((3, n), generator=g, device=dev) * 3 - 1.5))
        d = torch.randn((3, n), generator=g, device=dev)
        d = V3(*(d / d.norm(dim=0)))
        u = torch.rand((n, 5), generator=g, device=dev)
        ill = (lights, idx, sphere, pos, u[:, 1], u[:, 2])
        em = (lights, idx, sphere, *(u[:, k] for k in range(1, 5)))
        rad = (lights, idx, sphere, d)
        for op, args in (("illuminate", ill), ("emit", em),
                         ("get_radiance", rad)):
            kernel = lambda: getattr(L, op)(*args)
            plain = lambda: getattr(L, f"{op}_plain")(*args)
            launches = L.lights_kernel.launches
            got, want = kernel(), plain()
            if L.lights_kernel.launches != launches + 1:
                raise AssertionError(f"lights {op}: not one launch")
            diffs = {k: x for k, (a, b) in enumerate(
                zip(L._leaves(got), L._leaves(want)))
                if (x := _bits_differ(torch, a, b))}
            if diffs:
                raise AssertionError(f"lights {op}, scene {scene_id}: "
                                     f"output planes differ: {diffs}")
            ms = time_cuda(torch, kernel, 200)
            plain_ms = time_cuda(torch, plain, 5)
            b_ms, _ = bound_ms(n * sum(LIGHT_LANE_BYTES[op]), 0)
            calls[f"{op}.s{scene_id}"] = dict(ms=ms, plain_ms=plain_ms,
                                              bound_ms=b_ms, lanes=n)
            log(f"[lights] {op}, scene {scene_id} (kind "
                f"{int(lights.kind[0])}) x {n} lanes, bit for bit: kernel "
                f"{1e3 * ms:.2f} us, plain {plain_ms:.3f} ms; bound "
                f"{1e3 * b_ms:.2f} us by bytes, kernel at "
                f"{100 * b_ms / ms:.1f}% of it")
    tot = {k: sum(c * calls[f"{op}.s0"][k]
                  for op, c in LIGHT_VCM_CALLS.items())
           for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[lights] one VCM iteration's {sum(LIGHT_VCM_CALLS.values())} "
        f"calls on scene 0: kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.2f} ms, bound {1e3 * tot['bound_ms']:.1f} us "
        f"by bytes, kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}% of "
        "it")
    return dict(max_abs_err=0.0, **tot, bound_by="bytes", library_ms=None,
                calls=calls)


def check_rng(torch, dev):
    """Phase 3, the RNG: csrc/rng_slots.cu against ``_uniform_slots_plain``
    bit for bit at the main path's shapes (262,144 path ids, among them 0,
    2**32 - 1 and ids above 2**32; 2-5 slots; Threefry and TEA; the stream
    as a 0-dim device tensor, as an iteration graph gives it, and as an
    int); each call's device ms, the plain chain's, and the bound from the
    kernel's SASS instructions; the totals over one VCM iteration's calls
    (RNG_VCM_CALLS, Threefry)."""
    from smallvcm_tpu_torch.core import rng

    n = RES * RES
    g = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.randint(0, 2 ** 40, (n,), generator=g, dtype=torch.int64,
                        device=dev)
    ids[:4] = torch.tensor([0, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5],
                           device=dev)
    seed = 2 ** 32 + SEED
    it = torch.full((), 7, dtype=torch.int64, device=dev)
    stream = rng.make_stream(it, rng.STAGE_CAMERA_WALK, 2)
    word = rng.make_stream(7, rng.STAGE_CAMERA_WALK, 2)
    calls, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    by = set()
    for generator, flag in (("threefry", 0), ("tea", 1)):
        instructions = sass_instructions(
            rf"uniform_slots_kernel.*ILb{flag}E")
        for n_slots in (2, 3, 4, 5):
            kernel = lambda: rng.uniform_slots_kernel(
                seed, stream, ids, n_slots, generator)
            plain = lambda: rng._uniform_slots_plain(
                seed, word, ids, n_slots, generator)
            want = plain()
            by_int = rng.uniform_slots_kernel(seed, word, ids, n_slots,
                                              generator)
            for form, got in (("tensor", kernel()), ("int", by_int)):
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"rng {generator} {n_slots} slots, stream as "
                        f"{form}: {int((got != want).any(-1).sum())} paths "
                        "differ from _uniform_slots_plain")
            ms = time_cuda(torch, kernel, 200)
            plain_ms = time_cuda(torch, plain, 5)
            b_ms, b_by = rng_bound_ms(torch, dev, n, n_slots, instructions)
            calls.append(dict(generator=generator, n_slots=n_slots, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, instructions=instructions))
            log(f"[rng] {generator} {n_slots} slots x {n} paths, bit for "
                f"bit both stream forms: kernel {1e3 * ms:.2f} us, plain "
                f"{plain_ms:.3f} ms; bound {1e3 * b_ms:.2f} us by {b_by} "
                f"({instructions} SASS instructions a pair), kernel at "
                f"{100 * b_ms / ms:.1f}% of it")
            if generator == "threefry":
                k = RNG_VCM_CALLS[n_slots]
                tot["ms"] += k * ms
                tot["plain_ms"] += k * plain_ms
                tot["bound_ms"] += k * b_ms
                by.add(b_by)
    log(f"[rng] one VCM iteration's {sum(RNG_VCM_CALLS.values())} calls "
        f"(Threefry): kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, bound {1e3 * tot['bound_ms']:.2f} us "
        f"by {'/'.join(sorted(by))}, kernel at "
        f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of it")
    return dict(max_abs_err=0.0, **tot, bound_by="/".join(sorted(by)),
                library_ms=None, calls=calls)


def merge_work(torch, M, tabs, r2, max_pl, min_pl):
    """What the cell walk's inputs ask of it: candidate pairs, pairs within
    r, pairs that pass the r^2 test and the path-length window, and the
    bytes and operations the bound counts (each needed input byte read
    once: the live count, r^2, the MIS weight; the live queries' ranges; a
    candidate's position and path length, of query and photon; the other
    fields a passing pair uses; the output, every row of the cap)."""
    n_live = int(tabs.n_q)
    qpos, ppos, ranges = tabs.qpos, tabs.ppos, tabs.ranges[:, :n_live]
    n_q, n_p = qpos.shape[0], ppos.shape[0]
    q_cand = torch.zeros(n_q, dtype=torch.bool, device=qpos.device)
    q_pass, p_cand, p_pass = q_cand.clone(), q_cand.new_zeros(n_p), \
        q_cand.new_zeros(n_p)
    cand = near = passing = 0
    for qs, ps in M.candidate_pairs(ranges):
        d2 = sum((qpos[qs, c] - ppos[ps, c]) ** 2 for c in range(3))
        tlen = qpos[qs, 3] + ppos[ps, 3]
        in_r = d2 <= r2
        ok = in_r & (tlen <= max_pl) & (tlen >= min_pl)
        cand += qs.numel()
        near += int(in_r.sum())
        passing += int(ok.sum())
        q_cand[qs] = True
        p_cand[ps] = True
        q_pass[qs[ok]] = True
        p_pass[ps[ok]] = True
    per_q = (ranges[M.ROWS:] - ranges[:M.ROWS]).sum(0)
    n_bytes = 4 * (3 + 2 * M.ROWS * n_live + 3 * n_q
                   + 4 * int(q_cand.sum())
                   + MERGE_QUERY_FIELDS * int(q_pass.sum())
                   + 4 * int(p_cand.sum())
                   + MERGE_PHOTON_FIELDS * int(p_pass.sum()))
    n_ops = MERGE_OPS_CANDIDATE * cand + MERGE_OPS_PASS * passing
    return dict(candidates=cand, in_radius=near, passing=passing,
                max_per_query=int(per_q.max()),
                mean_per_query=cand / n_live, bytes=n_bytes, ops=n_ops)


def prep_bytes(mp: int, mq: int, n_p: int, n_q: int, pcap: int,
               qcap: int) -> int:
    """The bytes csrc/merge_prep.cu's bound counts (PREP_LAUNCHES' note)
    for mp photon and mq query slots, n_p and n_q of them live, at caps
    pcap and qcap (rows past the slot count repeat the last slot)."""
    return (2 * (mp + mq) + 12 * (2 * n_p + n_q)
            + PREP_SORT_PASSES * 16 * (n_p + n_q)
            + PREP_ROW_IN * (min(pcap, mp) + min(qcap, mq))
            + PREP_PHOTON_ROW_OUT * pcap + PREP_QUERY_ROW_OUT * qcap)


def check_merge_prep(torch, scene, cfg, misc, queries, verts, n, caps):
    """Phase 4's preparation: csrc/merge_prep.cu against merge_prep_plain
    on one real iteration at the main path's caps, and on a four-rank
    photon table (four iterations' light vertices side by side, as the
    all-gather lays every rank's columns out) at the four-card cell's caps
    (the photon cap of 4 n paths): every MergeTables field as raw bits
    (NaN equal to NaN), a bitwise second launch, PREP_LAUNCHES launches a
    call, each one's time, the plain chain's and the bytes bound ->
    (the one-rank kernel tables, the kernels line's numbers)."""
    from smallvcm_tpu_torch.algorithms import vcm
    from smallvcm_tpu_torch.ops import merge as M

    four = vcm.unpack_vertices(torch.cat([vcm.pack_vertices(verts)] + [
        vcm.pack_vertices(vcm.trace_iteration(
            scene, it, RES, RES, SEED, 10, 0)[0]) for it in range(1, 4)],
        dim=2))
    cases = (("one_rank", verts, caps),
             ("four_ranks", four, (vcm.merge_caps(
                 cfg.photon_factor, cfg.query_factor, 4 * n)[0], caps[1])))
    out, tables = {}, None
    for name, lv, (pcap, qcap) in cases:
        args = (scene, misc, queries, lv, n, pcap, qcap)
        before = M.merge_prep_kernel.launches
        got = M.merge_prep_kernel(*args)
        launches = M.merge_prep_kernel.launches - before
        again = M.merge_prep_kernel(*args)
        want = M.merge_prep_plain(*args)
        torch.cuda.synchronize()
        diffs = {f: d for f, g, w in zip(M.MergeTables._fields, got, want)
                 if (d := _bits_differ(torch, g, w))}
        if diffs or launches != PREP_LAUNCHES:
            raise AssertionError(f"merge_prep {name}: fields differ from "
                                 f"the plain chain {diffs}, {launches} "
                                 f"launches (not {PREP_LAUNCHES})")
        if any(_bits_differ(torch, g, a) for g, a in zip(got, again)):
            raise AssertionError(f"merge_prep {name}: a second launch is "
                                 "not bitwise equal")
        mp, mq = lv.valid.numel(), queries.valid.numel()
        n_p, n_q = int(got.n_p), int(got.n_q)
        if not (0 < n_p < mp and 0 < n_q < mq):
            raise AssertionError(f"merge_prep {name}: live counts {n_p} "
                                 f"of {mp}, {n_q} of {mq}")
        ms = time_cuda(torch, lambda: M.merge_prep_kernel(*args), 20)
        plain_ms = time_cuda(torch, lambda: M.merge_prep_plain(*args), 3)
        n_bytes = prep_bytes(mp, mq, n_p, n_q, pcap, qcap)
        b_ms, b_by = bound_ms(n_bytes, 0)
        log(f"[merge_prep] {name}: photon slots {mp} ({n_p} live, cap "
            f"{pcap}), query slots {mq} ({n_q} live, cap {qcap}); every "
            f"MergeTables field bit for bit the plain chain, second launch "
            f"bitwise equal, {launches} launches; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms; bound {1e3 * b_ms:.1f} us by {b_by} "
            f"({n_bytes} B), kernel at {100 * b_ms / ms:.1f}% of it")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, bytes=n_bytes,
                         slots=[mp, mq], live=[n_p, n_q], caps=[pcap, qcap])
        tables = tables or got
    one = out.pop("one_rank")
    return tables, dict(max_abs_err=0.0, library_ms=None, **one, **out)


def check_merge(torch, dev):
    """Phase 4: the preparation (check_merge_prep), then the kernel against
    its plain version on the merge tables of one real iteration at the
    main path's caps (every row, live and dead), with n_q, r^2 and the MIS
    weight in device memory as in the graph; the cell size formed on the
    device against the host's for the main path's radii."""
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.algorithms import vcm
    from smallvcm_tpu_torch.ops import hashgrid
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    n = RES * RES
    for it in range(64):
        r = vcm.compute_misc(scene, it, n, 0.003, 0.75, True, True).radius
        t = torch.tensor(r, dtype=torch.float32, device=dev)
        if float(torch.reciprocal(t * 2.0)) != hashgrid.inv_cell_size(r):
            raise AssertionError(f"merge: the device's cell size differs "
                                 f"from the host's at iteration {it}")
    cfg = R.RenderConfig(algorithm="vcm", resolution=(RES, RES))
    R._ensure_merge_caps(scene, cfg, "vcm")
    caps = vcm.merge_caps(cfg.photon_factor, cfg.query_factor, n)
    misc = vcm.compute_misc(scene, 0, n, 0.003, 0.75, True, True)
    verts, queries = vcm.trace_iteration(scene, 0, RES, RES, SEED, 10, 0)
    tabs, prep_r = check_merge_prep(torch, scene, cfg, misc, queries, verts,
                                    n, caps)
    n_q, n_p = tabs.qtab.shape[0], tabs.ptab.shape[0]
    live_q, live_p = int(tabs.n_q), int(tabs.n_p)
    if live_q > n_q or live_p > n_p:
        raise AssertionError(f"merge: caps {caps} below the live counts "
                             f"({live_p} photons, {live_q} queries)")
    kw = dict(max_path_length=10, min_path_length=0, ppm=False,
              n_live=tabs.n_q)
    dev_scalar = lambda v: torch.full((), v, device=dev)
    args = (*tabs[:5], dev_scalar(misc.radius_sqr),
            dev_scalar(misc.mis_vc_weight))
    out = M.merge_cells_kernel(*args, **kw)
    again = M.merge_cells_kernel(*args, **kw)
    want = M.merge_cells_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError("merge: a second launch is not bitwise equal")
    if float(want.abs().sum()) <= 0.0:
        raise AssertionError("merge: no query found a photon")
    if bool(out[:, live_q:].any()):
        raise AssertionError("merge: a dead query row is not zero")
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-6)
    err = float((out - want).abs().max())
    ms = time_cuda(torch, lambda: M.merge_cells_kernel(*args, **kw), 50)
    plain_ms = time_cuda(torch, lambda: M.merge_cells_plain(*args, **kw), 3)
    w = merge_work(torch, M, tabs, misc.radius_sqr, 10, 0)
    b_ms, b_by = bound_ms(w["bytes"], w["ops"])
    log(f"[merge] caps {n_q} queries ({live_q} live), {n_p} photons "
        f"({live_p} live; photon_factor {cfg.photon_factor}, query_factor "
        f"{cfg.query_factor}); candidate pairs {w['candidates']} (max "
        f"{w['max_per_query']}, mean {w['mean_per_query']:.3f} per live "
        f"query), within r {w['in_radius']}, passing r and window "
        f"{w['passing']}; all rows checked: max|err|={err:.3g}, dead rows "
        f"zero, second launch bitwise equal; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms; bound {1e3 * b_ms:.2f} us by {b_by} "
        f"({w['bytes']} B, {w['ops']} ops), kernel at "
        f"{100 * b_ms / ms:.1f}% of it; device cell size equal to the "
        f"host's at iterations 0-63")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), prep_r


def check_golden(torch, dev, path=GOLDEN):
    import numpy as np

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    data = np.load(path)
    c = json.loads(str(data["config"]))
    want = data["image"]
    res = tuple(c["resolution"])
    scene = load_cornell_box(res, SCENE_CONFIGS[c["scene_id"]]).to(dev)
    cfg = R.RenderConfig(
        algorithm=c["algorithm"], iterations=c["iterations"], resolution=res,
        base_seed=c["base_seed"], max_path_length=c["max_path_length"],
        min_path_length=c["min_path_length"],
        radius_factor=c["radius_factor"], radius_alpha=c["radius_alpha"],
    )
    img, _, _, _ = R.render(scene, cfg)
    again, _, _, _ = R.render(scene, cfg)
    if not torch.equal(img, again):
        raise AssertionError("golden: a second render is not bitwise equal")
    got = img.cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError("golden: bad image shape or non-finite values")
    close = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=2).mean()
    rel_mean = abs(float(got.mean()) / float(want.mean()) - 1.0)
    log(f"[golden] {c['algorithm']} {res[0]}x{res[1]} x{c['iterations']}: "
        f"pixels within "
        f"rtol 1e-4 = {close:.4f}, mean {got.mean():.6f} vs "
        f"{want.mean():.6f} (rel {rel_mean:.2e}), repeat bitwise equal")
    if close < 0.99 or rel_mean > 1e-4:
        raise AssertionError("golden: port disagrees with the JAX image")


_BLOCK_LINE = re.compile(r"iter (\d+)\.\.(\d+): luminance=\S+ mean=(\S+) "
                         r"rays=(\d+) dt=([\d.]+)s")


def run_cli(cli, out_path: str, alg: str = "vcm", n_iter: int = 8,
            extra=(), quiet: bool = False, rendered: int | None = None):
    """cli.main on scene 0 at RES x RES on one card -> the per-block
    (first iteration, last iteration, mean so far, rays, dt) tuples of its
    -v lines, which must cover ``rendered`` iterations (default
    ``n_iter``; fewer when a checkpoint resumes the run) in order."""
    argv = ["-s", "0", "-a", alg, "-i", str(n_iter), "--resolution",
            str(RES), str(RES), "-o", out_path, "--device", "cuda",
            "--devices", "1", "-v", *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    if not quiet:
        log("\n".join("  | " + line for line in text.splitlines()))
    if rc != 0:
        raise AssertionError(f"cli exited {rc}")
    blocks = [(int(a), int(b), float(m), int(r), float(dt))
              for a, b, m, r, dt in _BLOCK_LINE.findall(text)]
    rendered = n_iter if rendered is None else rendered
    expect = n_iter - rendered
    for a, b, *_ in blocks:
        if a != expect or b < a:
            break
        expect = b + 1
    if not blocks or expect != n_iter:
        raise AssertionError(f"cli: -v blocks {blocks} do not cover "
                             f"iterations {n_iter - rendered}..{n_iter - 1}")
    return blocks


def reset_counts(M, S):
    from smallvcm_tpu_torch.core import rng

    from smallvcm_tpu_torch.ops import bsdf, lights

    S.sweep_kernel.launches = 0
    S.occluded_kernel.launches = 0
    M.merge_cells_kernel.launches = 0
    M.merge_prep_kernel.launches = 0
    rng.uniform_slots_kernel.launches = 0
    bsdf.bsdf_kernel.launches = 0
    lights.lights_kernel.launches = 0


def read_counts(M, S) -> dict:
    from smallvcm_tpu_torch.core import rng

    from smallvcm_tpu_torch.ops import bsdf, lights

    return dict(intersect_sweep=S.sweep_kernel.launches,
                occluded_sweep=S.occluded_kernel.launches,
                merge_cells=M.merge_cells_kernel.launches,
                merge_prep=M.merge_prep_kernel.launches,
                uniform_slots=rng.uniform_slots_kernel.launches,
                bsdf=bsdf.bsdf_kernel.launches,
                lights=lights.lights_kernel.launches)


def steady(blocks):
    """(ms/iteration after the first block, rays/s after the first block,
    mean) of run_cli's blocks (all of them when there is one)."""
    tail = blocks[1:] if len(blocks) > 1 else blocks
    iters = sum(b - a + 1 for a, b, *_ in tail)
    dt = sum(x[4] for x in tail)
    return 1e3 * dt / iters, sum(x[3] for x in tail) / dt, blocks[-1][2]


def check_main_path(torch):
    """Phase 6: VCM -i 8 through cli.main at the default block (one block
    of 8), then with ``--block 1`` (eight blocks of one): BMP bytes equal,
    the merge launched once an iteration."""
    import numpy as np

    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    with tempfile.TemporaryDirectory() as tmp:
        bmp1, bmp2 = f"{tmp}/vcm1.bmp", f"{tmp}/vcm2.bmp"
        reset_counts(M, S)
        blocks = run_cli(cli, bmp1)
        launches = read_counts(M, S)
        singles = run_cli(cli, bmp2, extra=("--block", "1"), quiet=True)
        b1, b2 = Path(bmp1).read_bytes(), Path(bmp2).read_bytes()

    if len(b1) != 54 + RES * RES * 3:
        raise AssertionError(f"cli: BMP is {len(b1)} bytes")
    if [(a, b) for a, b, *_ in blocks] != [(0, 7)] or len(singles) != 8:
        raise AssertionError(f"cli: blocks {blocks}, singles {singles}")
    dts = [x[4] for x in singles]
    rays = [x[3] for x in singles]
    mean = blocks[-1][2]
    if not np.isfinite(mean) or abs(mean / REFERENCE_MEAN - 1) > MEAN_TOL:
        raise AssertionError(f"cli: image mean {mean} vs {REFERENCE_MEAN}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")
    if launches["merge_cells"] != 8 \
            or launches["merge_prep"] != 8 * PREP_LAUNCHES:
        raise AssertionError(f"main path: {launches['merge_cells']} merge "
                             f"and {launches['merge_prep']} preparation "
                             "launches for 8 iterations")
    if b1 != b2 or singles[-1][2] != mean or sum(rays) != blocks[0][3]:
        raise AssertionError("cli: --block 1 render is not bitwise the "
                             "block of 8")
    ms_iter = 1e3 * sum(dts[1:]) / len(dts[1:])
    rays_s = sum(rays[1:]) / sum(dts[1:])
    log(f"[main] vcm 512x512 x8 via cli.main: one block of 8 in "
        f"{blocks[0][4] * 1e3:.1f} ms (iteration 0 eager, 1 captures the "
        f"iteration graph); --block 1: first iteration {dts[0] * 1e3:.1f} "
        f"ms, then {ms_iter:.1f} ms/iteration, {rays_s:.4g} rays/s "
        f"({rays[-1]} rays/iteration); image mean {mean:.6f} vs reference "
        f"{REFERENCE_MEAN} ({100 * (mean / REFERENCE_MEAN - 1):+.2f}%); "
        f"launches {launches}; --block 1 bitwise equal to the block of 8")
    return launches, ms_iter, rays_s, rays[1]


def check_simple_paths(torch):
    """Phase 7: el and pt through cli.main at RES x RES."""
    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    out = {}
    for alg, n_iter, tol in (("el", 2, 0.005), ("pt", 8, 0.03)):
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts(M, S)
            iters = run_cli(cli, f"{tmp}/a.bmp", alg, n_iter)
            launches = read_counts(M, S)
            iters2 = run_cli(cli, f"{tmp}/b.bmp", alg, n_iter, quiet=True)
            same = (Path(f"{tmp}/a.bmp").read_bytes()
                    == Path(f"{tmp}/b.bmp").read_bytes())
        ms, rays_s, mean = steady(iters)
        ref = PARITY_MEAN[alg]
        if abs(mean / ref - 1) > tol:
            raise AssertionError(f"{alg}: image mean {mean} vs {ref}")
        if launches["intersect_sweep"] <= 0 or launches["merge_cells"] \
                or launches["merge_prep"] \
                or (launches["occluded_sweep"] > 0) != (alg == "pt") \
                or (launches["lights"] > 0) != (alg == "pt"):
            raise AssertionError(f"{alg}: launches {launches}")
        if not same or [i[2] for i in iters] != [i[2] for i in iters2]:
            raise AssertionError(f"{alg}: second run not bitwise equal")
        log(f"[{alg}] {RES}x{RES} x{n_iter} via cli.main: {ms:.2f} "
            f"ms/iteration, {rays_s:.4g} rays/s; mean {mean:.6f} vs "
            f"reference {ref} ({100 * (mean / ref - 1):+.3f}%); launches "
            f"{launches}; second run bitwise equal")
        out[alg] = dict(ms=ms, rays_s=rays_s, mean=mean, launches=launches)
    return out


def check_family_paths(torch):
    """Phase 8: lt, ppm, bpm, bpt through cli.main, 2 iterations."""
    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    out = {}
    for alg in ("lt", "ppm", "bpm", "bpt"):
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts(M, S)
            iters = run_cli(cli, f"{tmp}/a.bmp", alg, 2, quiet=True)
            launches = read_counts(M, S)
        ms, rays_s, mean = steady(iters)
        ref = PARITY_MEAN[alg]
        merges = alg in ("ppm", "bpm")
        if abs(mean / ref - 1) > 0.05 or launches["intersect_sweep"] <= 0 \
                or (launches["merge_cells"] > 0) != merges \
                or (launches["merge_prep"] > 0) != merges \
                or launches["lights"] <= 0:
            raise AssertionError(f"{alg}: mean {mean} vs {ref}, launches "
                                 f"{launches}")
        log(f"[{alg}] {RES}x{RES} x2 via cli.main: first "
            f"{iters[0][4] * 1e3:.1f} ms, then {ms:.1f} ms/iteration,"
            f" {rays_s:.4g} rays/s; mean {mean:.6f} vs reference {ref} "
            f"({100 * (mean / ref - 1):+.2f}%); launches {launches}")
        out[alg] = dict(ms=ms, rays_s=rays_s, mean=mean, launches=launches)
    return out


def check_merge_backends(torch, dev):
    """Phase 9: VCM through the pair merge vs the cell kernel; TEA RNG."""
    import numpy as np

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    runs = {}
    for name, kw in (("cells", {}), ("xla", dict(merge_backend="xla")),
                     ("tea", dict(rng_kind="tea"))):
        cfg = R.RenderConfig(algorithm="vcm", iterations=2,
                             resolution=(RES, RES), **kw)
        reset_counts(M, S)
        img, secs, _, rays = R.render(scene, cfg)
        runs[name] = (img.cpu().numpy(), secs, read_counts(M, S))
    cells, xla, tea = (runs[k][0] for k in ("cells", "xla", "tea"))
    rel_mean = abs(float(xla.mean()) / float(cells.mean()) - 1.0)
    close = np.isclose(xla, cells, rtol=1e-3, atol=1e-6).all(axis=-1).mean()
    if rel_mean > 1e-4 or close < 0.99:
        raise AssertionError(f"xla merge: mean rel {rel_mean}, pixels "
                             f"{close}")
    if runs["xla"][2]["merge_cells"] != 0 or \
            runs["cells"][2]["merge_cells"] <= 0:
        raise AssertionError(f"merge launches {runs['xla'][2]} / "
                             f"{runs['cells'][2]}")
    # The dense plain sweep never stands in for the kernel on a card.
    try:
        R.render(scene, R.RenderConfig(iterations=1, resolution=(RES, RES),
                                       trace_backend="xla"))
    except ValueError:
        pass
    else:
        raise AssertionError("trace_backend 'xla' rendered on the card")
    tea_rel = float(tea.mean()) / REFERENCE_MEAN - 1.0
    if abs(tea_rel) > 0.05 or not np.isfinite(tea).all():
        raise AssertionError(f"tea: mean {tea.mean()}")
    ms = {k: 1e3 * v[1] / 2 for k, v in runs.items()}
    log(f"[merge-backends] vcm {RES}x{RES} x2: cell kernel {ms['cells']:.1f} "
        f"ms/iteration, pair merge (xla) {ms['xla']:.1f} ms/iteration; "
        f"mean rel {rel_mean:.2e}, pixels within rtol 1e-3 {close:.4f}; "
        f"launches cells {runs['cells'][2]} xla {runs['xla'][2]}; tea mean "
        f"{tea.mean():.6f} ({100 * tea_rel:+.2f}% vs {REFERENCE_MEAN}); "
        f"trace_backend 'xla' refused on the card")
    return dict(ms=ms, launches={k: v[2] for k, v in runs.items()})


def check_checkpoint(torch):
    """Phase 10: -i 2 + resume to -i 4 == -i 4, bytewise, via cli.main."""
    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    with tempfile.TemporaryDirectory() as tmp:
        ck = ["--checkpoint", f"{tmp}/state.npz"]
        reset_counts(M, S)
        run_cli(cli, f"{tmp}/part.bmp", "vcm", 2,
                [*ck, "--checkpoint-every", "2"], quiet=True)
        run_cli(cli, f"{tmp}/resumed.bmp", "vcm", 4, ck, quiet=True,
                rendered=2)
        launches = read_counts(M, S)
        run_cli(cli, f"{tmp}/full.bmp", "vcm", 4, quiet=True)
        resumed = Path(f"{tmp}/resumed.bmp").read_bytes()
        full = Path(f"{tmp}/full.bmp").read_bytes()
    if resumed != full:
        raise AssertionError("checkpoint: resumed BMP differs")
    log(f"[checkpoint] vcm {RES}x{RES}: -i 2 then resumed to 4 == "
        f"uninterrupted -i 4 ({len(full)} BMP bytes equal); launches "
        f"{launches}")
    return launches


def check_gradients(torch, dev):
    """Phase 11: gradients on the card."""
    import numpy as np

    from smallvcm_tpu_torch import diff
    from smallvcm_tpu_torch.core.vec3 import V3
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    # (a) the JAX gradient golden, 32x32.
    data = np.load(GRAD_GOLDEN)
    c = json.loads(str(data["config"]))
    res_x, res_y = c["resolution"]
    scene = load_cornell_box((res_x, res_y),
                             SCENE_CONFIGS[c["scene_id"]]).to(dev)
    target = torch.full((res_y, res_x, 3), c["target"], device=dev)
    n_li = 3 * scene.lights.kind.shape[0]
    for alg in c["algorithms"]:
        loss, g = diff.loss_and_grad(
            scene, diff.extract_params(scene), target, c["iteration"], alg,
            res_x, res_y, n_iterations=c["n_iterations"],
            base_seed=c["base_seed"], max_path_length=c["max_path_length"])
        flat = torch.cat([x.reshape(-1) for x in diff._leaves(g)]).cpu()
        want = torch.from_numpy(data[f"{alg}_grad"])
        if not bool(torch.isfinite(flat).all()):
            raise AssertionError(f"grad golden {alg}: non-finite leaf")
        torch.testing.assert_close(flat[-n_li:], want[-n_li:], rtol=1e-3,
                                   atol=0.0)
        err = float(((flat - want).abs() / want.abs().max()).max())
        log(f"[grad-golden] {alg} {res_x}x{res_y}: light-intensity grads "
            f"within rtol 1e-3; every leaf finite; max |err| / max |grad| "
            f"over all leaves {err:.2e}; loss {float(loss):.6g} vs "
            f"{float(data[f'{alg}_loss']):.6g}")

    # (b) one forward+backward at full size.
    scene = load_cornell_box((GRAD_RES, GRAD_RES), SCENE_CONFIGS[0]).to(dev)
    target = torch.full((GRAD_RES, GRAD_RES, 3), 0.1, device=dev)
    steps = {}
    for alg in ("pt", "vcm"):
        times = []
        # The first step warms PyTorch's kernels (eager), the second
        # captures the step's CUDA graph, the third replays it.
        for it in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(M, S)
            t0 = time.perf_counter()
            loss, g = diff.loss_and_grad(scene, diff.extract_params(scene),
                                         target, it, alg, GRAD_RES,
                                         GRAD_RES)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = times[2]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_counts(M, S)
        leaves = diff._leaves(g)
        if not all(bool(torch.isfinite(x).all()) for x in leaves):
            raise AssertionError(f"grad {alg}: non-finite leaf")
        if float(g.light_intensity.x.abs().max()) <= 0.0:
            raise AssertionError(f"grad {alg}: zero light-intensity grad")
        if (launches["intersect_sweep"] <= 0 or launches["bsdf"] <= 0
                or launches["lights"] <= 0 or launches["merge_cells"]
                or launches["merge_prep"]):
            raise AssertionError(f"grad {alg}: launches {launches}")
        log(f"[grad] {alg} {GRAD_RES}x{GRAD_RES} x1 forward+backward: "
            f"{times[0]:.1f} ms cold, {times[1]:.1f} ms captured, {ms:.1f} "
            f"ms replayed, peak {peak:.2f} "
            f"GiB allocated, loss "
            f"{float(loss):.6g}, light-intensity grad "
            f"{float(g.light_intensity.x[0]):.6g}; launches {launches}")
        steps[alg] = dict(ms=ms, peak_gib=peak, launches=launches)

    # (c) the Function's gradient vs the plain sweep's autograd.
    scene0 = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    n = RES * RES
    o, d = random_rays(torch, dev, n, SEED + 1)
    wts = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(
        SEED + 2), device=dev)

    def ray_grads(kernel):
        rays = [a.clone().requires_grad_() for a in (*o, *d)]
        org, dirn = V3(*rays[:3]), V3(*rays[3:])
        dist, _ = S.sweep(scene0, org, dirn) if kernel else \
            S.sweep_plain(scene0, org, dirn)
        out = torch.where(dist < S.BIG_DIST, dist, 0.0)
        return torch.autograd.grad((out * wts).sum(), rays)

    got, want = ray_grads(True), ray_grads(False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    log(f"[grad-sweep] autograd Function vs plain sweep autograd on {n} "
        f"rays: max |grad err| {err:.3g} (rtol 1e-5)")

    # (d) the BSDF kernel's gradient (ops/bsdf.py::_BsdfKernelFn) vs the
    # plain chain's autograd, to the materials and the directions.
    from smallvcm_tpu_torch.ops import bsdf as B

    mat = torch.randint(-1, scene0.materials.ior.shape[0], (n,),
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 3), device=dev)
    u = torch.rand((n, 3), generator=torch.Generator(device=dev).manual_seed(
        SEED + 4), device=dev)

    def bsdf_grads(kernel):
        mats = [t.clone().requires_grad_() for t in
                B._leaves(scene0.materials)]
        rays = [a.clone().requires_grad_() for a in (*o, *d)]
        m, nrm, gen = B._materials_of(mats), V3(*rays[:3]), V3(*rays[3:])
        hit = mat >= 0
        with torch.enable_grad():
            before = B.bsdf_kernel.launches
            if kernel:
                b = B.setup(m, gen, nrm, mat, hit)
                outs = (*B.evaluate(m, b, nrm), *B.sample_with_pdf(
                    m, b, u[:, 0], u[:, 1], u[:, 2], False),
                        *B.setup_evaluate(m, gen, nrm, mat, hit, nrm))
            else:
                b = B.setup_plain(m, gen, nrm, mat, hit)
                s = B.sample_plain(m, b, u[:, 0], u[:, 1], u[:, 2], False)
                outs = (*B.evaluate_plain(m, b, nrm), *s,
                        B.pdf(m, b, s[1])[1],
                        *B.evaluate_plain(m, b, nrm), b.cont_prob)
            flat = [x for x in B._leaves(outs) if x.requires_grad]
            total = sum(torch.nan_to_num(x * wts).sum() for x in flat)
            grads = torch.autograd.grad(total, mats + rays,
                                        allow_unused=True)
        return ([torch.zeros_like(t) if g is None else g
                 for t, g in zip(mats + rays, grads)],
                B.bsdf_kernel.launches - before)

    (got, k_launches), (want, p_launches) = bsdf_grads(True), \
        bsdf_grads(False)
    if k_launches != 4 or p_launches:
        raise AssertionError(f"grad-bsdf: {k_launches} kernel launches, "
                             f"{p_launches} on the plain side")
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a, b, rtol=1e-5, atol=1e-5 * float(b.nan_to_num().abs().max()),
            equal_nan=True)
    err = max(float((a - b).nan_to_num().abs().max()
                    / b.nan_to_num().abs().max().clamp_min(1e-30))
              for a, b in zip(got, want))
    log(f"[grad-bsdf] autograd Function vs plain BSDF autograd on {n} "
        f"lanes (setup, evaluate, sample_with_pdf, setup_evaluate; 4 "
        f"launches): max |grad err| / max |grad| {err:.3g}")
    return steps


REPORT_RES = 64
# Phase 12 when the report ran one CLI subprocess a combination, four at a
# time (NVIDIA H100 80GB HBM3, 700 W): the time to compare with.
SUBPROCESS_REPORT_S = 198.4


def check_report(torch):
    """Phase 12: --report -i 1 --resolution 64 64 in this process on the
    card; scene 0's seven BMPs against fresh CLI processes'; device memory
    reserved after the report against before it and one combination's
    peak."""
    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.render import ALGORITHMS
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    # Each combination's peak reserved memory above the level it started
    # from: the report empties the allocator's cache between combinations.
    peaks = {}
    render_one = cli.render_one

    def measured(args, scene_id, alg, filename, device):
        start = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        out = render_one(args, scene_id, alg, filename, device)
        peaks[filename] = torch.cuda.max_memory_reserved() - start
        return out

    flags = ["-i", "1", "--resolution", str(REPORT_RES), str(REPORT_RES),
             "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        cli.render_one = measured
        t0 = time.perf_counter()
        try:
            with contextlib.chdir(tmp), contextlib.redirect_stdout(buf):
                rc = cli.main(["--report", *flags])
        finally:
            cli.render_one = render_one
        secs = time.perf_counter() - t0
        after = torch.cuda.memory_reserved()
        bmps = sorted(p.name for p in Path(tmp).glob("*.bmp"))
        index = (Path(tmp) / "index.html").read_text()
        if rc != 0 or len(bmps) != 28 or len(peaks) != 28 \
                or not all(b in index for b in bmps):
            raise AssertionError(f"report: rc {rc}, {len(bmps)} BMPs\n"
                                 + buf.getvalue()[-2000:])
        log(f"[report] 28 BMPs + index.html at {REPORT_RES}x{REPORT_RES} x1 "
            f"on the card in this process in {secs:.1f} s (one CLI "
            f"subprocess a combination: {SUBPROCESS_REPORT_S} s)")
        # Scene 0's seven combinations again, each in a fresh CLI process
        # with the report's flags: the same bytes.
        t1 = time.perf_counter()
        names = {alg: cli.build_default_filename(SCENE_CONFIGS[0], alg)
                 for alg in ALGORITHMS}
        fresh = Path(tmp, "fresh")
        fresh.mkdir()
        procs = {alg: subprocess.Popen(
            [sys.executable, "-m", "smallvcm_tpu_torch.cli", "-s", "0",
             "-a", alg, "-o", str(fresh / name), *flags], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for alg, name in names.items()}
        for alg, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"report: fresh cli -a {alg}: rc "
                                     f"{proc.returncode}\n{err[-2000:]}")
        differ = [alg for alg, name in names.items()
                  if Path(tmp, name).read_bytes()
                  != (fresh / name).read_bytes()]
        if differ:
            raise AssertionError(f"report: scene 0 BMP bytes differ from a "
                                 f"fresh CLI process's for {differ}")
    one = max(peaks.values())
    mib = lambda n: f"{n / 2 ** 20:.1f} MiB"
    if after - before > one:
        raise AssertionError(f"report: {mib(after)} reserved after it, "
                             f"{mib(before)} before, more than one "
                             f"combination's peak {mib(one)} apart")
    log(f"[report] scene 0's 7 BMPs byte for byte those of fresh CLI "
        f"processes (7 at once, {time.perf_counter() - t1:.1f} s); device "
        f"memory reserved {mib(before)} before the report, {mib(after)} "
        f"after it; one combination's peak at most {mib(one)} (the largest "
        f"{max(peaks, key=peaks.get)})")


def _timed_ms(torch, fn, reps: int = 5) -> float:
    """Mean wall ms of ``fn`` with the card synchronised around each call
    (an exchange's time, host staging included)."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return 1e3 * total / reps


def _sharded_rank(device: str, res: int, grad_res: int) -> dict:
    """Phase 13 in each rank: the sharded renders and gradient steps, with
    this rank's launch counts, and the exchanges timed at the renders'
    shapes."""
    import torch

    from smallvcm_tpu_torch import diff
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.parallel import comm, multihost
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    group = multihost.global_group()
    dev = multihost.rank_device(device)
    out = dict(backend=torch.distributed.get_backend(group), device=str(dev))
    scene = load_cornell_box((res, res), SCENE_CONFIGS[0], device=dev)
    # A fresh process loads PyTorch's CUDA modules at first use: one
    # untimed iteration first.
    R.render(scene, R.RenderConfig(algorithm="vcm", resolution=(res, res),
                                   group=group))
    for name, alg, exchange in SHARD_CASES:
        cfg = R.RenderConfig(algorithm=alg, iterations=2,
                             resolution=(res, res), vm_exchange=exchange,
                             group=group)
        reset_counts(M, S)
        comm.all_gather_columns.bytes = comm.ring_shift.bytes = 0
        img, secs, done, rays = R.render(scene, cfg)
        out[name] = dict(
            img=img.cpu(), ms=1e3 * secs / done, rays=rays,
            launches=read_counts(M, S),
            exchange_bytes=(comm.all_gather_columns.bytes
                            + comm.ring_shift.bytes) // done)
    # The exchanges of one iteration, timed alone at the renders' shapes:
    # the packed light-vertex table [17, maxL = 9, paths of one rank] and
    # the frame.
    table = torch.rand((17, 9, res * res // comm.world_size(group)),
                       device=dev)
    frame = torch.rand((res, res, 3), device=dev)
    out["exchange_ms"] = dict(
        allgather=_timed_ms(torch, lambda: comm.all_gather_columns(table,
                                                                   group)),
        ring=_timed_ms(torch, lambda: comm.ring_shift(table, group)),
        framebuffer=_timed_ms(torch, lambda: comm.framebuffer_sum(frame,
                                                                  group)))
    gscene = load_cornell_box((grad_res, grad_res), SCENE_CONFIGS[0],
                              device=dev)
    target = torch.full((grad_res, grad_res, 3), 0.1, device=dev)
    for alg in ("vcm", "pt"):
        reset_counts(M, S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = diff.sharded_loss_and_grad(
            group, gscene, diff.extract_params(gscene), target, 0, alg,
            grad_res, grad_res)
        torch.cuda.synchronize()
        out[f"grad_{alg}"] = dict(
            ms=1e3 * (time.perf_counter() - t0), loss=float(loss),
            leaves=[x.cpu() for x in diff._leaves(g)],
            launches=read_counts(M, S))
    return out


def _isolated_fault(torch, tmp: str) -> str:
    """``--isolate on`` with one fault injected at iteration 2 of a 64x64
    VCM run on the card against the same run uninterrupted."""
    import os

    from smallvcm_tpu_torch import cli

    args = ["-s", "0", "-a", "vcm", "-i", "4", "--resolution", "64", "64",
            "--device", "cuda", "--devices", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(args + ["-o", f"{tmp}/ref.bmp"]) != 0:
            raise AssertionError("isolate: the uninterrupted run failed")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               SMALLVCM_TEST_FAULT_AT="2", SMALLVCM_TEST_FAULT_TIMES="1",
               SMALLVCM_TEST_FAULT_COUNTER=f"{tmp}/faults")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "smallvcm_tpu_torch.cli", *args,
         "--isolate", "on", "--checkpoint", f"{tmp}/ckpt.npz",
         "--checkpoint-every", "1", "-o", f"{tmp}/out.bmp"],
        env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or "respawning from checkpoint" not in \
            proc.stdout or Path(f"{tmp}/faults").read_text() != "1":
        raise AssertionError(f"isolate: rc {proc.returncode}\n"
                             + proc.stdout[-2000:] + proc.stderr[-2000:])
    if Path(f"{tmp}/out.bmp").read_bytes() != \
            Path(f"{tmp}/ref.bmp").read_bytes():
        raise AssertionError("isolate: the respawned run's BMP differs")
    return (f"--isolate on, one fault injected at iteration 2 of 4 (64x64 "
            f"vcm on the card): respawned from the checkpoint, BMP bytes "
            f"equal to the uninterrupted run's, {secs:.1f} s")


def _single_references(torch, dev) -> dict:
    """The single-process renders (2 iterations) and gradient steps that
    phase 13's sharded runs are held against."""
    from smallvcm_tpu_torch import diff
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0], device=dev)
    ref = {}
    for alg in ("vcm", "pt"):
        cfg = R.RenderConfig(algorithm=alg, iterations=2,
                             resolution=(RES, RES))
        img, secs, done, _ = R.render(scene, cfg)
        ref[alg] = (img.cpu(), 1e3 * secs / done)
    gscene = load_cornell_box((SHARD_GRAD_RES, SHARD_GRAD_RES),
                              SCENE_CONFIGS[0], device=dev)
    target = torch.full((SHARD_GRAD_RES, SHARD_GRAD_RES, 3), 0.1,
                        device=dev)
    for alg in ("vcm", "pt"):
        loss, g = diff.loss_and_grad(gscene, diff.extract_params(gscene),
                                     target, 0, alg, SHARD_GRAD_RES,
                                     SHARD_GRAD_RES)
        ref[f"grad_{alg}"] = (float(loss), [x.cpu() for x in diff._leaves(g)])
    return ref


def _check_ranks(torch, ranks, ref, spawn_s: float) -> dict:
    """Hold every rank's phase-13 results against the single-process ones
    (pt bit for bit, VCM rtol 1e-4 / atol 1e-6, gradients rtol 2e-3 /
    atol 1e-5; every kernel of the path launched on every rank) ->
    launches by path, a list by rank."""
    w, backend = len(ranks), ranks[0]["backend"]
    where = sorted({o["device"] for o in ranks})
    launches = {}
    for name, alg, exchange in SHARD_CASES:
        want = ref[alg][0]
        for r, out in enumerate(ranks):
            got = out[name]
            if not torch.equal(got["img"], ranks[0][name]["img"]):
                raise AssertionError(f"sharded {name}: ranks disagree")
            if alg == "pt" and not torch.equal(got["img"], want):
                raise AssertionError("sharded pt: not bit for bit")
            torch.testing.assert_close(got["img"], want, rtol=1e-4,
                                       atol=1e-6)
            n = got["launches"]
            if n["intersect_sweep"] <= 0 or n["occluded_sweep"] <= 0 or \
                    (n["merge_cells"] > 0) != (alg == "vcm") or \
                    (n["merge_prep"] > 0) != (alg == "vcm"):
                raise AssertionError(f"sharded {name} rank {r}: launches {n}")
        err = float((ranks[0][name]["img"] - want).abs().max())
        launches[f"sharded_{name}"] = [o[name]["launches"] for o in ranks]
        log(f"[sharded] {name} {RES}x{RES} x2 on {w} ranks ({backend}, "
            f"{where}): {[round(o[name]['ms'], 1) for o in ranks]} "
            f"ms/iteration (single process {ref[alg][1]:.1f}); max |err| "
            f"vs single {err:.3g}{' (bit for bit)' if err == 0 else ''}; "
            f"exchange {ranks[0][name]['exchange_bytes']} B/iteration a "
            f"rank; launches by rank {launches[f'sharded_{name}']}")
    log(f"[sharded] {backend}: exchange wall ms a call on rank 0"
        f"{' (staged through host memory)' if backend == 'gloo' else ''}: "
        f"{ranks[0]['exchange_ms']}; the spawn and the ranks' work took "
        f"{spawn_s:.1f} s")
    for alg in ("vcm", "pt"):
        loss, leaves = ref[f"grad_{alg}"]
        for r, out in enumerate(ranks):
            got = out[f"grad_{alg}"]
            for a, b in zip(got["leaves"], leaves, strict=True):
                torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-5)
            n = got["launches"]
            if n["intersect_sweep"] <= 0 or n["occluded_sweep"] <= 0 or \
                    n["merge_cells"] or n["merge_prep"]:
                raise AssertionError(f"sharded grad {alg} rank {r}: "
                                     f"launches {n}")
        launches[f"sharded_grad_{alg}"] = [o[f"grad_{alg}"]["launches"]
                                           for o in ranks]
        log(f"[sharded-grad] {alg} {SHARD_GRAD_RES}x{SHARD_GRAD_RES} x1 on "
            f"{w} ranks ({backend}): every leaf within rtol 2e-3 / atol "
            f"1e-5 of loss_and_grad; loss "
            f"{ranks[0][f'grad_{alg}']['loss']:.6g} vs {loss:.6g}; "
            f"{[round(o[f'grad_{alg}']['ms'], 1) for o in ranks]} ms a "
            f"step (first call); launches by rank "
            f"{launches[f'sharded_grad_{alg}']}")
    return launches


def check_nccl(torch, ref) -> dict:
    """Phase 13 with one card a rank (NCCL), where two or more are
    visible: ``--devices 2`` through the CLI against ``--devices 1``, then
    the sharded renders and gradient steps on every visible card."""
    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.parallel import multihost

    w = torch.cuda.device_count()
    args = ["-s", "0", "-a", "vcm", "-i", "2", "--resolution", str(RES),
            str(RES), "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            for k in (1, 2):
                if cli.main(args + ["--devices", str(k), "-o",
                                    f"{tmp}/d{k}.bmp"]) != 0:
                    raise AssertionError(f"--devices {k} failed")
        a, b = (Path(f"{tmp}/d{k}.bmp").read_bytes() for k in (1, 2))
    if a != b:
        off = sum(x != y for x, y in zip(a, b))
        raise AssertionError(f"--devices 2 (NCCL): BMP bytes differ from "
                             f"--devices 1 ({off} of {len(a)} bytes)")
    log(f"[nccl] cli --devices 2 (one card a rank) vs --devices 1, vcm "
        f"{RES}x{RES} x2: BMP bytes equal ({len(a)} bytes)")
    t0 = time.perf_counter()
    ranks = multihost.spawn(w, "cuda", _sharded_rank, "cuda", RES,
                            SHARD_GRAD_RES)
    return _check_ranks(torch, ranks, ref, time.perf_counter() - t0)


def check_sharded(torch, dev, rank_device: str = "cuda:0"):
    """Phase 13: sharded renders and gradients on two gloo ranks sharing
    ``rank_device``, NCCL where two cards are visible, the native codec
    and the supervisor."""
    from smallvcm_tpu_torch.io import framebuffer as fbio
    from smallvcm_tpu_torch.io import native_codec
    from smallvcm_tpu_torch.parallel import multihost

    ref = _single_references(torch, dev)
    t0 = time.perf_counter()
    ranks = multihost.spawn(SHARD_RANKS, rank_device, _sharded_rank,
                            rank_device, RES, SHARD_GRAD_RES)
    launches = _check_ranks(torch, ranks, ref, time.perf_counter() - t0)
    if torch.cuda.device_count() >= 2:
        nccl = check_nccl(torch, ref)
        launches.update({f"nccl_{k}": v for k, v in nccl.items()})
    else:
        log(f"[nccl] not run: {torch.cuda.device_count()} card visible; "
            f"--devices 2 with NCCL needs two")

    with tempfile.TemporaryDirectory() as tmp:
        img = ref["vcm"][0].numpy()
        for fmt, kw in (("bmp", (2.2,)), ("hdr", ()), ("pfm", ()),
                        ("ppm", (2.2,))):
            if not getattr(native_codec, f"save_{fmt}")(
                    img, f"{tmp}/n.{fmt}", *kw):
                raise AssertionError(f"native codec: {fmt} not written")
            os.environ["SMALLVCM_TPU_NO_NATIVE"] = "1"
            try:
                getattr(fbio, f"save_{fmt}")(img, f"{tmp}/p.{fmt}", *kw)
            finally:
                del os.environ["SMALLVCM_TPU_NO_NATIVE"]
            if Path(f"{tmp}/n.{fmt}").read_bytes() != \
                    Path(f"{tmp}/p.{fmt}").read_bytes():
                raise AssertionError(f"native codec: {fmt} bytes differ")
        log(f"[codec] native bmp/hdr/pfm/ppm bytes equal the numpy "
            f"writers' for the vcm {RES}x{RES} image")
        log("[isolate] " + _isolated_fault(torch, tmp))
    return launches


def _matrix_pair(torch, dev, data, scene_id: int, alg: str, backend: str):
    """One pair of the matrix golden rendered on ``dev`` -> (passed, summary
    line, launches, seconds)."""
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box
    from tests.test_torch_matrix import (golden_pair, matrix_verdict,
                                         render_config)

    want, c = golden_pair(data, scene_id, alg)
    scene = load_cornell_box(tuple(c["resolution"]), SCENE_CONFIGS[scene_id],
                             device=dev)
    if R.resolve_algorithm(scene, alg) != c["resolved"]:
        raise AssertionError(f"matrix s{scene_id} {alg}: resolved "
                             f"differently from the golden")
    reset_counts(M, S)
    t0 = time.perf_counter()
    img, _, _, _ = R.render(scene, render_config(c, merge_backend=backend))
    img = img.cpu()
    secs = time.perf_counter() - t0
    ok, summary = matrix_verdict(img.numpy(), want, scene_id, alg)
    return ok, summary, read_counts(M, S), secs


def check_matrix(torch, dev) -> dict:
    """Phase 14: all 4 scenes x 7 algorithms at 32x32 x2 on the card with
    the kernels, held against the JAX matrix golden under
    tests/test_torch_matrix.py's criterion; the nine merging pairs of
    scenes 1-3 again through the pair merge; the JAX images through
    save_hdr -> load_hdr -> launches summed over the phase's renders."""
    import numpy as np

    from smallvcm_tpu_torch.io.framebuffer import load_hdr, save_hdr
    from tests.test_torch_matrix import MATRIX_GOLDEN, PAIRS

    data = np.load(MATRIX_GOLDEN)
    merging = ("ppm", "bpm", "vcm")
    runs = [(s, a, "auto") for s, a in PAIRS] + \
        [(s, a, "xla") for s, a in PAIRS if s > 0 and a in merging]
    totals = {"matrix": {}, "matrix_xla": {}}
    failed = []
    for scene_id, alg, backend in runs:
        ok, summary, n, secs = _matrix_pair(torch, dev, data, scene_id, alg,
                                            backend)
        cells = backend == "auto" and alg in merging
        occl = alg in ("pt", "lt", "bpt", "vcm")
        if n["intersect_sweep"] <= 0 or (n["merge_cells"] > 0) != cells \
                or (n["occluded_sweep"] > 0) != occl:
            raise AssertionError(f"matrix s{scene_id} {alg} {backend}: "
                                 f"launches {n}")
        path = totals["matrix" if backend == "auto" else "matrix_xla"]
        for k, v in n.items():
            path[k] = path.get(k, 0) + v
        log(f"[matrix] s{scene_id} {alg:3s} {backend:4s}: {summary}; "
            f"launches {n}; {secs:.2f} s {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(f"s{scene_id} {alg} {backend}")
    if failed:
        raise AssertionError(f"matrix: pairs disagree with the JAX golden: "
                             f"{failed}")
    with tempfile.TemporaryDirectory() as tmp:
        for key in (k for k in data.files if not k.endswith("_config")):
            img = data[key]
            save_hdr(img, f"{tmp}/g.hdr")
            back = load_hdr(f"{tmp}/g.hdr")
            _, e = np.frexp(img.max(axis=2))
            half = np.ldexp(0.5, e - 8)[..., None]
            stored = img.max(axis=2, keepdims=True) >= 1e-32
            if back.dtype != np.float32 or not np.all(np.where(
                    stored, np.abs(back - img) <= half, back == 0.0)):
                raise AssertionError(f"load_hdr(save_hdr({key})) is not "
                                     "within half an RGBE quantum")
    log(f"[matrix] {len(PAIRS)} pairs with the kernels and "
        f"{len(runs) - len(PAIRS)} through the pair merge agree with the JAX "
        f"golden; launches {totals}; load_hdr(save_hdr(golden)) within half "
        f"an RGBE quantum for all {len(PAIRS)} golden images")
    return totals


BENCH_FIELDS = ("value", "vs_baseline", "ms_per_iter", "ms_per_iter_min",
                "ms_per_iter_max", "repeats", "iters", "first_iter_s",
                "second_iter_s", "capture_s", "rays_per_iter",
                "candidate_pairs_pair_merge", "candidate_pairs_cell_merge",
                "launches_per_iter", "host_launch_calls_per_iter",
                "device_ms_per_iter", "busy_share", "peak_allocated_gib",
                "peak_reserved_gib", "image_mean", "block",
                "host_syncs_per_block", "block_host_launch_calls_per_iter")
# Host launch calls an iteration of a VCM block of 8, at most: 760 an
# iteration with the stage graphs alone (PERF.md §5); each replay of the
# iteration graph adds its scalar fills and the block's sums.
BLOCK_HOST_CALLS_MAX = 50


def check_bench(rays_iter1: int, launches_per_iteration: int):
    """Phase 15: bench_torch.py's default mode in a subprocess -> (its
    wrapper launch counts (the timed repeats), its pair-merge candidate
    count of iteration 1, which phase 18 holds against its own)."""
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    log("\n".join("  | " + line for line in proc.stderr.splitlines()))
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}")
    lines = proc.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench_torch.py printed {len(lines)} stdout "
                             "lines, not one")
    rec = json.loads(lines[0])
    if rec.get("metric") != f"rays/sec/chip (VCM, scene 0, {RES}x{RES})" \
            or rec.get("unit") != "rays/s" \
            or rec.get("impl") != "smallvcm_tpu_torch" \
            or not rec.get("device"):
        raise AssertionError(f"bench: metric, unit, impl or device: {rec}")
    for key in BENCH_FIELDS:
        v = rec.get(key)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            raise AssertionError(f"bench: {key} = {v!r}")
    if rec["rays_per_iter"] != rays_iter1:
        raise AssertionError(f"bench: {rec['rays_per_iter']} rays at "
                             f"iteration 1, phase 6 counted {rays_iter1}")
    if abs(rec["launches_per_iter"] / launches_per_iteration - 1) > 0.01:
        raise AssertionError(f"bench: {rec['launches_per_iter']} launches, "
                             f"phase 3 profiled {launches_per_iteration}")
    if not 0 < rec["busy_share"] <= 1:
        raise AssertionError(f"bench: busy share {rec['busy_share']}")
    if rec["block"] != rec["iters"] or rec["host_syncs_per_block"] != 1 \
            or rec["block_host_launch_calls_per_iter"] \
            > BLOCK_HOST_CALLS_MAX:
        raise AssertionError(
            f"bench: block {rec['block']} of {rec['iters']} iterations, "
            f"{rec['host_syncs_per_block']} host syncs, "
            f"{rec['block_host_launch_calls_per_iter']} host launch calls "
            f"an iteration (at most {BLOCK_HOST_CALLS_MAX})")
    counts = rec["kernel_launches"]
    if set(counts) != {"merge_cells", "intersect_sweep", "occluded_sweep",
                       "uniform_slots"} \
            or min(counts.values()) <= 0:
        raise AssertionError(f"bench: kernel launches {counts}")
    if rec["stages"]["unattributed"]["launches"]:
        raise AssertionError(f"bench: unattributed kernels {rec['stages']}")
    caps = rec["merge_caps"]
    if rec["pair_merge_overflow"] or set(caps) != {
            "pair_factor", "photon_factor", "query_factor", "merge_chunks"}:
        raise AssertionError(f"bench: pair merge overflow "
                             f"{rec['pair_merge_overflow']}, caps {caps}")
    log(f"[bench] {lines[0]}")
    log("[bench] vcm stage split (device ms / launches / host launch "
        "calls): " + ", ".join(
            f"{label} {st['device_ms']:.3f} / {st['launches']} / "
            f"{st['host_launch_calls']}"
            for label, st in rec["stages"].items()))
    return counts, rec["candidate_pairs_pair_merge"]


# Phase 16: (algorithm, iterations 0..n-1) rendered with graphs and eagerly.
GRAPH_CASES = (("vcm", 4), ("pt", 4), ("el", 3), ("lt", 3), ("ppm", 3),
               ("bpm", 3), ("bpt", 3))
# Host launch calls of one block of one iteration, at most (36,493 and
# 17,711 eager kernels an iteration before the graphs, 760 and 8 with the
# stage graphs alone, PERF.md §5): the iteration's graph, its scalar
# fills and the block's sums and read.
GRAPH_HOST_CALLS_MAX = dict(vcm=100, pt=100)


def launch_profile(torch, fn):
    """torch.profiler over ``fn()`` -> (the host's CUDA launch calls, a
    kernel each or a whole graph; the device events by name)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bench_torch import LAUNCH_CALLS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    return (sum(e.name.startswith(LAUNCH_CALLS) for e in events),
            Counter(e.name for e in events
                    if e.device_type == DeviceType.CUDA))


def _graph_run(torch, dev, alg: str, n_iter: int) -> dict:
    """Iterations 0..n_iter-1 of ``alg`` on a fresh scene-0 scene, one
    block of one through render.py's block runner each (the merge caps
    sized before) -> the images, rays, the kernels' launches, ms per
    iteration, the captures' host seconds, and the host launch calls and
    device events of one more block of the last iteration."""
    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0], device=dev)
    cfg = R.RenderConfig(algorithm=alg, resolution=(RES, RES))
    run = R._make_block_runner(scene, cfg, R.resolve_algorithm(scene, alg))
    zeros = lambda: torch.zeros((RES, RES, 3), device=dev)
    reset_counts(M, S)
    captures, capture_s = graphs.stage.captures, graphs.stage.capture_s
    imgs, rays, ms = [], [], []
    for it in range(n_iter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = run(it, 1, zeros())
        imgs.append(block.accum)
        rays.append(block.rays)
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_counts(M, S)
    acc = zeros()
    calls, device = launch_profile(torch, lambda: run(n_iter - 1, 1, acc))
    return dict(imgs=imgs, rays=rays, launches=launches, ms=ms,
                captures=graphs.stage.captures - captures,
                capture_s=graphs.stage.capture_s - capture_s,
                host_calls=calls, device_events=device)


def check_graphs(torch, dev) -> dict:
    """Phase 16: every algorithm's iteration (VCM family) or pass (el, pt)
    as a CUDA graph against ``graphs.eager()`` -> the kernels' launches by
    path."""
    import statistics

    from smallvcm_tpu_torch import graphs

    out = {}
    for alg, n_iter in GRAPH_CASES:
        g = _graph_run(torch, dev, alg, n_iter)
        with graphs.eager():
            e = _graph_run(torch, dev, alg, n_iter)
        for it, (a, b) in enumerate(zip(g["imgs"], e["imgs"])):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"graphs {alg} iteration {it}: image differs from "
                    f"eager at {int((a != b).any(-1).sum())} pixels")
        if g["rays"] != e["rays"] or g["launches"] != e["launches"]:
            raise AssertionError(f"graphs {alg}: rays {g['rays']} vs "
                                 f"{e['rays']}, launches {g['launches']} "
                                 f"vs {e['launches']}")
        if g["captures"] < 1 or e["captures"]:
            raise AssertionError(f"graphs {alg}: {g['captures']} captures "
                                 f"with graphs, {e['captures']} eager")
        limit = GRAPH_HOST_CALLS_MAX.get(alg)
        if limit is not None and g["host_calls"] > limit:
            raise AssertionError(f"graphs {alg}: {g['host_calls']} host "
                                 f"launch calls an iteration (at most "
                                 f"{limit})")
        if g["host_calls"] >= e["host_calls"]:
            raise AssertionError(f"graphs {alg}: {g['host_calls']} host "
                                 f"launch calls, eager {e['host_calls']}")
        ms_g = statistics.median(g["ms"][2:])
        ms_e = statistics.median(e["ms"][1:])
        dg, de = g["device_events"], e["device_events"]
        moved = {name[:40]: dg[name] - de[name] for name in sorted(
            set(dg) | set(de), key=lambda k: -abs(dg[k] - de[k]))
            if dg[name] != de[name]}
        log(f"[graphs] {alg} {RES}x{RES} iterations 0-{n_iter - 1}: images "
            f"bit for bit, rays {g['rays']} and launches {g['launches']} "
            f"equal both ways; ms/iteration graphs {ms_g:.2f} (replays; "
            f"{[round(x, 1) for x in g['ms']]}) vs eager {ms_e:.2f} "
            f"({[round(x, 1) for x in e['ms']]}); host launch calls an "
            f"iteration {g['host_calls']} vs {e['host_calls']}; device "
            f"events {sum(dg.values())} vs {sum(de.values())} (graphs minus "
            f"eager by name: {dict(list(moved.items())[:6])}); "
            f"{g['captures']} captures in {g['capture_s']:.2f} s")
        out[alg] = dict(ms_graphs=ms_g, ms_eager=ms_e,
                        host_calls_graphs=g["host_calls"],
                        host_calls_eager=e["host_calls"],
                        capture_s=g["capture_s"], launches=g["launches"])
    return out


# Phase 17: merging algorithms' other blocks, and el/pt's auto block.
BLOCK_ITERS = 8
SIMPLE_BLOCK = 64
# A subprocess that renders one VCM iteration with the cached caps.
_CAPS_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box
scene = load_cornell_box(({res}, {res}), SCENE_CONFIGS[0], device="cuda")
cfg = R.RenderConfig(algorithm="vcm", iterations=1, resolution=({res}, {res}))
how = R._ensure_merge_caps(scene, cfg, "vcm")
R.render(scene, cfg)
print(json.dumps(dict(how=how, measured=vcm.merge_measure_iteration.calls,
                      photon_factor=cfg.photon_factor,
                      query_factor=cfg.query_factor)))
"""


class _Run(NamedTuple):
    """A phase-17 render: image, seconds, rays, its config after the run
    (grown caps), the kernels' launches, graph captures and stdout."""
    img: object
    secs: float
    rays: int
    cfg: object
    launches: dict
    captures: int
    out: str


def _blocks_render(torch, scene, alg: str, iters: int, **kw) -> _Run:
    """render() of ``alg`` at RES x RES, ``iters`` iterations."""
    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    cfg = R.RenderConfig(algorithm=alg, iterations=iters,
                         resolution=(RES, RES), **kw)
    reset_counts(M, S)
    captures = graphs.stage.captures
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        img, secs, done, rays = R.render(scene, cfg)
    torch.cuda.synchronize()
    if done != iters or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"blocks {alg}: {done} iterations, finite "
                             f"{bool(torch.isfinite(img).all())}")
    return _Run(img, secs, rays, cfg, read_counts(M, S),
                graphs.stage.captures - captures, buf.getvalue())


def check_blocks(torch, dev) -> dict:
    """Phase 17: the block runner on the card -> the kernels' launches by
    path."""
    from bench_torch import block_host_counts
    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.algorithms import vcm
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    t_phase = time.perf_counter()

    def blog(msg):
        log(f"[blocks +{time.perf_counter() - t_phase:.1f} s] {msg}")

    n = RES * RES
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0], device=dev)
    launches = {}

    # (a) The main path with blocks: VCM -i 8 at the auto block, cold (the
    # iteration graph captured at iteration 1) and again (replays).
    torch.cuda.reset_peak_memory_stats(dev)
    cold = _blocks_render(torch, scene, "vcm", BLOCK_ITERS)
    warm = _blocks_render(torch, scene, "vcm", BLOCK_ITERS)
    img, secs, rays, cfg, counts = warm[:5]
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            torch.cuda.max_memory_reserved(dev) / 2 ** 30)
    block = R.auto_block_size(cfg, "vcm")
    host = block_host_counts(scene, cfg, BLOCK_ITERS, block)
    if block != BLOCK_ITERS or cold.captures != 1 or warm.captures:
        raise AssertionError(f"blocks: auto block {block}, captures "
                             f"{cold.captures} cold and {warm.captures} warm")
    if counts["merge_cells"] != BLOCK_ITERS or host["host_syncs"] != 1:
        raise AssertionError(f"blocks: {counts['merge_cells']} merge "
                             f"launches for {BLOCK_ITERS} iterations, "
                             f"{host['host_syncs']} host syncs a block "
                             f"(at {host['sync_sites']})")
    calls_iter = host["host_launch_calls"] / block
    busy = host["busy_share"]
    if calls_iter > BLOCK_HOST_CALLS_MAX or not 0 < busy <= 1:
        raise AssertionError(f"blocks: {calls_iter} host launch calls an "
                             f"iteration (at most {BLOCK_HOST_CALLS_MAX}), "
                             f"busy share {busy}")
    caps = vcm.merge_caps(cfg.photon_factor, cfg.query_factor, n)
    launches["blocks_vcm"] = counts
    blog(f"vcm {RES}x{RES} -i {BLOCK_ITERS} at the auto block "
        f"({block}): {1e3 * secs / BLOCK_ITERS:.2f} ms/iteration warm "
        f"(cold {1e3 * cold.secs / BLOCK_ITERS:.2f}, {cold.captures} capture); "
        f"{host['host_syncs']} host sync a block (at {host['sync_sites']}); "
        f"{calls_iter:.2f} host launch calls an iteration "
        f"({host['host_launch_calls']} a block); busy share {busy:.4f} "
        f"(device time in the replays over their span); launches "
        f"{counts}; peak "
        f"{peak[0]:.3f} GiB allocated, {peak[1]:.3f} reserved; caps "
        f"photon_factor {cfg.photon_factor} ({caps[0]} rows), query_factor "
        f"{cfg.query_factor} ({caps[1]} rows); image mean "
        f"{float(img.mean()):.6f}")

    # (b) Blocks against single iterations and against eager: every block
    # adds its iterations to the running image one by one, so the bits
    # are the same whatever the partition (bound: 0).
    singles = _blocks_render(torch, scene, "vcm", BLOCK_ITERS, block_size=1)
    with graphs.eager():
        eager = _blocks_render(torch, scene, "vcm", BLOCK_ITERS)
    for name, other in (("--block 1", singles), ("graphs.eager()", eager)):
        diff = float((other.img - img).abs().max())
        rel = abs(float(other.img.mean()) / float(img.mean()) - 1.0)
        if rel > 1e-6 or not torch.equal(other.img, img) \
                or other.rays != rays or other.launches != counts:
            raise AssertionError(f"blocks: {name} differs (max |diff| "
                                 f"{diff}, mean rel {rel}, rays {other.rays} "
                                 f"vs {rays}, launches {other.launches})")
    blog(f"block of {BLOCK_ITERS} vs --block 1 "
        f"({1e3 * singles.secs / BLOCK_ITERS:.2f} ms/iteration) and vs "
        f"graphs.eager() ({1e3 * eager.secs / BLOCK_ITERS:.2f} ms/iteration):"
        f" images bit for bit (max |diff| 0, bound 0: the same association)"
        f", rays and launches equal")

    # The merge kernel inside the iteration graph against its plain
    # version: iteration 3 replayed, and eagerly with the plain merge.
    real = M.merge_cells
    replayed = vcm.render_block_with_stats(
        scene, 3, RES, RES, 1, photon_factor=cfg.photon_factor,
        query_factor=cfg.query_factor)[0].clone()
    try:
        M.merge_cells = M.merge_cells_plain
        with graphs.eager():
            plain = vcm.render_block_with_stats(
                scene, 3, RES, RES, 1, photon_factor=cfg.photon_factor,
                query_factor=cfg.query_factor)[0]
    finally:
        M.merge_cells = real
    torch.testing.assert_close(replayed, plain, rtol=1e-4, atol=1e-6)
    merge_err = float((replayed - plain).abs().max())
    blog(f"iteration 3 replayed from the iteration graph vs eager "
        f"with merge_cells_plain: max |err| {merge_err:.3g} (rtol 1e-4, "
        f"atol 1e-6)")

    # (c) Forced overflow: tiny frozen caps grow and the block renders
    # again, to the bytes of the measured caps.
    forced = _blocks_render(torch, scene, "vcm", BLOCK_ITERS,
                            photon_factor=0.05, query_factor=0.05,
                            merge_caps_frozen=True)
    if "merge cap overflow" not in forced.out \
            or not torch.equal(forced.img, img) \
            or forced.cfg.photon_factor <= 0.05 \
            or forced.cfg.query_factor <= 0.05:
        raise AssertionError(f"blocks: forced overflow: {forced.out!r}, "
                             f"image equal {torch.equal(forced.img, img)}")
    launches["blocks_overflow"] = forced.launches
    blog(f"forced overflow (caps 0.05): {forced.out.strip()}; grown "
        f"to photon_factor {forced.cfg.photon_factor}, query_factor "
        f"{forced.cfg.query_factor}; image bit for bit the measured caps'; "
        f"{1e3 * forced.secs / BLOCK_ITERS:.2f} ms/iteration with the "
        f"re-render; launches {forced.launches}")

    # (d) The caps cache: another process reads it and measures nothing.
    probe = subprocess.run(
        [sys.executable, "-c", _CAPS_PROBE.format(root=str(ROOT), res=RES)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"caps probe: {probe.stderr[-2000:]}")
    got = json.loads(probe.stdout.splitlines()[-1])
    if got["how"] != "cached" or got["measured"] != 0 \
            or got["photon_factor"] != forced.cfg.photon_factor \
            or got["query_factor"] != forced.cfg.query_factor:
        raise AssertionError(f"caps probe: {got}")
    blog(f"caps cache {R._caps_cache_file()}: a second process "
        f"read {got} and measured nothing")

    # (e) ppm and bpm in blocks; el and pt in one block of 64.
    for alg in ("ppm", "bpm"):
        r = _blocks_render(torch, scene, alg, BLOCK_ITERS)
        mean = float(r.img.mean())
        if r.launches["merge_cells"] != BLOCK_ITERS \
                or abs(mean / PARITY_MEAN[alg] - 1) > 0.05:
            raise AssertionError(f"blocks {alg}: launches {r.launches}, "
                                 f"mean {mean}")
        launches[f"blocks_{alg}"] = r.launches
        blog(f"{alg} -i {BLOCK_ITERS}: one block, "
            f"{1e3 * r.secs / BLOCK_ITERS:.2f} ms/iteration, mean {mean:.6f}, "
            f"launches {r.launches}")
    for alg in ("el", "pt"):
        cfg = R.RenderConfig(algorithm=alg, resolution=(RES, RES))
        block = R.auto_block_size(cfg, alg)
        r = _blocks_render(torch, scene, alg, SIMPLE_BLOCK)
        host = block_host_counts(scene, cfg, SIMPLE_BLOCK, block)
        mean = float(r.img.mean())
        tol = 0.005 if alg == "el" else 0.03
        if block != SIMPLE_BLOCK or host["host_syncs"] != 1 \
                or abs(mean / PARITY_MEAN[alg] - 1) > tol:
            raise AssertionError(f"blocks {alg}: block {block}, "
                                 f"{host['host_syncs']} host syncs (at "
                                 f"{host['sync_sites']}), mean {mean}")
        launches[f"blocks_{alg}"] = r.launches
        blog(f"{alg} -i {SIMPLE_BLOCK}: one block of {block}, "
            f"{host['host_syncs']} host sync, "
            f"{host['host_launch_calls'] / block:.2f} host launch calls an "
            f"iteration, busy share {host['busy_share']:.4f}; "
            f"{1e3 * r.secs / SIMPLE_BLOCK:.3f} ms/iteration; mean "
            f"{mean:.6f}")

    # (f) 2048x2048 on one card through the block runner.
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_scaling.py"),
         "--res", "2048", "--ranks", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    log("\n".join("  | " + line for line in proc.stdout.splitlines()[:-1]))
    if proc.returncode != 0:
        raise AssertionError(f"torch_scaling 2048: {proc.stderr[-2000:]}")
    run = json.loads(proc.stdout.splitlines()[-1])["runs"][0]
    if "out_of_memory" in run or not math.isfinite(run["mean"]):
        raise AssertionError(f"torch_scaling 2048: {run}")
    blog(f"2048x2048 on one card through the block runner: peak "
        f"{run['peak_GiB'][0]} GiB allocated, {run['peak_reserved_GiB'][0]} "
        f"reserved; its two iterations (one eager, one capturing) "
        f"{run['rank_ms_min'][0]:.1f}-{run['rank_ms_max'][0]:.1f} ms; mean "
        f"{run['mean']:.6f}")
    return launches


# Phase 18: the pair merge at static caps.
PAIR_RES_CHUNKED = 1024      # the chunk rule gives merge_chunks > 1 here
PAIR_TINY = 0.05             # a pair factor every block overflows


def _pair_rank(device: str, res: int) -> dict:
    """Phase 18 in each rank: VCM through the pair merge from tiny pair
    caps, two iterations, one block -> the image, the block's stats, the
    caps grown to, the overflow lines and the kernels' launches."""
    import torch

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.parallel import multihost
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    dev = multihost.rank_device(device)
    scene = load_cornell_box((res, res), SCENE_CONFIGS[0], device=dev)
    cfg = R.RenderConfig(algorithm="vcm", iterations=2, resolution=(res, res),
                         merge_backend="xla", pair_factor=PAIR_TINY,
                         block_size=2, group=multihost.global_group())
    run = R._make_block_runner(scene, cfg, "vcm")
    reset_counts(M, S)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        block = run(0, 2, torch.zeros((res, res, 3), device=dev))
    return dict(img=block.accum.cpu(), stats=block.stats,
                caps=R._caps_of(cfg), out=buf.getvalue(),
                launches=read_counts(M, S))


def check_pair_caps(torch, dev, bench_pairs: int, grad_steps: dict) -> dict:
    """Phase 18: VCM through the pair merge at static caps, one CUDA graph
    an iteration -> the kernels' launches by path. ``bench_pairs``: phase
    15's pair count of iteration 1; ``grad_steps``: phase 11's steps."""
    import numpy as np

    import bench_torch
    from bench_torch import block_host_counts
    from smallvcm_tpu_torch import cli, diff, graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.algorithms import vcm
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.parallel import multihost
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    t_phase = time.perf_counter()

    def plog(msg):
        log(f"[pair-caps +{time.perf_counter() - t_phase:.1f} s] {msg}")

    n = RES * RES
    xla = dict(merge_backend="xla")
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0], device=dev)
    launches = {}

    # (a) The CLI entry: -i 8 --merge-backend xla, one block of 8.
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(M, S)
        blocks = run_cli(cli, f"{tmp}/xla.bmp", "vcm", BLOCK_ITERS,
                         ("--merge-backend", "xla"), quiet=True)
        cli_counts = read_counts(M, S)
    if [(a, b) for a, b, *_ in blocks] != [(0, BLOCK_ITERS - 1)] \
            or cli_counts["merge_cells"] or cli_counts["intersect_sweep"] \
            <= 0 or cli_counts["occluded_sweep"] <= 0:
        raise AssertionError(f"pair caps cli: blocks {blocks}, launches "
                             f"{cli_counts}")
    launches["pair_caps_cli"] = cli_counts
    plog(f"cli -i {BLOCK_ITERS} --merge-backend xla: one block in "
         f"{1e3 * blocks[0][4]:.1f} ms (caps cached by the CLI's first "
         f"render or measured there), mean {blocks[0][2]:.6f}; launches "
         f"{cli_counts}")

    # (b) render(): cold (a capture), warm, one host sync a block, host
    # launch calls an iteration, peak memory.
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    capture_s = graphs.stage.capture_s
    cold = _blocks_render(torch, scene, "vcm", BLOCK_ITERS, **xla)
    capture_s = graphs.stage.capture_s - capture_s
    warm = _blocks_render(torch, scene, "vcm", BLOCK_ITERS, **xla)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            torch.cuda.max_memory_reserved(dev) / 2 ** 30)
    img, cfg, counts = warm.img, warm.cfg, warm.launches
    host = block_host_counts(scene, cfg, BLOCK_ITERS, BLOCK_ITERS)
    calls_iter = host["host_launch_calls"] / BLOCK_ITERS
    if cold.captures != 1 or warm.captures or host["host_syncs"] != 1 \
            or calls_iter > BLOCK_HOST_CALLS_MAX or counts["merge_cells"] \
            or "overflow" in cold.out + warm.out:
        raise AssertionError(f"pair caps: captures {cold.captures} / "
                             f"{warm.captures}, {host['host_syncs']} host "
                             f"syncs (at {host['sync_sites']}), {calls_iter} "
                             f"host launch calls an iteration, launches "
                             f"{counts}, output {cold.out + warm.out!r}")
    chunks = R.merge_chunks(cfg)
    pair_rows = int(cfg.pair_factor * n)
    launches["pair_caps_vcm"] = counts
    plog(f"vcm {RES}x{RES} -i {BLOCK_ITERS} through the pair merge: "
         f"{1e3 * warm.secs / BLOCK_ITERS:.2f} ms/iteration warm (cold "
         f"{1e3 * cold.secs / BLOCK_ITERS:.2f}, {cold.captures} capture of "
         f"{capture_s:.2f} s host); {host['host_syncs']} host sync a block; "
         f"{calls_iter:.2f} host launch calls an iteration; busy share "
         f"{host['busy_share']:.4f}; peak {peak[0]:.3f} GiB allocated, "
         f"{peak[1]:.3f} reserved; caps pair_factor {cfg.pair_factor} "
         f"({pair_rows} pair rows, merge_chunks {chunks}), photon_factor "
         f"{cfg.photon_factor}, query_factor {cfg.query_factor}; launches "
         f"{counts}; image mean {float(img.mean()):.6f}")

    # (c) --block 1 and graphs.eager(): bit for bit.
    singles = _blocks_render(torch, scene, "vcm", BLOCK_ITERS, block_size=1,
                             **xla)
    with graphs.eager():
        eager = _blocks_render(torch, scene, "vcm", BLOCK_ITERS, **xla)
    for name, other in (("--block 1", singles), ("graphs.eager()", eager)):
        if not torch.equal(other.img, img) or other.rays != warm.rays \
                or other.launches != counts:
            raise AssertionError(
                f"pair caps: {name} differs (max |diff| "
                f"{float((other.img - img).abs().max())}, rays "
                f"{other.rays} vs {warm.rays}, launches {other.launches})")
    plog(f"block of {BLOCK_ITERS} vs --block 1 "
         f"({1e3 * singles.secs / BLOCK_ITERS:.2f} ms/iteration) and vs "
         f"graphs.eager() ({1e3 * eager.secs / BLOCK_ITERS:.2f} "
         f"ms/iteration): images bit for bit, rays and launches equal")

    # (d) Forced overflow: a tiny pair factor grows by the JAX rule and
    # the block renders again to the same bytes.
    forced = _blocks_render(torch, scene, "vcm", BLOCK_ITERS,
                            pair_factor=PAIR_TINY,
                            photon_factor=cfg.photon_factor,
                            query_factor=cfg.query_factor,
                            merge_caps_frozen=True, **xla)
    if "merge cap overflow" not in forced.out \
            or not torch.equal(forced.img, img) \
            or forced.cfg.pair_factor <= PAIR_TINY:
        raise AssertionError(f"pair caps: forced overflow: {forced.out!r}, "
                             f"image equal {torch.equal(forced.img, img)}")
    launches["pair_caps_overflow"] = forced.launches
    plog(f"forced overflow (pair_factor {PAIR_TINY}): "
         f"{forced.out.strip()}; grown to pair_factor "
         f"{forced.cfg.pair_factor}; image bit for bit the measured caps'; "
         f"{1e3 * forced.secs / BLOCK_ITERS:.2f} ms/iteration with the "
         f"re-render")

    # (e) Against the cell merge, and phase 15's pair count.
    cells = _blocks_render(torch, scene, "vcm", BLOCK_ITERS)
    rel = abs(float(img.mean()) / float(cells.img.mean()) - 1.0)
    close = torch.isclose(img, cells.img, rtol=1e-3, atol=1e-6).all(
        dim=-1).float().mean().item()
    if rel > 1e-3 or close < 0.99:
        raise AssertionError(f"pair caps vs cells: mean rel {rel}, pixels "
                             f"{close}")
    _, _, ovf, stats, _ = vcm.render_block_with_stats(
        scene, 1, RES, RES, 1, pair_factor=cfg.pair_factor,
        photon_factor=cfg.photon_factor, query_factor=cfg.query_factor,
        merge_chunks=chunks, **xla)
    pairs1 = int(stats[0])
    if int(ovf) or pairs1 != bench_pairs:
        raise AssertionError(f"pair caps: iteration 1 has {pairs1} pairs "
                             f"(overflow {int(ovf)}), bench_torch.py "
                             f"counted {bench_pairs}")
    plog(f"against the cell merge (-i {BLOCK_ITERS}): mean rel {rel:.2e}, "
         f"pixels within rtol 1e-3 {close:.4f}; iteration 1: {pairs1} "
         f"candidate pairs, {int(stats[1])} photons, {int(stats[2])} "
         f"queries, equal to phase 15's count")

    # (f) Device ms and the stage split of one profiled iteration.
    rays, prof = bench_torch.profile_iteration(
        scene, R.RenderConfig(algorithm="vcm", resolution=(RES, RES),
                              block_size=BLOCK_ITERS, **xla))
    split = ", ".join(f"{k} {v['device_ms']:.3f} / {v['launches']}"
                      for k, v in prof["stages"].items())
    plog(f"profiled iteration 1 (a block of one): {prof['launches']} "
         f"kernels from {prof['host_launch_calls']} host launch calls, "
         f"device {prof['device_ms']:.3f} ms; eager stage split (device ms "
         f"/ kernels): {split}; kernels {prof['kernels']}")

    # (g) 1024x1024 -i 2: the chunk rule's merge_chunks (a graph) against
    # one chunk (eager), bit for bit.
    res = PAIR_RES_CHUNKED
    big = load_cornell_box((res, res), SCENE_CONFIGS[0], device=dev)
    bcfg = R.RenderConfig(algorithm="vcm", resolution=(res, res), **xla)
    zeros = lambda: torch.zeros((res, res, 3), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chunked = R._make_block_runner(big, bcfg, "vcm")(0, 2, zeros())
    big_chunks = R.merge_chunks(bcfg)
    peak_chunked = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with graphs.eager():
        one, _, ovf1, st1, _ = vcm.render_block_with_stats(
            big, 0, res, res, 2, pair_factor=bcfg.pair_factor,
            photon_factor=bcfg.photon_factor, query_factor=bcfg.query_factor,
            merge_chunks=1, accum=zeros(), **xla)
    peak_one = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if big_chunks < 2 or int(ovf1) or not torch.equal(chunked.accum, one) \
            or tuple(st1.tolist()) != chunked.stats:
        raise AssertionError(
            f"pair caps {res}: merge_chunks {big_chunks} vs 1: equal "
            f"{torch.equal(chunked.accum, one)}, overflow {int(ovf1)}, "
            f"stats {st1.tolist()} vs {chunked.stats}; {buf.getvalue()!r}")
    plog(f"vcm {res}x{res} -i 2: the chunk rule's merge_chunks {big_chunks} "
         f"(pair_factor {bcfg.pair_factor}, "
         f"{int(bcfg.pair_factor * res * res)} pair rows; "
         f"{buf.getvalue().count('overflow')} overflow re-renders), "
         f"captured, equal bit for bit to merge_chunks 1 (eager); stats "
         f"{chunked.stats}; peak allocated {peak_chunked:.3f} GiB chunked, "
         f"{peak_one:.3f} GiB with one chunk")
    # The scene's tensors die with it, and its graphs with them.
    del big, chunked, one
    torch.cuda.empty_cache()

    # (h) Phase 11 again with caps: the gradient golden at its caps, and a
    # full-size step at the measured caps against phase 11's.
    data = np.load(GRAD_GOLDEN)
    c = json.loads(str(data["config"]))
    res_x, res_y = c["resolution"]
    gscene = load_cornell_box((res_x, res_y),
                              SCENE_CONFIGS[c["scene_id"]]).to(dev)
    target = torch.full((res_y, res_x, 3), c["target"], device=dev)
    n_li = 3 * gscene.lights.kind.shape[0]
    for alg in c["algorithms"]:
        caps = {}
        if alg != "pt":
            gcfg = R.RenderConfig(algorithm=alg, resolution=(res_x, res_y),
                                  base_seed=c["base_seed"],
                                  max_path_length=c["max_path_length"],
                                  **xla)
            R._ensure_merge_caps(gscene, gcfg, alg)
            caps = R._caps_of(gcfg)
        _, g = diff.loss_and_grad(
            gscene, diff.extract_params(gscene), target, c["iteration"], alg,
            res_x, res_y, n_iterations=c["n_iterations"],
            base_seed=c["base_seed"], max_path_length=c["max_path_length"],
            **caps)
        flat = torch.cat([x.reshape(-1) for x in diff._leaves(g)]).cpu()
        want = torch.from_numpy(data[f"{alg}_grad"])
        if not bool(torch.isfinite(flat).all()):
            raise AssertionError(f"pair caps grad golden {alg}: non-finite")
        torch.testing.assert_close(flat[-n_li:], want[-n_li:], rtol=1e-3,
                                   atol=0.0)
        plog(f"gradient golden {alg} {res_x}x{res_y} at caps {caps}: "
             f"light-intensity grads within rtol 1e-3, every leaf finite")
    target = torch.full((GRAD_RES, GRAD_RES, 3), 0.1, device=dev)
    gcaps = R._caps_of(cfg)
    times = []
    for it in range(3):   # eager, captured, replayed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(M, S)
        t0 = time.perf_counter()
        loss, g = diff.loss_and_grad(scene, diff.extract_params(scene),
                                     target, it, "vcm", GRAD_RES, GRAD_RES,
                                     **gcaps)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    gpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    glaunches = read_counts(M, S)
    if not all(bool(torch.isfinite(x).all()) for x in diff._leaves(g)) \
            or glaunches["merge_cells"] or glaunches["intersect_sweep"] <= 0:
        raise AssertionError(f"pair caps grad: launches {glaunches}")
    launches["pair_caps_grad_vcm"] = glaunches
    plog(f"vcm {GRAD_RES}x{GRAD_RES} x1 forward+backward at the measured "
         f"caps {gcaps}: {times[0]:.1f} ms cold, {times[2]:.1f} ms replayed, "
         f"peak {gpeak:.2f} GiB allocated (phase 11, default caps 24 / 3 / "
         f"3: {grad_steps['vcm']['ms']:.1f} ms, "
         f"{grad_steps['vcm']['peak_gib']:.2f} GiB); loss {float(loss):.6g}")

    # (i) Phase 13 again with caps: two gloo ranks on one card, the pair
    # merge from tiny caps; the summed overflow grows both alike.
    del g, loss
    torch.cuda.empty_cache()   # the ranks share the card
    t0 = time.perf_counter()
    ranks = multihost.spawn(SHARD_RANKS, "cuda:0", _pair_rank, "cuda:0", RES)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r, out in enumerate(ranks):
        if out["caps"] != r0["caps"] or out["stats"] != r0["stats"] \
                or not torch.equal(out["img"], r0["img"]) \
                or out["launches"]["merge_cells"]:
            raise AssertionError(f"pair caps sharded: rank {r} caps "
                                 f"{out['caps']}, stats {out['stats']} vs "
                                 f"rank 0 {r0['caps']}, {r0['stats']}")
    n_shard = n // SHARD_RANKS
    if "merge cap overflow" not in r0["out"] or r0["caps"]["pair_factor"] \
            != R._grow_pairs(PAIR_TINY, r0["stats"][0], n_shard):
        raise AssertionError(f"pair caps sharded: {r0['out']!r}, caps "
                             f"{r0['caps']}, stats {r0['stats']}")
    scfg = R.RenderConfig(algorithm="vcm", resolution=(RES, RES),
                          merge_caps_frozen=True, **xla, **r0["caps"])
    single = R._make_block_runner(scene, scfg, "vcm")(
        0, 2, torch.zeros((RES, RES, 3), device=dev))
    torch.testing.assert_close(r0["img"], single.accum.cpu(), rtol=1e-4,
                               atol=1e-6)
    if r0["stats"][0] != single.stats[0]:
        raise AssertionError(f"pair caps sharded: pairs {r0['stats']} vs "
                             f"single {single.stats}")
    launches["pair_caps_sharded"] = [o["launches"] for o in ranks]
    plog(f"two gloo ranks on cuda:0, vcm {RES}x{RES} x2 (one block) from "
         f"pair_factor {PAIR_TINY}: rank 0 printed "
         f"{r0['out'].strip()!r}; both grew to {r0['caps']} (JAX's rule "
         f"over {n_shard} paths a rank, from the pairs summed over ranks, "
         f"{r0['stats'][0]}); image within rtol 1e-4 / atol 1e-6 of the "
         f"single process at those caps (max |err| "
         f"{float((r0['img'] - single.accum.cpu()).abs().max()):.3g}); "
         f"launches by rank {launches['pair_caps_sharded']}; {spawn_s:.1f} "
         f"s with the spawn")
    return launches


# Phase 19: sharded iterations as one CUDA graph on an NCCL group.
SHARDED_TINY = 0.05     # cell-merge photon and query factors that overflow
# (name, algorithm, iterations, RenderConfig keywords): the one-rank NCCL
# renders, then the renders of two or four ranks where the cards allow.
SHARDED_ONE_CASES = (("vcm", "vcm", BLOCK_ITERS, {}),
                     ("vcm_xla", "vcm", BLOCK_ITERS, {"merge_backend": "xla"}),
                     ("pt", "pt", SIMPLE_BLOCK, {}))
SHARDED_MULTI_CASES = (("vcm_allgather", "vcm", BLOCK_ITERS, {}),
                       ("vcm_ring", "vcm", BLOCK_ITERS,
                        {"vm_exchange": "ring"}),
                       ("pt", "pt", SIMPLE_BLOCK, {}))


def _group_entry(rank: int, world: int, backend: str, init: str,
                 out_dir: str, fn, args):
    import torch
    import torch.distributed as dist

    from smallvcm_tpu_torch.parallel import multihost

    # Everything the rank prints, NCCL's own lines included, goes to its
    # log; SIGUSR1 dumps its Python stacks there (spawn_group on overrun).
    logf = open(Path(out_dir) / f"rank{rank}.log", "w")
    os.dup2(logf.fileno(), 1)
    os.dup2(logf.fileno(), 2)
    faulthandler.register(signal.SIGUSR1, file=logf, all_threads=True)
    t0 = time.perf_counter()
    say = lambda msg: print(f"[rank {rank} +{time.perf_counter() - t0:.2f} "
                            f"s] {msg}", flush=True)
    torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    say(f"joined a {backend} group of {world}")
    try:
        torch.save(fn(*args), Path(out_dir) / f"result{rank}.pt")
        say("results saved")
    finally:
        multihost.shutdown()
        say("left the group")


# A group's deadline (seconds): start-up and teardown, then for each case
# a fixed share (the first iterations: caps, the library's load, the
# capture) and, for each of its renders (cold and warm, and the eager one
# with ``detail``), a time an iteration about 10x the graphs' (the gloo
# twins run eagerly).
GROUP_START_S = 90.0
GROUP_CASE_S = 30.0
GROUP_ITER_S = {"vcm": 1.0, "pt": 0.3}


def group_deadline(cases, detail: bool) -> float:
    renders = 3 if detail else 2
    return GROUP_START_S + sum(
        GROUP_CASE_S + renders * iters * GROUP_ITER_S[alg]
        for _, alg, iters, _ in cases) + (
        GROUP_CASE_S + 2 * BLOCK_ITERS * GROUP_ITER_S["vcm"] if detail else 0)


def spawn_group(world: int, backend: str, fn, *args,
                deadline_s: float) -> list:
    """``fn(*args)`` in ``world`` new processes, rank r on cuda:r, joined in
    one ``backend`` group through a file:// store (one rank too:
    ``multihost.initialize`` makes no group for a single process) -> the
    ranks' results in rank order. No process of this script but these
    ever holds a group.

    The ranks must all have left within ``deadline_s`` (and what is left
    of the script's time): otherwise their Python stacks are dumped to
    their logs, they are killed, and the error names the ranks still
    running with what each had printed. A rank that raises stops the
    others and its error is raised here."""
    import torch
    import torch.multiprocessing as mp

    deadline_s = min(deadline_s, time_left())
    with tempfile.TemporaryDirectory(prefix="svcm_group_") as tmp:
        init = Path(tmp, "rendezvous").as_uri()
        ctx = mp.start_processes(_group_entry,
                                 args=(world, backend, init, tmp, fn, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        end = time.monotonic() + deadline_s
        while not ctx.join(timeout=max(0.0, min(5.0, end - time.monotonic()))):
            if time.monotonic() < end:
                continue
            stuck = [r for r, proc in enumerate(ctx.processes)
                     if proc.is_alive()]
            for r in stuck:
                os.kill(ctx.processes[r].pid, signal.SIGUSR1)
            time.sleep(2.0)
            for proc in ctx.processes:
                proc.kill()
                proc.join()
            logs = "\n".join(
                f"--- rank {r} ---\n"
                + Path(tmp, f"rank{r}.log").read_text(errors="replace")[-6000:]
                for r in range(world) if Path(tmp, f"rank{r}.log").exists())
            raise TimeoutError(
                f"{backend} group of {world}: ranks {stuck} still running "
                f"after {deadline_s:.0f} s; what each rank printed:\n{logs}")
        # How long each rank took to leave its group (its shutdown).
        left = []
        for r in range(world):
            stamps = {what: float(t) for t, what in re.findall(
                r"\+([0-9.]+) s\] (results saved|left)",
                Path(tmp, f"rank{r}.log").read_text())}
            left.append(round(stamps["left"] - stamps["results saved"], 2))
        log(f"[group] {backend} x {world}: each rank left its group "
            f"{left} s after saving its results")
        return [torch.load(Path(tmp) / f"result{r}.pt", weights_only=False)
                for r in range(world)]


def _sharded_graph_rank(cases, detail: bool) -> dict:
    """Phase 19 in each rank of a group: every case through render(), cold
    and warm; with ``detail``, its host syncs and launch calls a block, the
    profiled device events of one iteration and the render under
    ``graphs.eager()``, then the cell merge from tiny caps."""
    import torch
    import torch.distributed as dist

    from bench_torch import block_host_counts
    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.parallel import comm
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    group = dist.group.WORLD
    dev = torch.device("cuda", torch.cuda.current_device())
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0], device=dev)
    out = dict(backend=str(dist.get_backend(group)),
               world=comm.world_size(group), device=str(dev))
    for name, alg, iters, kw in cases:
        kw = dict(kw, group=group)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        cold = _blocks_render(torch, scene, alg, iters, **kw)
        rec = dict(img=cold.img.cpu(), rays=cold.rays, caps=R._caps_of(
            cold.cfg), launches=cold.launches, captures=cold.captures,
            cold_ms=1e3 * cold.secs / iters, out=cold.out, peak_gib=(
                torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                torch.cuda.max_memory_reserved(dev) / 2 ** 30))
        warm = _blocks_render(torch, scene, alg, iters, **kw)
        rec.update(warm_img=warm.img.cpu(), warm_captures=warm.captures,
                   ms=1e3 * warm.secs / iters)
        if detail:
            block = R.auto_block_size(warm.cfg, alg)
            host = block_host_counts(scene, warm.cfg, 0, block)
            run = R._make_block_runner(scene, warm.cfg, alg)
            acc = torch.zeros((RES, RES, 3), device=dev)
            calls, events = launch_profile(torch, lambda: run(0, 1, acc))
            # Eagerly, a block of BLOCK_ITERS at most (pt's 64 iterations
            # would take ~16 s), against the graphs' render of that block.
            short = iters if iters <= BLOCK_ITERS else BLOCK_ITERS
            ref = cold if short == iters else _blocks_render(
                torch, scene, alg, short, block_size=short, **kw)
            with graphs.eager():
                eager = _blocks_render(torch, scene, alg, short,
                                       block_size=short, **kw)
            rec.update(
                eager_ref=dict(img=ref.img.cpu(), rays=ref.rays,
                               launches=ref.launches, iters=short),
                block=block, host_syncs=host["host_syncs"],
                sync_sites=host["sync_sites"], host_calls_iter=host["host_launch_calls"] / block,
                busy=host["busy_share"], profiled_calls=calls,
                nccl_events={k: v for k, v in events.items()
                             if "nccl" in k.lower()},
                copy_events={k: v for k, v in events.items()
                             if "memcpy" in k.lower()},
                device_events=sum(events.values()),
                eager_img=eager.img.cpu(), eager_rays=eager.rays,
                eager_launches=eager.launches,
                eager_ms=1e3 * eager.secs / short)
        out[name] = rec
    if detail:
        forced = _blocks_render(torch, scene, "vcm", BLOCK_ITERS, group=group,
                                photon_factor=SHARDED_TINY,
                                query_factor=SHARDED_TINY)
        out["overflow"] = dict(img=forced.img.cpu(), out=forced.out,
                               caps=R._caps_of(forced.cfg),
                               launches=forced.launches,
                               ms=1e3 * forced.secs / BLOCK_ITERS)
    return out


def _single_render(torch, scene, alg: str, iters: int, caps: dict, **kw):
    """The single process's render at ``caps``, frozen."""
    return _blocks_render(torch, scene, alg, iters, merge_caps_frozen=True,
                          **caps, **kw)


def check_sharded_graphs(torch, dev) -> dict:
    """Phase 19: sharded iterations as one CUDA graph on NCCL groups ->
    the kernels' launches by path."""
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    t_phase = time.perf_counter()

    def slog(msg):
        log(f"[sharded-graph +{time.perf_counter() - t_phase:.1f} s] {msg}")

    launches = {}
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0], device=dev)
    torch.cuda.empty_cache()       # the rank shares cuda:0 with this process
    (one,) = spawn_group(1, "nccl", _sharded_graph_rank, SHARDED_ONE_CASES,
                         True, deadline_s=group_deadline(SHARDED_ONE_CASES,
                                                         True))
    slog(f"one-rank NCCL group on cuda:0 spawned and rendered in "
         f"{time.perf_counter() - t_phase:.1f} s")
    for name, alg, iters, kw in SHARDED_ONE_CASES:
        r = one[name]
        single = _single_render(torch, scene, alg, iters, r["caps"], **kw)
        block = r["block"]
        fails = []
        if r["captures"] != 1 or r["warm_captures"]:
            fails.append(f"captures {r['captures']} cold, "
                         f"{r['warm_captures']} warm")
        if r["host_syncs"] != 1:
            fails.append(f"{r['host_syncs']} host syncs a block (at "
                         f"{r['sync_sites']})")
        if r["host_calls_iter"] > BLOCK_HOST_CALLS_MAX:
            fails.append(f"{r['host_calls_iter']} host launch calls an "
                         f"iteration (at most {BLOCK_HOST_CALLS_MAX})")
        merges = r["launches"]["merge_cells"]
        if merges != (iters if name == "vcm" else 0) \
                or r["launches"]["intersect_sweep"] <= 0:
            fails.append(f"launches {r['launches']}")
        if "overflow" in r["out"]:
            fails.append(f"overflow: {r['out']!r}")
        ref = r["eager_ref"]
        for what, img, rays, counts, want in (
                ("warm", r["warm_img"], r["rays"], r["launches"], r),
                (f"graphs.eager() (-i {ref['iters']})", r["eager_img"],
                 r["eager_rays"], r["eager_launches"], ref),
                ("the single process", single.img.cpu(), single.rays,
                 single.launches, r)):
            if not torch.equal(img, want["img"]) or rays != want["rays"] \
                    or counts != want["launches"]:
                fails.append(
                    f"against {what}: max |diff| "
                    f"{float((img - want['img']).abs().max())}, rays {rays} "
                    f"vs {want['rays']}, launches {counts} vs "
                    f"{want['launches']}")
        if fails:
            raise AssertionError(f"sharded graph {name}: " + "; ".join(fails))
        launches[f"sharded_graph_{name}"] = [r["launches"]]
        slog(f"{name} {RES}x{RES} -i {iters} on a one-rank NCCL group: one "
             f"block of {block}, {r['captures']} capture; "
             f"{r['ms']:.2f} ms/iteration warm (cold {r['cold_ms']:.2f}, "
             f"graphs.eager() -i {ref['iters']} {r['eager_ms']:.2f}; the "
             f"single process "
             f"{1e3 * single.secs / iters:.2f}); {r['host_syncs']} host sync "
             f"a block; {r['host_calls_iter']:.2f} host launch calls an "
             f"iteration; busy share {r['busy']:.4f}; one profiled "
             f"iteration: {r['profiled_calls']} host launch calls, "
             f"{r['device_events']} device events, NCCL kernels "
             f"{r['nccl_events']}, copies {r['copy_events']}; launches "
             f"{r['launches']}; caps {r['caps']}; peak {r['peak_gib'][0]:.3f} "
             f"GiB allocated, {r['peak_gib'][1]:.3f} reserved; image bit for "
             f"bit the warm run's and the single process's at the same caps "
             f"(mean {float(r['img'].mean()):.6f}), the first "
             f"{ref['iters']} iterations' the graphs.eager() render's")
    forced = one["overflow"]
    if "merge cap overflow" not in forced["out"] \
            or not torch.equal(forced["img"], one["vcm"]["img"]) \
            or min(forced["caps"]["photon_factor"],
                   forced["caps"]["query_factor"]) <= SHARDED_TINY:
        raise AssertionError(f"sharded graph overflow: {forced['out']!r}, "
                             f"caps {forced['caps']}, image equal "
                             f"{torch.equal(forced['img'], one['vcm']['img'])}")
    launches["sharded_graph_overflow"] = [forced["launches"]]
    slog(f"cell merge from caps {SHARDED_TINY}: {forced['out'].strip()!r}; "
         f"grown to {forced['caps']}; image bit for bit the run that never "
         f"overflowed; {forced['ms']:.2f} ms/iteration with the re-render")

    cards = torch.cuda.device_count()
    if cards < 2:
        slog(f"{cards} card visible: two or more NCCL ranks need a card "
             f"each; no multi-rank run and no scaling claimed")
        return launches
    launches.update(check_sharded_multi(torch, scene, slog))
    return launches


def check_sharded_multi(torch, scene, slog) -> dict:
    """Phase 19 where two or more cards are visible: two (and four) NCCL
    ranks, one graph an iteration, against their gloo twins (stage by
    stage) and the single process, then ``scripts/torch_scaling.py
    --ranks 1 2 4`` -> the kernels' launches by path."""
    launches = {}
    cards = torch.cuda.device_count()
    for w in (2, 4):
        if w > cards:
            continue
        runs = {}
        for b in ("nccl", "gloo"):
            t0 = time.perf_counter()
            runs[b] = spawn_group(
                w, b, _sharded_graph_rank, SHARDED_MULTI_CASES, False,
                deadline_s=group_deadline(SHARDED_MULTI_CASES, False))
            slog(f"{w} {b} ranks spawned, rendered and left their group in "
                 f"{time.perf_counter() - t0:.1f} s")
        for name, alg, iters, kw in SHARDED_MULTI_CASES:
            caps = runs["nccl"][0][name]["caps"]
            single = _single_render(torch, scene, alg, iters, caps, **kw)
            want = single.img.cpu()
            nccl, gloo = (runs[b][0][name] for b in ("nccl", "gloo"))
            for b, ranks in runs.items():
                for k, o in enumerate(ranks):
                    rec = o[name]
                    if not torch.equal(rec["img"], gloo["img"]) \
                            or rec["rays"] != single.rays:
                        raise AssertionError(
                            f"sharded graph {w} {b} ranks {name} rank {k}: "
                            f"max |diff| vs gloo "
                            f"{float((rec['img'] - gloo['img']).abs().max())}"
                            f", rays {rec['rays']} vs {single.rays}")
                    if alg == "pt" and not torch.equal(rec["img"], want):
                        raise AssertionError(f"sharded graph {w} ranks pt: "
                                             f"not bit for bit")
                    torch.testing.assert_close(rec["img"], want, rtol=1e-4,
                                               atol=1e-6)
            if nccl["captures"] != 1 or nccl["warm_captures"] \
                    or not torch.equal(nccl["warm_img"], nccl["img"]):
                raise AssertionError(f"sharded graph {w} NCCL ranks {name}: "
                                     f"{nccl['captures']} captures cold, "
                                     f"{nccl['warm_captures']} warm, warm "
                                     f"image equal "
                                     f"{torch.equal(nccl['warm_img'], nccl['img'])}")
            for b in runs:
                launches[f"sharded_graph_{b}{w}_{name}"] = [
                    o[name]["launches"] for o in runs[b]]
            err = float((nccl["img"] - want).abs().max())
            slog(f"{name} {RES}x{RES} -i {iters} on {w} ranks: NCCL "
                 f"(one graph an iteration) "
                 f"{[round(o[name]['ms'], 2) for o in runs['nccl']]} "
                 f"ms/iteration by rank, gloo (eager) "
                 f"{[round(o[name]['ms'], 2) for o in runs['gloo']]}; the "
                 f"single process {1e3 * single.secs / iters:.2f}; NCCL and "
                 f"gloo images bit for bit; max |err| vs the single process "
                 f"{err:.3g} (rtol 1e-4, atol 1e-6); caps {caps}; launches "
                 f"by rank {launches[f'sharded_graph_nccl{w}_{name}']}")
    check_scaling(slog)
    return launches


def run_bounded(cmd, timeout: float) -> subprocess.CompletedProcess:
    """``cmd`` in a session of its own, its stdout and stderr captured; on
    overrun the whole session (the ranks it spawned too) is killed and
    ``subprocess.TimeoutExpired`` raised."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def check_scaling(slog) -> None:
    """``scripts/torch_scaling.py --ranks 1 2 4`` (the rank counts the
    visible cards allow): VCM 512x512 in blocks of 8, both exchanges,
    within what is left of the script's time."""
    proc = run_bounded(
        [sys.executable, str(ROOT / "scripts" / "torch_scaling.py"),
         "--ranks", "1", "2", "4"], timeout=time_left())
    log("\n".join("  | " + line for line in proc.stdout.splitlines()))
    if proc.returncode != 0:
        raise AssertionError(f"torch_scaling: {proc.stderr[-2000:]}")
    runs = json.loads(proc.stdout.splitlines()[-1])["runs"]
    slog("torch_scaling.py --ranks 1 2 4: efficiency " + ", ".join(
        f"{r['ranks']} ranks {r['exchange'] or ''} "
        f"{r.get('efficiency', 'out of memory')}" for r in runs))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import smallvcm_tpu_torch
    from smallvcm_tpu_torch.ops import _cuda

    if Path(smallvcm_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError("smallvcm_tpu_torch is not the copy beside "
                           "chip_smoke.py")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"[card] {card}")
    # The merge caps' cache of this run alone: the first merging render
    # measures, later ones and phase 17's second process read it.
    caps_dir = tempfile.TemporaryDirectory(prefix="svcm_caps_")
    os.environ["SMALLVCM_TPU_TORCH_CACHE"] = caps_dir.name
    t0 = time.perf_counter()
    _cuda.load_library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s -> {_cuda.library_path()}")
    ptxas = (_cuda.library_path().parent / "build.log")
    for line in ptxas.read_text().splitlines() if ptxas.exists() else []:
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log("  ptxas: " + line.strip())

    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        now = time.perf_counter()
        log(f"[time] {name}: {now - phase_t:.1f} s")
        phase_t = now

    sweep_r = check_sweep(torch, dev)
    occl_r = check_occlusion(torch, dev)
    rng_r = check_rng(torch, dev)
    bsdf_r = check_bsdf(torch, dev)
    lights_r = check_lights(torch, dev)
    phase_done("phase 3 (sweeps, rng, bsdf, lights)")
    merge_r, prep_r = check_merge(torch, dev)
    check_golden(torch, dev)
    phase_done("phases 4-5")
    launches, _ms_iter, _rays_s, rays_iter1 = check_main_path(torch)
    phase_done("phase 6 (vcm)")
    simple = check_simple_paths(torch)
    for alg in ("el", "pt"):
        check_golden(torch, dev, DATA / f"torch_golden_{alg}_s0_32.npz")
    phase_done("phase 7 (el, pt)")
    family = check_family_paths(torch)
    phase_done("phase 8 (lt, ppm, bpm, bpt)")
    backends = check_merge_backends(torch, dev)
    phase_done("phase 9 (merge backends, tea)")
    ckpt_launches = check_checkpoint(torch)
    phase_done("phase 10 (checkpoint)")
    grads = check_gradients(torch, dev)
    phase_done("phase 11 (gradients)")
    check_report(torch)
    phase_done("phase 12 (report)")
    sharded = check_sharded(torch, dev)
    phase_done("phase 13 (sharding, codec, supervisor)")
    matrix = check_matrix(torch, dev)
    phase_done("phase 14 (matrix)")
    bench, bench_pairs = check_bench(rays_iter1,
                                     occl_r["launches_per_iteration"])
    phase_done("phase 15 (bench)")
    graph_r = check_graphs(torch, dev)
    phase_done("phase 16 (graphs against eager)")
    blocks = check_blocks(torch, dev)
    phase_done("phase 17 (blocks)")
    pair_caps = check_pair_caps(torch, dev, bench_pairs, grads)
    phase_done("phase 18 (pair merge at caps)")
    sharded_graphs = check_sharded_graphs(torch, dev)
    phase_done("phase 19 (sharded graphs)")
    log(f"[time] total: {time.monotonic() - _T0:.1f} s (limit "
        f"{SCRIPT_LIMIT_S:.0f} s)")

    by_path = lambda name: {
        "vcm": launches[name],
        **{alg: r["launches"][name] for alg, r in {**simple,
                                                    **family}.items()},
        "vcm_xla": backends["launches"]["xla"][name],
        "vcm_tea": backends["launches"]["tea"][name],
        "checkpoint_resume": ckpt_launches[name],
        **{f"grad_{alg}": r["launches"][name] for alg, r in grads.items()},
        **{path: [n[name] for n in by_rank]
           for path, by_rank in sharded.items()},
        **{path: n[name] for path, n in matrix.items()},
        "bench": bench.get(name),  # bench_torch.py counts its KERNELS
        **{f"graphs_{alg}": r["launches"][name] for alg, r in
           graph_r.items()},
        **{path: n[name] for path, n in blocks.items()},
        **{path: ([x[name] for x in n] if isinstance(n, list) else n[name])
           for path, n in pair_caps.items()},
        **{path: [x[name] for x in n] for path, n in sharded_graphs.items()},
    }
    kernels = [
        dict(name="merge_cells", route="cuda",
             source="smallvcm_tpu_torch/csrc/merge_cells.cu",
             replaces="smallvcm_tpu/ops/pallas_merge.py:170",
             launches=launches["merge_cells"],
             launches_by_path=by_path("merge_cells"), **merge_r),
        dict(name="merge_prep", route="cuda",
             source="smallvcm_tpu_torch/csrc/merge_prep.cu",
             replaces=None,
             launches=launches["merge_prep"],
             launches_by_path=by_path("merge_prep"), **prep_r),
        dict(name="intersect_sweep", route="cuda",
             source="smallvcm_tpu_torch/csrc/intersect_sweep.cu",
             replaces="smallvcm_tpu/ops/pallas_intersect.py:46",
             launches=launches["intersect_sweep"],
             launches_by_path=by_path("intersect_sweep"), **sweep_r),
        dict(name="occluded_sweep", route="cuda",
             source="smallvcm_tpu_torch/csrc/intersect_sweep.cu",
             replaces="smallvcm_tpu/ops/pallas_intersect.py:46",
             launches=launches["occluded_sweep"],
             launches_by_path=by_path("occluded_sweep"), **occl_r),
        dict(name="uniform_slots", route="cuda",
             source="smallvcm_tpu_torch/csrc/rng_slots.cu",
             replaces=None,
             launches=launches["uniform_slots"],
             launches_by_path=by_path("uniform_slots"), **rng_r),
        dict(name="bsdf", route="cuda",
             source="smallvcm_tpu_torch/csrc/bsdf.cu",
             replaces=None,
             launches=launches["bsdf"],
             launches_by_path=by_path("bsdf"), **bsdf_r),
        dict(name="lights", route="cuda",
             source="smallvcm_tpu_torch/csrc/lights.cu",
             replaces=None,
             launches=launches["lights"],
             launches_by_path=by_path("lights"), **lights_r),
    ]
    caps_dir.cleanup()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
