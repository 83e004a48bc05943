#!/usr/bin/env python3
"""Compare the ray sweeps of several checkouts of the port within one run
on one CUDA card, each checkout in a process of its own.

    python scripts/torch_sweep_ab.py [--quick] OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (for example a
parent commit unpacked with ``git archive`` into a git-ignored directory);
that checkout's smallvcm_tpu_torch builds and runs. For each run it prints
the ptxas lines of its build and:

- the closest-hit kernel's ms on 262,144 and on 2,097,152 random rays;
- one 512x512 scene-0 VCM iteration with every ``intersect`` and
  ``occluded`` call recorded: per call site, the calls, rays, active
  share, kernel launches and the ms of the checkout's own ``occluded``
  call (whatever it launches); the largest call's ms as recorded, with one
  live lane and with every lane active; the closest-hit kernel's ms summed
  over the iteration's bounces;
- from torch.profiler over one warm VCM iteration: the sweep kernels'
  device ms and the kernel launches;
- unless ``--quick``: VCM (8 iterations), pt (8) and bpt (2) at 512x512
  through ``cli.main``: ms/iteration and the BMP bytes' sha256, and
  whether they equal the first run's.

Kernel times are device times (chip_smoke.time_cuda queues the launches
behind a device spin). The recording, timing and profiling helpers are
this repository's chip_smoke.py, which import the package of the checkout
under test. Exits non-zero if a run fails or a BMP differs from the first
run's.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
RENDERS = (("vcm", 8), ("pt", 8), ("bpt", 2))


def _helpers():
    spec = importlib.util.spec_from_file_location(
        "sweep_ab_smoke", HERE.parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _closest_hit_fn(S, scene):
    """The checkout's closest-hit kernel on (org, direction)."""
    if hasattr(S, "scene_tables"):  # before the packed scene block
        tables = S.scene_tables(scene)
        n_tri, n_sph = scene.tri_mat.shape[0], scene.sph_mat.shape[0]
        return lambda o, d: S.sweep_kernel(tables, n_tri, n_sph, o, d)
    return lambda o, d: S.sweep_kernel(scene, o, d)


def child(root: Path, quick: bool) -> int:
    sys.path.insert(0, str(root))
    import torch

    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import _cuda
    from smallvcm_tpu_torch.ops import intersect as I
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    ab = _helpers()
    dev = torch.device("cuda", 0)
    _cuda.load_library()
    for line in (_cuda.library_path().parent / "build.log").read_text() \
            .splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line or "stack frame" in line:
            print("  ptxas:", line.strip())
    res = ab.RES
    scene = load_cornell_box((res, res), SCENE_CONFIGS[0]).to(dev)
    hit = _closest_hit_fn(S, scene)
    out = {}
    for n in (res * res, 8 * res * res):
        org, dirn = ab.random_rays(torch, dev, n, ab.SEED)
        out[f"closest_hit_random_{n}_ms"] = ab.time_cuda(
            torch, lambda: hit(org, dirn), 50)
    cfg = R.RenderConfig(algorithm="vcm", iterations=1, resolution=(res, res))
    # Size the merge caps first: a measuring iteration's calls are not the
    # iteration's.
    R._ensure_merge_caps(scene, cfg, "vcm")
    calls = ab.record_iteration(torch, scene, cfg)
    out["closest_hit_bounce_ms"] = sum(
        ab.time_cuda(torch, lambda: hit(*args), 20)
        for _, args in calls["intersect"])
    sites, biggest = {}, None
    for site, args in calls["occluded"]:
        r = sites.setdefault(site, dict(calls=0, rays=0, active=0, ms=0.0,
                                        launches=0))
        before = S.occluded_kernel.launches
        I.occluded(scene, *args)
        r["launches"] += S.occluded_kernel.launches - before
        shape, _, _, _, active = S.occlusion_operands(*args)
        r["calls"] += 1
        r["rays"] += active.numel()
        r["active"] += int(active.sum())
        r["ms"] += ab.time_cuda(torch, lambda: I.occluded(scene, *args), 20)
        if biggest is None or active.numel() > biggest[3].numel():
            biggest = (*args[:3], active.reshape(shape))
    out["occluded_call_ms"] = sites
    point, dirn, dist, active = biggest
    one = torch.zeros_like(active)
    one.view(-1)[int(active.reshape(-1).nonzero()[0, 0])] = True
    out["connection_call"] = dict(rays=active.numel(), active=int(
        active.sum()), **{name: ab.time_cuda(torch, lambda: I.occluded(
            scene, point, dirn, dist, mask), 20) for name, mask in (
            ("masked_ms", active), ("one_lane_ms", one),
            ("all_active_ms", torch.ones_like(active)))})
    by_name, launches, device_ms = ab.profile_iteration(torch, scene, cfg)
    out["sweep_kernels_device_ms"] = {
        k: v for k, v in by_name.items() if "sweep_kernel" in k}
    out["sweep_device_ms_per_iteration"] = sum(
        out["sweep_kernels_device_ms"].values())
    out["launches_per_iteration"] = launches
    out["device_ms_per_iteration"] = device_ms

    renders = {}
    with tempfile.TemporaryDirectory() as tmp:
        for alg, n_iter in () if quick else RENDERS:
            bmp = f"{tmp}/{alg}.bmp"
            iters = ab.run_cli(cli, bmp, alg, n_iter, quiet=True)
            ms, _, mean = ab.steady(iters)
            renders[alg] = dict(
                ms_per_iteration=ms, mean=mean,
                sha256=hashlib.sha256(Path(bmp).read_bytes()).hexdigest())
    out["renders"] = renders
    print("RESULT", json.dumps(out), flush=True)
    return 0


def main(roots) -> int:
    quick = roots[:1] == ["--quick"]
    roots = roots[quick:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    failed, results = 0, []
    for i, root in enumerate(roots):
        root = Path(root).resolve()
        print(f"[run {i}] {root}", flush=True)
        proc = subprocess.run(
            [sys.executable, str(HERE), "--child", str(root),
             *(["--quick"] if quick else [])], cwd=root,
            capture_output=True, text=True, timeout=1500)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            failed += 1
            continue
        res = json.loads(proc.stdout.rsplit("RESULT ", 1)[1])
        results.append(res)
        first = results[0]["renders"]
        same = {alg: res["renders"][alg]["sha256"] == first[alg]["sha256"]
                for alg in res["renders"]}
        failed += not all(same.values())
        sites, conn = res["occluded_call_ms"], res["connection_call"]
        print(f"[run {i}] closest hit "
              + ", ".join(f"{v:.4f} ms ({k.split('_')[3]} random rays)"
                          for k, v in res.items()
                          if k.startswith("closest_hit_random"))
              + f", {res['closest_hit_bounce_ms']:.4f} ms (one iteration's "
              f"bounces); occluded calls "
              + ", ".join(f"{k} {v['ms']:.4f} ms / {v['calls']} calls, "
                          f"{v['rays']} rays, active "
                          f"{v['active'] / v['rays']:.3f}, "
                          f"{v['launches']} launches"
                          for k, v in res["occluded_call_ms"].items())
              + f" (all {sum(v['ms'] for v in sites.values()):.4f} ms); "
              f"the {conn['rays']}-ray call: masked (active "
              f"{conn['active'] / conn['rays']:.3f}) "
              f"{conn['masked_ms']:.4f} ms, one live lane "
              f"{conn['one_lane_ms']:.4f} ms, every lane "
              f"{conn['all_active_ms']:.4f} ms"
              + f"; sweep device {res['sweep_device_ms_per_iteration']:.4f} "
              f"ms/iteration, {res['launches_per_iteration']} launches, "
              f"device {res['device_ms_per_iteration']:.2f} ms; "
              + ", ".join(f"{a} {r['ms_per_iteration']:.1f} ms/it"
                          for a, r in res["renders"].items())
              + f"; BMP bytes equal to run 0: {same}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(Path(sys.argv[2]), "--quick" in sys.argv[3:]))
    sys.exit(main(sys.argv[1:]))
