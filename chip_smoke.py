#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smallvcm_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each one raises on failure; nothing is caught):

1. the card's name and power limit (nvidia-smi);
2. build both CUDA kernels from csrc/ and report the build time;
3. the ray-sweep kernel against its plain PyTorch version on 262,144
   random rays in scene 0;
4. the merge kernel against its plain version on the merge tables of one
   real 512x512 scene-0 VCM iteration;
5. the golden image (tests/data/torch_golden_vcm_s0_32.npz, rendered by
   the JAX package) against the port's render on the card, and a bitwise
   repeat of that render;
6. the main path through the CLI entry: VCM, scene 0, 512x512, 8
   iterations -> BMP, ms/iteration, rays/s, image mean against the
   reference, kernel launch counts, and a bitwise-repeatable second run.

The last two lines are a JSON object with per-kernel numbers and the
result line ``{"ok": true, "device": {...}}``. It exits non-zero, with
no result, when there is no CUDA device or when the package is not
beside this script.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_vcm_s0_32.npz"
REFERENCE_MEAN = 0.10758   # PARITY.md: scene 0, vcm, reference binary
MEAN_TOL = 0.03
RES = 512
SEED = 1234


def log(*a):
    print(*a, flush=True)


def time_cuda(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` launches (warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def check_sweep(torch, dev):
    from smallvcm_tpu_torch.core.vec3 import V3
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    n = RES * RES
    g = torch.Generator(device=dev).manual_seed(SEED)
    lo = torch.tensor([-1.27, -1.25, -1.28], device=dev)
    hi = torch.tensor([1.28, 1.30, 1.28], device=dev)
    o = lo[:, None] + (hi - lo)[:, None] * torch.rand(
        (3, n), generator=g, device=dev)
    d = torch.randn((3, n), generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    org, dirn = V3(*o.contiguous()), V3(*d.contiguous())
    tables = S.scene_tables(scene)
    n_tri, n_sph = scene.tri_mat.shape[0], scene.sph_mat.shape[0]

    dk, pk = S.sweep_kernel(tables, n_tri, n_sph, org, dirn)
    dp, pp = S.sweep_plain(scene, org, dirn)
    torch.cuda.synchronize()
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0.0)
    mism = pk != pp
    n_mism = int(mism.sum())
    if n_mism:
        # Allowed only where the two nearest distances tie within 1 ulp.
        all_t = torch.cat([S.tri_distances(scene, org, dirn),
                           S.sphere_distances(scene, org, dirn)], dim=1)
        t2 = torch.topk(all_t, 2, dim=1, largest=False).values
        ulp = torch.nextafter(t2[:, 0], torch.full_like(t2[:, 0], 3e38)) \
            - t2[:, 0]
        tie = (t2[:, 1] - t2[:, 0]) <= ulp
        if not bool(tie[mism].all()):
            raise AssertionError(
                f"sweep: {n_mism} primitive mismatches, not all ties")
    hit = dp < S.BIG_DIST
    err = float((dk - dp)[hit].abs().max())
    ms = time_cuda(torch, lambda: S.sweep_kernel(tables, n_tri, n_sph, org,
                                                  dirn), 50)
    plain_ms = time_cuda(torch, lambda: S.sweep_plain(scene, org, dirn), 10)
    log(f"[sweep] {n} rays: max|dist err|={err:.3g} prim mismatches "
        f"(ties)={n_mism}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_merge(torch, dev):
    from smallvcm_tpu_torch.algorithms import vcm
    from smallvcm_tpu_torch.io.framebuffer import new_fb_planes
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    n = RES * RES
    pix = torch.arange(n, device=dev)
    misc = vcm.compute_misc(scene, 0, n, 0.003, 0.75, True, True)
    fb = new_fb_planes(RES, RES, dev)
    verts, fb, _ = vcm.trace_light_paths(scene, misc, pix, 0, fb, SEED, 10, 0,
                                         True, True, False)
    _, queries, _ = vcm._camera_stage(scene, misc, verts, pix, 0, RES, SEED,
                                      10, 0, True, True, False)
    qtab, runs, ptab, _q_path, n_q = M.merge_prep(scene, misc, queries, verts,
                                                  n)
    kw = dict(max_path_length=10, min_path_length=0, ppm=False)
    args = (qtab, runs, ptab, misc.radius_sqr, misc.mis_vc_weight)
    out = M.merge_tiles_kernel(*args, **kw)

    n_tiles = runs.shape[0]
    busy = torch.nonzero(runs[:, 0] > 0).flatten()
    if busy.numel() < 64:
        raise AssertionError(f"merge: only {busy.numel()} non-empty tiles")
    sel = busy[torch.linspace(0, busy.numel() - 1, 96, device=dev).long()
               .unique()]
    q3 = qtab.reshape(M.QF, n_tiles, M.QTILE)
    sub = q3[:, sel].reshape(M.QF, -1).contiguous()
    want = M.merge_tiles_plain(sub, runs[sel].contiguous(), ptab,
                               *args[3:], **kw)
    got = out.reshape(3, n_tiles, M.QTILE)[:, sel].reshape(3, -1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    err = float((got - want).abs().max())
    ms = time_cuda(torch, lambda: M.merge_tiles_kernel(*args, **kw), 10)
    t0 = time.perf_counter()
    M.merge_tiles_plain(*args, **kw, chunk=256)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pairs = int(runs[:, 0].long().sum()) * M.QTILE * M.SLAB
    log(f"[merge] {n_q} queries in {n_tiles} tiles, {ptab.shape[1]} photon "
        f"slots, {pairs} candidate pairs; {sel.numel()} tiles checked: "
        f"max|err|={err:.3g}  kernel {ms:.4f} ms  plain {plain_ms:.1f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_golden(torch, dev):
    import numpy as np

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    data = np.load(GOLDEN)
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
    log(f"[golden] {res[0]}x{res[1]} x{c['iterations']}: pixels within "
        f"rtol 1e-4 = {close:.4f}, mean {got.mean():.6f} vs "
        f"{want.mean():.6f} (rel {rel_mean:.2e}), repeat bitwise equal")
    if close < 0.99 or rel_mean > 1e-4:
        raise AssertionError("golden: port disagrees with the JAX image")


_ITER = re.compile(r"iter (\d+): luminance=\S+ mean=(\S+) rays=(\d+) "
                   r"dt=([\d.]+)s")


def run_cli(cli, out_path: str):
    argv = ["-s", "0", "-a", "vcm", "-i", "8", "--resolution", str(RES),
            str(RES), "-o", out_path, "--device", "cuda", "-v"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    log("\n".join("  | " + line for line in text.splitlines()))
    if rc != 0:
        raise AssertionError(f"cli exited {rc}")
    iters = [m.groups() for m in _ITER.finditer(text)]
    if len(iters) != 8:
        raise AssertionError("cli: expected 8 per-iteration lines")
    return iters


def check_main_path(torch):
    import numpy as np

    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    with tempfile.TemporaryDirectory() as tmp:
        bmp1, bmp2 = f"{tmp}/vcm1.bmp", f"{tmp}/vcm2.bmp"
        S.sweep_kernel.launches = 0
        M.merge_tiles_kernel.launches = 0
        iters = run_cli(cli, bmp1)
        launches = dict(intersect_sweep=S.sweep_kernel.launches,
                        merge_tiles=M.merge_tiles_kernel.launches)
        iters2 = run_cli(cli, bmp2)
        b1, b2 = Path(bmp1).read_bytes(), Path(bmp2).read_bytes()

    if len(b1) != 54 + RES * RES * 3:
        raise AssertionError(f"cli: BMP is {len(b1)} bytes")
    dts = [float(it[3]) for it in iters]
    rays = [int(it[2]) for it in iters]
    mean = float(iters[-1][1])
    if not np.isfinite(mean) or abs(mean / REFERENCE_MEAN - 1) > MEAN_TOL:
        raise AssertionError(f"cli: image mean {mean} vs {REFERENCE_MEAN}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")
    if b1 != b2 or [it[1] for it in iters] != [it[1] for it in iters2]:
        raise AssertionError("cli: second render is not bitwise equal")
    ms_iter = 1e3 * sum(dts[1:]) / len(dts[1:])
    rays_s = sum(rays[1:]) / sum(dts[1:])
    log(f"[main] vcm 512x512 x8 via cli.main: first iteration "
        f"{dts[0] * 1e3:.1f} ms, then {ms_iter:.1f} ms/iteration, "
        f"{rays_s:.4g} rays/s ({rays[-1]} rays/iteration); image mean "
        f"{mean:.6f} vs reference {REFERENCE_MEAN} "
        f"({100 * (mean / REFERENCE_MEAN - 1):+.2f}%); launches {launches}; "
        f"second run bitwise equal")
    return launches, ms_iter, rays_s


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
    t0 = time.perf_counter()
    _cuda.load_library()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s -> {_cuda.library_path()}")
    ptxas = (_cuda.library_path().parent / "build.log")
    for line in ptxas.read_text().splitlines() if ptxas.exists() else []:
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())

    sweep_r = check_sweep(torch, dev)
    merge_r = check_merge(torch, dev)
    check_golden(torch, dev)
    launches, _ms_iter, _rays_s = check_main_path(torch)

    kernels = [
        dict(name="merge_tiles", route="cuda",
             source="smallvcm_tpu_torch/csrc/merge_tiles.cu",
             replaces="smallvcm_tpu/ops/pallas_merge.py:170",
             launches=launches["merge_tiles"], **merge_r),
        dict(name="intersect_sweep", route="cuda",
             source="smallvcm_tpu_torch/csrc/intersect_sweep.cu",
             replaces="smallvcm_tpu/ops/pallas_intersect.py:46",
             launches=launches["intersect_sweep"], **sweep_r),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
