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
   reference, kernel launch counts, and a bitwise-repeatable second run;
7. eye light (2 iterations) and path tracing (8 iterations) at 512x512
   through the CLI: ms/iteration, rays/s, image mean against the
   reference, sweep launches, a bitwise second run; their 32x32 JAX
   golden images;
8. lt, ppm, bpm and bpt at 512x512, 2 iterations each, through the CLI:
   ms/iteration and image mean against the reference;
9. VCM 512x512 through the pair-expansion merge (``merge_backend="xla"``)
   against the tile kernel's render: means, pixels, merge launches; VCM
   with the TEA generator; ``trace_backend="xla"`` refused on the card;
10. checkpoint/resume through the CLI: -i 2 then -i 4 resumed gives the
    BMP bytes of an uninterrupted -i 4;
11. gradients: loss_and_grad against the JAX gradient golden at 32x32
    (pt, bpm); one forward+backward of pt and vcm at full size with time,
    peak memory and sweep launches; the sweep kernel's autograd Function
    against the plain sweep's autograd on 262,144 rays;
12. ``--report -i 1 --resolution 64 64`` on the card: 28 BMPs and
    index.html.

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


_ITER = re.compile(r"iter (\d+): luminance=\S+ mean=(\S+) rays=(\d+) "
                   r"dt=([\d.]+)s")


def run_cli(cli, out_path: str, alg: str = "vcm", n_iter: int = 8,
            extra=(), quiet: bool = False, rendered: int | None = None):
    """cli.main on scene 0 at RES x RES on the card -> the per-iteration
    (index, mean, rays, dt) tuples of its -v lines (``rendered`` of them,
    default ``n_iter``; fewer when a checkpoint resumes the run)."""
    argv = ["-s", "0", "-a", alg, "-i", str(n_iter), "--resolution",
            str(RES), str(RES), "-o", out_path, "--device", "cuda", "-v",
            *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    if not quiet:
        log("\n".join("  | " + line for line in text.splitlines()))
    if rc != 0:
        raise AssertionError(f"cli exited {rc}")
    iters = [m.groups() for m in _ITER.finditer(text)]
    rendered = n_iter if rendered is None else rendered
    if len(iters) != rendered:
        raise AssertionError(f"cli: expected {rendered} per-iteration "
                             "lines")
    return iters


def reset_counts(M, S):
    S.sweep_kernel.launches = 0
    M.merge_tiles_kernel.launches = 0


def read_counts(M, S) -> dict:
    return dict(intersect_sweep=S.sweep_kernel.launches,
                merge_tiles=M.merge_tiles_kernel.launches)


def steady(iters):
    """(ms/iteration after the first, rays/s after the first, mean)."""
    dts = [float(it[3]) for it in iters]
    rays = [int(it[2]) for it in iters]
    tail = slice(1, None) if len(iters) > 1 else slice(None)
    ms = 1e3 * sum(dts[tail]) / len(dts[tail])
    return ms, sum(rays[tail]) / sum(dts[tail]), float(iters[-1][1])


def check_main_path(torch):
    import numpy as np

    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S

    with tempfile.TemporaryDirectory() as tmp:
        bmp1, bmp2 = f"{tmp}/vcm1.bmp", f"{tmp}/vcm2.bmp"
        reset_counts(M, S)
        iters = run_cli(cli, bmp1)
        launches = read_counts(M, S)
        iters2 = run_cli(cli, bmp2, quiet=True)
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
        if launches["intersect_sweep"] <= 0 or launches["merge_tiles"]:
            raise AssertionError(f"{alg}: launches {launches}")
        if not same or [i[1] for i in iters] != [i[1] for i in iters2]:
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
                or (launches["merge_tiles"] > 0) != merges:
            raise AssertionError(f"{alg}: mean {mean} vs {ref}, launches "
                                 f"{launches}")
        log(f"[{alg}] {RES}x{RES} x2 via cli.main: first "
            f"{float(iters[0][3]) * 1e3:.1f} ms, then {ms:.1f} ms/iteration,"
            f" {rays_s:.4g} rays/s; mean {mean:.6f} vs reference {ref} "
            f"({100 * (mean / ref - 1):+.2f}%); launches {launches}")
        out[alg] = dict(ms=ms, rays_s=rays_s, mean=mean, launches=launches)
    return out


def check_merge_backends(torch, dev):
    """Phase 9: VCM through the pair merge vs the tile kernel; TEA RNG."""
    import numpy as np

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    runs = {}
    for name, kw in (("tile", {}), ("xla", dict(merge_backend="xla")),
                     ("tea", dict(rng_kind="tea"))):
        cfg = R.RenderConfig(algorithm="vcm", iterations=2,
                             resolution=(RES, RES), **kw)
        reset_counts(M, S)
        img, secs, _, rays = R.render(scene, cfg)
        runs[name] = (img.cpu().numpy(), secs, read_counts(M, S))
    tile, xla, tea = (runs[k][0] for k in ("tile", "xla", "tea"))
    rel_mean = abs(float(xla.mean()) / float(tile.mean()) - 1.0)
    close = np.isclose(xla, tile, rtol=1e-3, atol=1e-6).all(axis=-1).mean()
    if rel_mean > 1e-4 or close < 0.99:
        raise AssertionError(f"xla merge: mean rel {rel_mean}, pixels "
                             f"{close}")
    if runs["xla"][2]["merge_tiles"] != 0 or \
            runs["tile"][2]["merge_tiles"] <= 0:
        raise AssertionError(f"merge launches {runs['xla'][2]} / "
                             f"{runs['tile'][2]}")
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
    log(f"[merge-backends] vcm {RES}x{RES} x2: tile {ms['tile']:.1f} "
        f"ms/iteration, pair merge (xla) {ms['xla']:.1f} ms/iteration; "
        f"mean rel {rel_mean:.2e}, pixels within rtol 1e-3 {close:.4f}; "
        f"launches tile {runs['tile'][2]} xla {runs['xla'][2]}; tea mean "
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
        for it in range(2):   # the first step also warms PyTorch's kernels
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(M, S)
            t0 = time.perf_counter()
            loss, g = diff.loss_and_grad(scene, diff.extract_params(scene),
                                         target, it, alg, GRAD_RES,
                                         GRAD_RES)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms = times[1]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_counts(M, S)
        leaves = diff._leaves(g)
        if not all(bool(torch.isfinite(x).all()) for x in leaves):
            raise AssertionError(f"grad {alg}: non-finite leaf")
        if float(g.light_intensity.x.abs().max()) <= 0.0:
            raise AssertionError(f"grad {alg}: zero light-intensity grad")
        if launches["intersect_sweep"] <= 0 or launches["merge_tiles"]:
            raise AssertionError(f"grad {alg}: launches {launches}")
        log(f"[grad] {alg} {GRAD_RES}x{GRAD_RES} x1 forward+backward: "
            f"{times[0]:.1f} ms cold, {ms:.1f} ms warm, peak {peak:.2f} "
            f"GiB allocated, loss "
            f"{float(loss):.6g}, light-intensity grad "
            f"{float(g.light_intensity.x[0]):.6g}; launches {launches}")
        steps[alg] = dict(ms=ms, peak_gib=peak, launches=launches)

    # (c) the Function's gradient vs the plain sweep's autograd.
    scene0 = load_cornell_box((RES, RES), SCENE_CONFIGS[0]).to(dev)
    n = RES * RES
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    lo = torch.tensor([-1.27, -1.25, -1.28], device=dev)
    hi = torch.tensor([1.28, 1.30, 1.28], device=dev)
    o = lo[:, None] + (hi - lo)[:, None] * torch.rand(
        (3, n), generator=gen, device=dev)
    d = torch.randn((3, n), generator=gen, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    wts = torch.rand(n, generator=gen, device=dev)

    def ray_grads(kernel):
        rays = [a.contiguous().clone().requires_grad_() for a in (*o, *d)]
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
    return steps


def check_report(torch):
    """Phase 12: --report -i 1 --resolution 64 64 on the card."""
    from smallvcm_tpu_torch import cli
    from smallvcm_tpu_torch.report import REPORT_JOBS

    torch.cuda.empty_cache()  # the report's subprocesses share the card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.chdir(tmp), contextlib.redirect_stdout(buf):
            rc = cli.main(["--report", "-i", "1", "--resolution", "64", "64",
                           "--device", "cuda"])
        secs = time.perf_counter() - t0
        bmps = sorted(p.name for p in Path(tmp).glob("*.bmp"))
        index = (Path(tmp) / "index.html").read_text()
    if rc != 0 or len(bmps) != 28 or not all(b in index for b in bmps):
        raise AssertionError(f"report: rc {rc}, {len(bmps)} BMPs\n"
                             + buf.getvalue()[-2000:])
    log(f"[report] 28 BMPs + index.html at 64x64 x1 on the card in "
        f"{secs:.1f} s (one CLI subprocess per combination, "
        f"{REPORT_JOBS} at a time)")


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

    phase_t = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t
        now = time.perf_counter()
        log(f"[time] {name}: {now - phase_t:.1f} s")
        phase_t = now

    sweep_r = check_sweep(torch, dev)
    merge_r = check_merge(torch, dev)
    check_golden(torch, dev)
    phase_done("phases 3-5")
    launches, _ms_iter, _rays_s = check_main_path(torch)
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

    by_path = lambda name: {
        "vcm": launches[name],
        **{alg: r["launches"][name] for alg, r in {**simple,
                                                    **family}.items()},
        "vcm_xla": backends["launches"]["xla"][name],
        "vcm_tea": backends["launches"]["tea"][name],
        "checkpoint_resume": ckpt_launches[name],
        **{f"grad_{alg}": r["launches"][name] for alg, r in grads.items()},
    }
    kernels = [
        dict(name="merge_tiles", route="cuda",
             source="smallvcm_tpu_torch/csrc/merge_tiles.cu",
             replaces="smallvcm_tpu/ops/pallas_merge.py:170",
             launches=launches["merge_tiles"],
             launches_by_path=by_path("merge_tiles"), **merge_r),
        dict(name="intersect_sweep", route="cuda",
             source="smallvcm_tpu_torch/csrc/intersect_sweep.cu",
             replaces="smallvcm_tpu/ops/pallas_intersect.py:46",
             launches=launches["intersect_sweep"],
             launches_by_path=by_path("intersect_sweep"), **sweep_r),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
