"""Command-line interface with the reference's flags and defaults.

Port of ``smallvcm_tpu/cli.py`` (ParseCommandline, config.hxx:225-388, and
main, smallvcm.cxx:268-326): ``-s <scene> -a <alg> -t <sec> -i <iters>
-o <name> --report``, the resolution, seed, radius and path-length flags,
``--rng``, ``--merge-backend``, ``--trace-backend``, ``--block``,
``--checkpoint``/``--checkpoint-every``, ``--devices``, ``--isolate``, and
``--device`` (default ``cuda``). ``-t`` takes precedence over ``-i``.
Asking for a CUDA device where there is none is an error: the renderer
never falls back to the CPU on its own.

    python -m smallvcm_tpu_torch.cli -s 0 -a vcm -i 8 -o out.bmp
    python -m smallvcm_tpu_torch.cli -a vcm -i 8 --devices 4   # 4 cards
    torchrun --nproc-per-node 4 -m smallvcm_tpu_torch.cli -a vcm -i 8
"""

from __future__ import annotations

import argparse
import sys

import torch

from .algorithms.vcm import MERGE_BACKENDS
from .device import resolve_device
from .io.framebuffer import save_image
from .parallel import multihost
from .render import (ALGORITHM_NAMES, ALGORITHMS, TRACE_BACKENDS,
                     RenderConfig, render, resolve_algorithm)
from .scene.scene import (GLOSSY_FLOOR, SCENE_CONFIGS, get_scene_name,
                          load_cornell_box)


def build_default_filename(scene_config: int, algorithm: str) -> str:
    """config.hxx:153-174: 'g' prefix for glossy floor + scene acronym."""
    name = "g" if (scene_config & GLOSSY_FLOOR) else ""
    _, acronym = get_scene_name(scene_config)
    return f"{name}{acronym}_{algorithm}.bmp"


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="smallvcm_tpu_torch",
        description="SmallVCM's 7 light-transport algorithms over 4 "
        "Cornell-box scenes, PyTorch + CUDA wavefront renderer.",
    )
    scene_lines = "; ".join(
        f"{i}={get_scene_name(c)[0]}" for i, c in enumerate(SCENE_CONFIGS)
    )
    p.add_argument("-s", type=int, default=0, dest="scene_id",
                   help=f"scene id (default 0): {scene_lines}")
    alg_lines = "; ".join(f"{a}={ALGORITHM_NAMES[a]}" for a in ALGORITHMS)
    p.add_argument("-a", type=str, default=None, dest="algorithm",
                   choices=ALGORITHMS,
                   help=f"algorithm (default vcm): {alg_lines}")
    p.add_argument("-t", type=float, default=-1.0, dest="max_time",
                   help="seconds to run (takes precedence over -i)")
    p.add_argument("-i", type=int, default=1, dest="iterations",
                   help="iterations to run (default 1)")
    p.add_argument("-o", type=str, default="", dest="output_name",
                   help="output name with .bmp or .hdr extension")
    p.add_argument("--report", action="store_true",
                   help="render all scenes x algorithms and emit index.html")
    p.add_argument("--resolution", type=int, nargs=2, default=(512, 512),
                   metavar=("X", "Y"))
    p.add_argument("--max-path-length", type=int, default=10)
    p.add_argument("--min-path-length", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--radius-factor", type=float, default=0.003)
    p.add_argument("--radius-alpha", type=float, default=0.75)
    p.add_argument("--rng", type=str, default="threefry",
                   choices=("threefry", "tea"), dest="rng_kind",
                   help="counter-based generator; 'tea' is the reference's "
                        "LEGACY_RNG mixing function (its old_rng flavor)")
    p.add_argument("--merge-backend", default="auto", choices=MERGE_BACKENDS,
                   help="photon merge: auto/pallas = the cell merge (the "
                        "CUDA kernel on a card, its plain version on the "
                        "CPU), xla = the differentiable pair-expansion "
                        "merge")
    p.add_argument("--trace-backend", default="auto", choices=TRACE_BACKENDS,
                   help="closest-hit sweep: auto/pallas = the CUDA kernel "
                        "on a card, the dense plain sweep on the CPU; xla "
                        "= the dense sweep, CPU only (an error on a card)")
    p.add_argument("--block", type=int, default=0, dest="block_size",
                   help="iterations per block: each block runs its "
                        "iterations back to back on the device (one CUDA "
                        "graph replay an iteration on a card) and reads the "
                        "host once at its end; checkpoints and -v lines "
                        "come once a block (default 0 = auto: 8 for the "
                        "VCM family, 64 for el and pt at 512x512, scaled "
                        "inversely with the pixels; sharded runs use 1). "
                        "The image does not depend on it")
    p.add_argument("--devices", type=int, default=0,
                   help="shard paths over this many processes (0 = every "
                        "local card, 1 = single device; N > 1 starts N "
                        "ranks, one card each, NCCL; with --device cuda:K "
                        "they share card K over gloo; with --device cpu N "
                        "gloo ranks on the CPU, and 0 means 1). Under "
                        "torchrun the job's ranks are used instead")
    p.add_argument("--isolate", default="auto",
                   choices=("auto", "on", "off"),
                   help="supervise the render in a child process that "
                        "respawns from a checkpoint after a CUDA or NCCL "
                        "runtime fault (isolate.py); auto = off")
    p.add_argument("--checkpoint", default="", dest="checkpoint",
                   help="checkpoint file; resumes from it if present")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   dest="checkpoint_every",
                   help="save the checkpoint every N iterations")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print per-block luminance/mean/rays/timing")
    return p


def _check_devices(want: int, res, n_avail: int | None = None) -> bool:
    """The JAX CLI's refusals (smallvcm_tpu/cli.py:159-178), printed: more
    ranks than ``n_avail`` cards (None: not counted), or a path count the
    ranks do not divide."""
    if n_avail is not None and want > n_avail:
        print(f"Requested --devices {want} but only {n_avail} available")
        return False
    n_pix = res[0] * res[1]
    if want > 1 and n_pix % want != 0:
        print(f"Resolution {res[0]}x{res[1]} ({n_pix} paths) not divisible "
              f"by {want} devices")
        return False
    return True


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = make_parser().parse_args(argv)
    if args.report:
        from .report import full_report

        full_report(args)
        return 0
    # Fault isolation (opt-in), decided before anything touches the card:
    # the supervisor never owns it.
    if args.isolate == "on":
        from .isolate import run_supervised

        return run_supervised(argv)
    if args.scene_id < 0 or args.scene_id >= len(SCENE_CONFIGS):
        print("Invalid <sceneID> argument, please see help (-h)")
        return 1

    # A rank of a job (torchrun, or spawned below) joins its group here.
    fresh = multihost.global_group() is None
    group = multihost.initialize(device=args.device)
    if group is None:
        device = resolve_device(args.device)
        # "cuda" gives each rank a card of its own; "cuda:K" and "cpu" put
        # every rank on that device, and --devices 0 then means one.
        n_cards = (torch.cuda.device_count() if device.type == "cuda"
                   and device.index is None else None)
        want = args.devices or n_cards or 1
        if not _check_devices(want, args.resolution, n_cards):
            return 1
        if want > 1:
            print(f"Devices: {want} (paths sharded over {want} ranks)")
            rcs = multihost.spawn(want, args.device, main, argv)
            return max(rcs)
    else:
        device = multihost.rank_device(args.device)
        if not _check_devices(torch.distributed.get_world_size(),
                              args.resolution):
            return 1
    try:
        return _render_main(args, device, group)
    finally:
        if group is not None and fresh:
            multihost.shutdown()


def _render_main(args, device, group) -> int:
    """Render, and on the coordinator report and save the image."""
    say = print if multihost.is_coordinator() else None
    algorithm = args.algorithm or "vcm"
    output = args.output_name or build_default_filename(
        SCENE_CONFIGS[args.scene_id], algorithm)
    if not (output.endswith(".bmp") or output.endswith(".hdr")):
        output += ".bmp"
    render_one(args, args.scene_id, algorithm, output, device, group,
               checkpoint=args.checkpoint, verbose=args.verbose, say=say)
    return 0


def render_one(args, scene_id: int, algorithm: str, output: str, device,
               group=None, checkpoint: str = "", verbose: bool = False,
               say=None):
    """Render one (scene, algorithm) with the settings of the parsed
    ``args`` (resolution, -i/-t, seed, path lengths, radius, generator,
    backends, block) on ``device``, and on the coordinator save it to
    ``output`` -> (elapsed seconds, iterations).

    ``checkpoint`` resumes from and saves to that file; ``say`` prints the
    CLI's progress lines (None: nothing is printed). The CLI and the
    report (report.py, one call a combination) both render through it."""
    say = say or (lambda *a, **k: None)
    scene_config = SCENE_CONFIGS[scene_id]
    scene = load_cornell_box(tuple(args.resolution), scene_config, device)
    scene_name, _ = get_scene_name(scene_config)
    cfg = RenderConfig(
        algorithm=algorithm,
        iterations=args.iterations,
        max_time=args.max_time,
        radius_factor=args.radius_factor,
        radius_alpha=args.radius_alpha,
        base_seed=args.seed,
        max_path_length=args.max_path_length,
        min_path_length=args.min_path_length,
        resolution=tuple(args.resolution),
        rng_kind=args.rng_kind,
        merge_backend=args.merge_backend,
        trace_backend=args.trace_backend,
        block_size=args.block_size,
        group=group,
    )

    say(f"Scene:   {scene_name}")
    say(f"Device:  {device}" + (
        "" if group is None else
        f" (rank 0 of {torch.distributed.get_world_size()}, backend "
        f"{torch.distributed.get_backend()})"))
    if cfg.max_time > 0:
        say(f"Target:  {cfg.max_time} seconds render time")
    else:
        say(f"Target:  {cfg.iterations} iteration(s)")
    if resolve_algorithm(scene, algorithm) != algorithm:
        say("Switching from PPM to BPM (scene mixes specular and "
            "non-specular materials)")
    say(f"Running: {ALGORITHM_NAMES[algorithm]}...",
        end="\n" if verbose else " ", flush=True)
    if checkpoint:
        from .checkpoint import render_resumable

        img, elapsed, iters, rays = render_resumable(
            scene, cfg, checkpoint_path=checkpoint,
            checkpoint_every=args.checkpoint_every, verbose=verbose,
        )
    else:
        img, elapsed, iters, rays = render(scene, cfg, verbose=verbose)
    say(f"done in {elapsed:.2f} s ({iters} iterations, {rays} rays)")

    if multihost.is_coordinator():
        save_image(img, output)
    say(f"Saved:   {output}")
    return elapsed, iters


if __name__ == "__main__":
    sys.exit(main())
