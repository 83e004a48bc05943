"""Command-line interface with the reference's flags and defaults.

Port of ``smallvcm_tpu/cli.py`` (ParseCommandline, config.hxx:225-388, and
main, smallvcm.cxx:268-326): ``-s <scene> -a <alg> -t <sec> -i <iters>
-o <name> --report``, the resolution, seed, radius and path-length flags,
``--rng``, ``--merge-backend``, ``--trace-backend``, ``--block``,
``--checkpoint``/``--checkpoint-every``, and ``--device`` (default
``cuda``). ``-t`` takes precedence over ``-i``. Asking for a CUDA device
where there is none is an error: the renderer never falls back to the CPU
on its own.

    python -m smallvcm_tpu_torch.cli -s 0 -a vcm -i 8 -o out.bmp
"""

from __future__ import annotations

import argparse
import sys

import torch

from .io.framebuffer import save_image
from .render import (ALGORITHM_NAMES, ALGORITHMS, TRACE_BACKENDS,
                     RenderConfig, render, resolve_algorithm)
from .algorithms.vcm import MERGE_BACKENDS
from .scene.scene import (GLOSSY_FLOOR, SCENE_CONFIGS, get_scene_name,
                          load_cornell_box)


def build_default_filename(scene_config: int, algorithm: str) -> str:
    """config.hxx:153-174: 'g' prefix for glossy floor + scene acronym."""
    name = "g" if (scene_config & GLOSSY_FLOOR) else ""
    _, acronym = get_scene_name(scene_config)
    return f"{name}{acronym}_{algorithm}.bmp"


def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device; a CUDA request without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass "
            "--device cpu to render on the CPU)"
        )
    return dev


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
                   help="photon merge: auto/pallas = the tile merge (the "
                        "CUDA kernel on a card, its plain version on the "
                        "CPU), xla = the differentiable pair-expansion "
                        "merge")
    p.add_argument("--trace-backend", default="auto", choices=TRACE_BACKENDS,
                   help="closest-hit sweep: auto/pallas = the CUDA kernel "
                        "on a card, the dense plain sweep on the CPU; xla "
                        "= the dense sweep, CPU only (an error on a card)")
    p.add_argument("--block", type=int, default=0, dest="block_size",
                   help="accepted for compatibility; no effect (the port "
                        "renders one iteration per step)")
    p.add_argument("--checkpoint", default="", dest="checkpoint",
                   help="checkpoint file; resumes from it if present")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   dest="checkpoint_every",
                   help="save the checkpoint every N iterations")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print per-iteration luminance/mean/rays/timing")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.report:
        from .report import full_report

        full_report(args)
        return 0
    if args.scene_id < 0 or args.scene_id >= len(SCENE_CONFIGS):
        print("Invalid <sceneID> argument, please see help (-h)")
        return 1
    device = resolve_device(args.device)

    algorithm = args.algorithm or "vcm"
    scene_config = SCENE_CONFIGS[args.scene_id]
    scene = load_cornell_box(tuple(args.resolution), scene_config).to(device)
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
    )

    output = args.output_name or build_default_filename(scene_config,
                                                        algorithm)
    if not (output.endswith(".bmp") or output.endswith(".hdr")):
        output += ".bmp"

    print(f"Scene:   {scene_name}")
    print(f"Device:  {device}")
    if cfg.max_time > 0:
        print(f"Target:  {cfg.max_time} seconds render time")
    else:
        print(f"Target:  {cfg.iterations} iteration(s)")
    if resolve_algorithm(scene, algorithm) != algorithm:
        print("Switching from PPM to BPM (scene mixes specular and "
              "non-specular materials)")
    print(f"Running: {ALGORITHM_NAMES[algorithm]}...",
          end="\n" if args.verbose else " ", flush=True)
    if args.checkpoint:
        from .checkpoint import render_resumable

        img, elapsed, iters, rays = render_resumable(
            scene, cfg, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, verbose=args.verbose,
        )
    else:
        img, elapsed, iters, rays = render(scene, cfg, verbose=args.verbose)
    print(f"done in {elapsed:.2f} s ({iters} iterations, {rays} rays)")

    save_image(img, output)
    print(f"Saved:   {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
