#!/usr/bin/env python3
"""What a torch.profiler session costs the timings that follow it.

In one process: time an algorithm twice as bench_torch.py times it (first
iteration, settle loop, ``--repeats`` calls of ``--iters`` iterations),
profile one iteration as bench_torch.py does, then time it a third time.
The second timing over the first is the control (what the host drifts
with no profiler session between); the third over the second is the
session's cost. Prints the medians, spreads and both ratios on stderr and
one JSON line on stdout. bench_torch.py times every algorithm before its
first profiler session because of what this script measures.

    python scripts/torch_profile_cost.py [--alg vcm] [--res 512]
        [--iters 8] [--repeats 5] [--warmup 6] [--device cuda]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _bench_torch():
    spec = importlib.util.spec_from_file_location("bench_torch",
                                                  ROOT / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alg", default="vcm")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    B = _bench_torch()
    from smallvcm_tpu_torch.device import resolve_device
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    dev = resolve_device(args.device)
    card = B.card_line(dev)
    B.eprint(f"[card] {card}")
    scene = load_cornell_box((args.res, args.res),
                             SCENE_CONFIGS[B.SCENE_ID], device=dev)
    cfg = B.bench_config(args.alg, args.res)
    timed = lambda: B.median_spread(B.time_algorithm(
        scene, cfg, args.iters, args.repeats, args.warmup)["per_iter_ms"])
    runs = dict(first=timed(), control=timed())
    _, prof = B.profile_iteration(scene, cfg)
    runs["after"] = timed()
    for name, ms in runs.items():
        B.eprint(f"{args.alg} {name}: {ms['median']:.3f} ms/iter median "
                 f"(min {ms['min']:.3f}, max {ms['max']:.3f}, {ms['n']} "
                 f"repeats of {args.iters})")
    drift = runs["control"]["median"] / runs["first"]["median"]
    cost = runs["after"]["median"] / runs["control"]["median"]
    B.eprint(f"control / first (no session between): {drift:.4f}; after / "
             f"control (one profiler session between): {cost:.4f}")
    print(json.dumps(dict(
        alg=args.alg, res=args.res, card=card, **runs, drift=drift,
        cost=cost, launches_per_iter=prof["launches"] if prof else None)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
