#!/usr/bin/env python3
"""The readings the checks' limits are set from (not part of a run).

For each of ``--seeds`` it runs the cell as a run does, with a short window
(``--seconds``), and records each number compared: the program's readings,
whose largest is the lower reading of each limit. For the first
``--controls`` of them it then puts the reference, computed in bfloat16
(every image and running sum rounded to bfloat16; the configuration
states float32), in the program's place: the control's
readings, whose smallest is the upper reading. All in one process:

    python benchmark/control.py --workload vcm.s0.512 --seconds 3 \\
        --seeds 11 12 13 14 15 16 17 18 19 20 21 22 --controls 3

Prints one JSON line: the readings by seed and, per number, the lower and
upper readings beside the configuration's limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import torch

    from benchmark.harness import env, spec
    from benchmark.harness.context import Context
    from benchmark.harness.main import eprint

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=0,
                    help="square resolution in place of the configuration's "
                         "(the CPU rehearsal and the tests; 0 = as stated)")
    args = ap.parse_args(argv)
    env.set_cache_dirs()
    cell = spec.cell_spec(spec.load_benchmark(env.ROOT), args.workload)
    if args.res:
        cell.config["resolution"] = [args.res, args.res]
    if args.device != "cpu":
        env.check_cards(cell.chips)
    driver = spec.load_driver(cell.traffic)
    from benchmark.harness.main import run_driver

    program, control = {}, {}
    for i, seed in enumerate(args.seeds):
        ctx = Context(cell=cell, seed=seed, seconds=args.seconds,
                      trace=False, device=args.device,
                      start_epoch=env.process_start_epoch())
        t0 = time.perf_counter()
        outcome = run_driver(ctx)
        program[seed] = {c.name: c.value for c in outcome.checks}
        eprint(f"[program] seed {seed}: {program[seed]} "
               f"({time.perf_counter() - t0:.1f} s)")
        if i < args.controls:
            checks = driver.control_checks(ctx, outcome.replay,
                                           torch.bfloat16)
            control[seed] = {c.name: c.value for c in checks}
            eprint(f"[control] seed {seed}: {control[seed]}")
    limits = cell.config["limits"][driver.LIMITS]
    summary = {
        name: dict(lower=max(r[name] for r in program.values()),
                   upper=min(r[name] for r in control.values())
                   if control else None, limit=limits.get(name))
        for name in next(iter(program.values()))}
    for name, s in summary.items():
        eprint(f"[limit] {name}: lower {s['lower']!r}, upper "
               f"{s['upper']!r}, limit {s['limit']!r}")
    print(json.dumps(dict(workload=args.workload, program=program,
                          control=control, summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
