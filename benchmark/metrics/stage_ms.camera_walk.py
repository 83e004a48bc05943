"""Iteration: device ms of the camera walk an iteration, from the end of
the splat flush (pt: the iteration's start, so the camera sample and
every bounce) to the walk's end (the port's stage clocks, trace.py), the
median over the recorded iterations, the most of any rank."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "iteration (algorithms, ops/bsdf.py, ops/lights.py, core/rng.py)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("camera_walk"))
