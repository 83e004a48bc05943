"""Iteration: device ms of the light walk an iteration, from the
iteration's start stamp to the end of the light walk inside the replayed
CUDA graph (the port's stage clocks, trace.py), the median over the
recorded iterations, the most of any rank."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "iteration (algorithms, ops/bsdf.py, ops/lights.py, core/rng.py)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("light_walk"))
