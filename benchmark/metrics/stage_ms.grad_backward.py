"""Gradients: device ms of a gradient step's backward, from the loss to the
gradients, the checkpoint's recomputation of the iteration inside it (the
port's stage clocks, trace.py: the stamp grad_backward), the median over
the recorded steps."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "gradients (diff.py, graphs.py)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("grad_backward"))
