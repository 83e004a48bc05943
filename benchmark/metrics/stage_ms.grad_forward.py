"""Gradients: device ms of a gradient step's forward, from its start to
the loss (the port's stage clocks, trace.py: the stamp grad_forward), the
median over the recorded steps."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "gradients (diff.py, graphs.py)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("grad_forward"))
