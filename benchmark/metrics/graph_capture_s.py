"""Iteration graphs: seconds of the CUDA graph captures, the port's
graphs.capture spans summed (trace.py), the most of any rank."""

from benchmark.harness import program_trace as P

UNIT = "s"
LAYER = "iteration graphs (graphs.py)"
MOVES = "setup_s"


def read(rec):
    return P.most(rec, P.span_s("graphs.capture"))
