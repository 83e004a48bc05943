"""Kernels' library: seconds to build (a checkout's first run) or load the
port's CUDA library, its cuda.library_load span (trace.py), the most of
any rank."""

from benchmark.harness import program_trace as P

UNIT = "s"
LAYER = "kernels' library (ops/_cuda.py)"
MOVES = "setup_s"


def read(rec):
    return P.most(rec, P.span_s("cuda.library_load"))
