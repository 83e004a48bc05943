"""Merge: device ms of the merge an iteration, its preparation (the sorted
tables) plus its kernel and sums, the photon exchange left out (the port's
stage clocks, trace.py), the median over the recorded iterations, the
most of any rank."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "merge (ops/merge.py, csrc/merge_cells.cu)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("merge"))
