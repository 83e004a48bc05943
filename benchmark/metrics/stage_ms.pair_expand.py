"""Pair merge: device ms of its expansion an iteration, from the stamp
``pair_tables`` to ``pair_expand``: the candidate pairs by segment carry,
the exact r^2 and path-length test and the survivor sort (the port's stage
clocks, trace.py), the median over the recorded iterations, the most of
any rank; None where the pair merge stamps nothing, or runs in more than
one query chunk (expansion and shading then interleave, and
``stage_ms.pair_shade`` holds both)."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "pair merge (algorithms/vcm.py::merge_stage)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("pair_expand"))
