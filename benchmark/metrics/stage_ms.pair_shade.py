"""Pair merge: device ms of its shading an iteration, from the stamp
``pair_expand`` to ``pair_shade``: two BSDF set-ups and one evaluation at
the survivor rows, the MIS weights, the sums per query and per path (the
port's stage clocks, trace.py), the median over the recorded iterations,
the most of any rank; None where the pair merge stamps nothing."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "pair merge (algorithms/vcm.py::merge_stage)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("pair_shade"))
