"""Pair merge: device ms of its tables an iteration, from the camera
walk's end to the stamp ``pair_tables``: the photons' full-width hash
into 8 n buckets and their sort-compaction, the queries' compaction, probe
cells and 20 int32 fields a query (the port's stage clocks, trace.py), the median
over the recorded iterations, the most of any rank; None where the pair
merge stamps nothing (the cell merge, or a port without the stamp)."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "pair merge (algorithms/vcm.py::merge_stage)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("pair_tables"))
