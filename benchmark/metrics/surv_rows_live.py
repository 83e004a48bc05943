"""Pair merge: the share of the survivor rows that hold a survivor, the
median survivors an iteration (the count of the stamp ``pair_shade``)
over the static survivor rows that the BSDF and the MIS run at (the
counter ``vcm.pair_surv_rows``, the survivor cap times the chunks; the
port's trace, trace.py); the rest of the shading width is dead. The most
of any rank; None where the pair merge stamps nothing."""

from benchmark.harness import program_trace as P

UNIT = "%"
LAYER = "pair merge (algorithms/vcm.py::merge_stage)"
MOVES = "ms_per_iter"


def read(rec):
    def share(s):
        count = s.get("stages", {}).get("pair_shade", {}).get("count")
        rows = s.get("counters", {}).get("vcm.pair_surv_rows")
        return None if count is None or not rows else 100.0 * count / rows
    return P.most(rec, share)
