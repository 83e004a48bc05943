"""Cell merge: device ns a candidate pair, the median device ms of the
stage ``merge_kernel`` an iteration (the cell walk, ``merge_post`` and the
sums, from the stamp ``merge_prep`` to ``merge_kernel``) over the median
candidate pairs that stamp carries (the live queries' range lengths; the
port's stage clocks, trace.py): the merge's cost with the photon map's
density taken out. The most of any rank; None where the stamp carries no
count, or no pair."""

from benchmark.harness import program_trace as P

UNIT = "ns"
LAYER = "merge (ops/merge.py, csrc/merge_cells.cu)"
MOVES = "ms_per_iter"


def read(rec):
    def per_pair(s):
        stage = s.get("stages", {}).get("merge_kernel", {})
        pairs = stage.get("count")
        return None if not pairs else 1e6 * stage["median_ms"] / pairs
    return P.most(rec, per_pair)
