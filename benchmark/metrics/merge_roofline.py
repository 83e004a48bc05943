"""Merge: the least time for the live queries, live photons and candidate
pairs of a profiled block's first iteration (roofline/merge.py) over the
device time of that iteration's merge_cells kernel (summed over ranks)."""

from benchmark.roofline import merge

UNIT = "%"
LAYER = "merge (ops/merge.py, csrc/merge_cells.cu)"
MOVES = "ms_per_iter"


def read(rec):
    counts = rec.get("merge_counts")
    if counts is None:
        return None
    return merge.roofline_pct(
        counts["queries"], counts["photons"], counts["candidates"],
        rec.get("first_merge_s", 0.0), rec.get("photon_reads", 1))
