"""Cell merge: the share of the photon rows its preparation sorts that hold
a photon, the median live photons an iteration (the count of the stamp
``merge_prep``) over the photon tables' static rows (the counter
``merge.photon_rows``, every rank's slots after the all-gather; the port's
trace, trace.py); the rest of the sorted width is dead. The most of any
rank; None where the cell merge's stamp carries no count."""

from benchmark.harness import program_trace as P

UNIT = "%"
LAYER = "merge (ops/merge.py, csrc/merge_cells.cu)"
MOVES = "ms_per_iter"


def read(rec):
    def share(s):
        count = s.get("stages", {}).get("merge_prep", {}).get("count")
        rows = s.get("counters", {}).get("merge.photon_rows")
        return None if count is None or not rows else 100.0 * count / rows
    return P.most(rec, share)
