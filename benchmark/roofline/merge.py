"""The cell merge's least work (csrc/merge_cells.cu), counted from what
its inputs need, not from the tables' cap rows: each live query's ranges
(ROWS probed rows, two int32 each), position and path length (4 float32)
and colour out (3 float32); each live photon's position and path length (4
float32) once for every process that reads it (a sharded group's ranks
each read every photon); three scalars; a candidate pair's r^2 and
path-length test (9 operations). What a passing pair reads and computes
beyond that is left out: the bound is a floor."""

from .peaks import least_seconds

ROWS = 4
QUERY_WORDS = 2 * ROWS + 4 + 3
PHOTON_WORDS = 4
SCALARS = 3
OPS_CANDIDATE = 9


def work(queries: int, photons: int, candidates: int,
         photon_reads: int = 1) -> tuple:
    """(bytes, operations) of one merge."""
    n_bytes = 4 * (SCALARS * photon_reads + QUERY_WORDS * queries
                   + PHOTON_WORDS * photons * photon_reads)
    return n_bytes, OPS_CANDIDATE * candidates


def roofline_pct(queries: int, photons: int, candidates: int,
                 device_s: float, photon_reads: int = 1):
    """Share (%) of the merge kernels' device time that the least time
    is; None where no merge ran."""
    if device_s <= 0 or queries <= 0:
        return None
    t, _ = least_seconds(*work(queries, photons, candidates, photon_reads))
    return 100.0 * t / device_s
