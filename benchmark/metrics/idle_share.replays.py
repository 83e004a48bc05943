"""Device: the share of the device's time outside the iteration graphs,
from the port's own stage clocks (trace.py, no profiler): the gaps between
an iteration's last stamp and the next one's first, the gap before a
block's first iteration included, over the time from the previous
block's end to the block's; the median over blocks, the most of any
rank. The twin, from inside the program, of idle_share.render."""

from benchmark.harness import program_trace as P

UNIT = "%"
LAYER = "device (H100)"
MOVES = "ms_per_iter"


def read(rec):
    def share(s):
        v = s.get("idle", {}).get("share_median")
        return None if v is None else 100.0 * v
    return P.most(rec, share)
