"""Block runner: the 90th percentile of the host-clock times between
consecutive block ends in the traced run's (unprofiled) window."""

import statistics

UNIT = "ms"
LAYER = "block runner (render.py)"
MOVES = "ms_per_iter"


def read(rec):
    gaps = rec.get("block_gaps_ms") or []
    if len(gaps) < 2:
        return None
    return statistics.quantiles(gaps, n=10, method="inclusive")[8]
