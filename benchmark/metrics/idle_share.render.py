"""Device: one minus the device time inside the iteration-graph replays
over the device span from the window's first replay to its last (CUDA
events around each replay in the traced run's unprofiled window; the gaps
between blocks count as idle), the most of any rank."""

UNIT = "%"
LAYER = "device (H100)"
MOVES = "ms_per_iter"


def read(rec):
    v = rec.get("replay_idle_share")
    return None if v is None else 100.0 * v
