"""Iteration graphs: host calls that launch work (kernels or graphs) in
one profiled block, per iteration of it (the most of any rank)."""

UNIT = "count"
LAYER = "iteration graphs (graphs.py)"
MOVES = "ms_per_iter"


def read(rec):
    if "block_launch_calls" not in rec:
        return None
    return rec["block_launch_calls"] / rec["block"]
