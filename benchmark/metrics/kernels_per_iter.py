"""Iteration: device kernels of one profiled block's graph replays over its
iterations, copies and fills left out (the most of any rank)."""

UNIT = "count"
LAYER = "iteration (algorithms, ops/bsdf.py, ops/lights.py, core/rng.py)"
MOVES = "ms_per_iter"


def read(rec):
    it = rec.get("profile")
    return None if it is None else it["kernels"] / it["iterations"]
