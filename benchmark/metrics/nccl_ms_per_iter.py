"""Sharding: device milliseconds of the NCCL kernels of one profiled block
over its iterations, the most of any rank (mostly waiting for the slowest
rank)."""

UNIT = "ms"
LAYER = "sharding (parallel/comm.py, parallel/sharding.py)"
MOVES = "ms_per_iter"


def read(rec):
    s = rec.get("nccl_s_per_iter")
    return None if s is None else 1e3 * s
