"""Sharding: device ms of the photon exchange an iteration (pack,
all-gather and unpack, waiting for the other ranks included; the port's
stage clocks, trace.py), the median over the recorded iterations, the
most of any rank."""

from benchmark.harness import program_trace as P

UNIT = "ms"
LAYER = "sharding (parallel/comm.py, parallel/sharding.py)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, P.stage_ms("exchange"))
