"""Sharding: photon-exchange bytes of the window (the port's comm
counters, counted through graph replays), per iteration, in MB, the most
of any rank."""

UNIT = "MB"
LAYER = "sharding (parallel/comm.py, parallel/sharding.py)"
MOVES = "ms_per_iter"


def read(rec):
    if "exchange_bytes" not in rec or not rec.get("iterations") \
            or rec.get("world", 1) < 2:
        return None
    return rec["exchange_bytes"] / rec["iterations"] / 1e6
