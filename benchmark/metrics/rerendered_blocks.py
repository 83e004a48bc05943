"""Block runner: blocks rendered again after a merge cap overflow over the
whole run, the port's render.rerendered_blocks counter (trace.py), the
most of any rank (the caps come from the run's seed: 0 expected)."""

from benchmark.harness import program_trace as P

UNIT = "count"
LAYER = "block runner (render.py)"
MOVES = "ms_per_iter"


def read(rec):
    return P.most(rec, lambda s: s.get("counters", {}).get(
        "render.rerendered_blocks"))
