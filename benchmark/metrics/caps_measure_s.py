"""Block runner: seconds in the merge caps' measurement, the port's
render.caps_measure spans that measured (trace.py: render.caps_measure.
measured): the measuring iteration from the run's seed, in set-up, and
not the window's reads of the cached caps; the most of any rank (sharded
runs and pt measure nothing)."""

from benchmark.harness import program_trace as P

UNIT = "s"
LAYER = "block runner (render.py)"
MOVES = "setup_s"


def read(rec):
    return P.most(rec, P.span_s("render.caps_measure.measured"))
