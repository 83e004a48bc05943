"""End to end: from the process's start to the start of the window."""

UNIT = "s"
LAYER = None
MOVES = None


def read(rec):
    return rec.get("setup_s")
