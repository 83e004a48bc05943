"""End to end: the window's wall time over the iterations it completed (one
iteration = one sample per pixel of the whole image)."""

UNIT = "ms"
LAYER = None
MOVES = None


def read(rec):
    if not rec.get("iterations"):
        return None
    return 1e3 * rec["window_s"] / rec["iterations"]
