"""End to end: the most device memory allocated from the start of set-up
to the end of the window (``torch.cuda.max_memory_allocated``), the most
of any rank."""

UNIT = "GiB"
LAYER = None
MOVES = None


def read(rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2 ** 30
