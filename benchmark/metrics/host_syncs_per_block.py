"""Block runner: synchronising CUDA operations of one block
(``torch.cuda.set_sync_debug_mode("warn")``)."""

UNIT = "count"
LAYER = "block runner (render.py)"
MOVES = "ms_per_iter"


def read(rec):
    return rec.get("syncs_per_block")
