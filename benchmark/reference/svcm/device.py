"""Device selection for the port's entry points.

Entry points build and render on the card unless the caller asks for the
CPU. Asking for a CUDA device where there is none raises: the port never
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``name`` (str or torch.device) -> torch.device; a CUDA request
    without a card raises RuntimeError."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass "
            "--device cpu to render on the CPU)"
        )
    return dev
