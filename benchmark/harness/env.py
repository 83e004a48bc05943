"""The run's environment: cache directories, the process's start, the card,
and the look for JAX once the window has closed."""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# Build and kernel caches of the program, at fixed paths inside the
# checkout, so that only a cell's first run in a checkout builds.
CACHE_DIR = ROOT / ".bench_cache"
# Top-level module names that may not be loaded in a run, compared whole:
# the port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "smallvcm_tpu")


def set_cache_dirs(environ=os.environ) -> None:
    """Point the program's build and kernel caches into the checkout."""
    environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")


def process_start_epoch() -> float:
    """Wall-clock time at which this process started (Linux /proc)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22 of stat(5), after pid and comm
    for line in Path("/proc/stat").read_text().splitlines():
        if line.startswith("btime "):
            boot = int(line.split()[1])
            break
    else:
        raise RuntimeError("/proc/stat has no btime")
    return boot + start_ticks / os.sysconf("SC_CLK_TCK")


class ForbiddenModules(RuntimeError):
    """Modules of JAX or the JAX package were loaded in a process of the
    run (a rank's, which the main process cannot look into itself)."""

    def __init__(self, modules: list):
        super().__init__(", ".join(modules))
        self.modules = modules


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def check_cards(needed: int) -> None:
    """Raise unless CUDA is available with at least ``needed`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                         "false")
    if torch.cuda.device_count() < needed:
        raise SystemExit(f"the cell needs {needed} cards, "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")
