"""What a driver is given (Context) and what it gives back (Outcome)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .spec import Cell


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"          # "cpu" only in the harness's own tests
    start_epoch: float = 0.0      # when the process started (setup_s)
    # "module:function" run after set-up and before the window: the
    # harness's tests plant a fault in the timed path with it.
    fault: str | None = None

    @property
    def base_seed(self) -> int:
        """The renderer's base seed: the counter-based RNG keys on 32 bits."""
        return self.seed & 0xFFFFFFFF

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclass
class Outcome:
    """A driver's run: ``record`` holds what the metric readers read
    (setup_s, window_s, iterations or steps, peak_bytes; in a traced run
    the profiled stretch and the counters), ``checks`` the numbers that
    decide ``correct``."""
    record: dict
    checks: list
    attempted: int
    failed: int
    device: dict = field(default_factory=dict)
    breakdown: dict | None = None
    # What the control needs to put the reference in the program's place
    # (benchmark/control.py): the checked answers' iterations and inputs.
    replay: dict | None = None
