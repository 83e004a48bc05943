"""What the port says of itself: its trace (``smallvcm_tpu_torch.trace``),
read in the benchmark's main process once the driver has returned.

The one-card drivers run the port in that process; on four cards the
port's launcher (``parallel/multihost.spawn``) brings each rank's summary
back into it (``summary()["ranks"]``). A reader takes a rank's value, the
most of any rank, and finds nothing outside a traced run on a card (the
record has no profiled block) or where the port keeps no trace (a port
without the module gives None, and the line leaves the metric out)."""

from __future__ import annotations

import sys


def summaries(rec: dict) -> list | None:
    """The summaries of the processes that rendered, or None."""
    if "profile" not in rec:
        return None
    trace = sys.modules.get("smallvcm_tpu_torch.trace")
    summary = getattr(trace, "summary", None)
    if summary is None:
        return None
    s = summary()
    return s.get("ranks") or [s]


def most(rec: dict, value) -> float | None:
    """The most of ``value(summary)`` over the rendering processes, those
    that give None left out; None where none gives one."""
    found = summaries(rec)
    if found is None:
        return None
    values = [v for v in map(value, found) if v is not None]
    return max(values) if values else None


def stage_ms(name: str):
    """-> summary's median device ms an iteration of stage ``name``."""
    return lambda s: s.get("stages", {}).get(name, {}).get("median_ms")


def span_s(name: str):
    """-> summary's total seconds of the spans named ``name``."""
    return lambda s: s.get("spans", {}).get(name, {}).get("total_s")
