"""Sweep: the least time for a profiled block's useful rays (render()'s own
ray count, roofline/sweep.py) over the device time of its intersect_sweep
and occluded_sweep kernels (summed over ranks)."""

from benchmark.harness.trace import kernel_seconds
from benchmark.roofline import sweep

UNIT = "%"
LAYER = "sweep (ops/sweep.py, csrc/intersect_sweep.cu)"
MOVES = "ms_per_iter"


def read(rec):
    it = rec.get("profile")
    if it is None or not rec.get("profiled_rays"):
        return None
    device_s = kernel_seconds(it, "intersect_sweep_kernel",
                              "occluded_sweep_kernel")
    return sweep.roofline_pct(rec["profiled_rays"], device_s)
