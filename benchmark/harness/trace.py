"""Reductions of the measurements a traced run takes: the profiler's
events, CUDA events around graph replays, and host syncs.

The profiler's raw events are read without building its event tree
(``kineto_results``): a profiled block of VCM has ~3 x 10^5 kernels."""

from __future__ import annotations

import contextlib
import warnings

import numpy as np

# Device events that copy or fill rather than compute (a CUDA graph runs a
# device-to-device copy node as a kernel named memcpy*).
COPY_EVENTS = ("Memcpy", "Memset", "memcpy", "memset")
# Host calls that launch work: a kernel each, or a whole graph.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cuGraphLaunch")
TOP = 10


def raw_events(prof) -> tuple:
    """(device events, host events) of a finished torch.profiler session,
    each a list of (name, start_ns, end_ns)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (dev if e.device_type() == DeviceType.CUDA else host).append(row)
    return dev, host


def _union(intervals) -> list:
    """Disjoint sorted cover of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(dev, host, wall_s: float, iterations: int) -> dict:
    """One profiled stretch -> counts and times: device kernels (copies
    and fills excluded), host launch calls, device seconds by kernel name,
    the union of device activity (``busy_s``), the stretch's host wall
    seconds (``window_s``), and the idle gaps between device activity,
    named by the host operation running when each began."""
    kernels = [e for e in dev if not e[0].startswith(COPY_EVENTS)]
    by_name = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0) + (b - a)
    cover = _union((a, b) for _, a, b in dev)
    busy_ns = sum(b - a for a, b in cover)
    gaps = [(cover[i][1], cover[i + 1][0] - cover[i][1])
            for i in range(len(cover) - 1) if cover[i + 1][0] > cover[i][1]]
    return dict(
        iterations=iterations,
        kernels=len(kernels),
        launch_calls=sum(1 for e in host if e[0].startswith(LAUNCH_CALLS)),
        device_s_by_name={k: v / 1e9 for k, v in by_name.items()},
        busy_s=busy_ns / 1e9,
        span_s=(cover[-1][1] - cover[0][0]) / 1e9 if cover else 0.0,
        window_s=wall_s,
        idle_gaps=_name_gaps(gaps, host),
    )


def _name_gaps(gaps, host) -> list:
    """[(host operation, seconds)] of the longest gaps, summed by name:
    each gap goes to the innermost host event open at its start."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: -g[1])[:200]
    starts = np.array([e[1] for e in host], dtype=np.int64)
    ends = np.array([e[2] for e in host], dtype=np.int64)
    total = {}
    for t, dur in gaps:
        open_ = np.nonzero((starts <= t) & (ends > t))[0]
        name = (host[open_[np.argmax(starts[open_])]][0] if open_.size
                else "host between operations")
        total[name] = total.get(name, 0) + dur
    return sorted(((k, v / 1e9) for k, v in total.items()),
                  key=lambda kv: -kv[1])[:TOP]


def device_ops(summary: dict) -> list:
    """The TOP device operations by time, [[name, seconds]]."""
    rows = sorted(summary["device_s_by_name"].items(), key=lambda kv: -kv[1])
    return [[name[:160], s] for name, s in rows[:TOP]]


def kernel_seconds(summary: dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds any of ``needles``."""
    return sum(s for name, s in summary["device_s_by_name"].items()
               if any(n in name for n in needles))


def profiled(torch, fn):
    """Run ``fn()`` under torch.profiler (host and device) -> (its result,
    device events, host events, host wall seconds)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # "Profiler clears events at the end of each cycle": one cycle here.
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    dev, host = raw_events(prof)
    return out, dev, host, wall


def count_syncs(torch, fn) -> int:
    """Synchronising CUDA operations ``fn()`` makes
    (``torch.cuda.set_sync_debug_mode("warn")`` warns at each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


@contextlib.contextmanager
def replay_spans(torch, graphs, spans: list):
    """CUDA events around every replay of the port's iteration graphs
    (``graphs._Graph.replay``), appended to ``spans`` as (start, end).
    Yields False, and records nothing, where the port has no such
    method."""
    cls = getattr(graphs, "_Graph", None)
    replay = getattr(cls, "replay", None)
    if replay is None:
        yield False
        return

    def timed(self, *args):
        ends = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        ends[0].record()
        out = replay(self, *args)
        ends[1].record()
        spans.append(ends)
        return out

    cls.replay = timed
    try:
        yield True
    finally:
        cls.replay = replay


def replay_idle_share(spans) -> float | None:
    """One minus the device time inside the replays over the device time
    from the first replay's start to the last one's end (synchronised
    events; on one stream the replays' spans are disjoint)."""
    if len(spans) < 2:
        return None
    inside = sum(a.elapsed_time(b) for a, b in spans)
    span = spans[0][0].elapsed_time(spans[-1][1])
    return 1.0 - inside / span if span > 0 else None


def block_gaps_ms(ends: list) -> list:
    """Milliseconds between consecutive block ends (host clock)."""
    return [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
