"""The port's trace: its counters, host spans and the device's stage clocks.

One module holds what a run can say about itself, and :func:`summary`
gives it as a plain dict: the benchmark's readers (``benchmark/metrics``),
``cli -v`` and, for a spawned job, the caller of
``parallel/multihost.spawn``, which keeps each rank's summary
(:func:`keep_ranks`).

**Counters** (:func:`report_counters`): plain numbers kept as attributes
where the work happens, which the module that owns them reports here
under the names the summary gives them:

- graphs.py: the kernels' ``.launches`` (``ops/sweep.py``,
  ``ops/merge.py``: the walk's ``merge.launches`` and the preparation's
  ``merge.prep_launches``, ``core/rng.py``, :func:`stamp_kernel`) and the
  exchanges' ``.bytes``
  (``parallel/comm.py``), bumped in Python beside a device launch or
  transfer, which a CUDA graph's replay does not run (graphs.py takes a
  capture's increments back and adds them at each replay, so they count
  work on the device); and ``graphs.stage.captures``, ``.replays`` and
  ``.capture_s`` (the sum of the ``graphs.capture`` spans);
- render.py: ``render.render.rerendered_blocks``, each block rendered
  again after a merge cap overflow;
- algorithms/vcm.py: ``vcm.pair_surv_rows``, the survivor rows the last
  pair merge built shades (a static size);
- ops/merge.py: ``merge.photon_rows``, the photon rows the last cell
  merge's preparation sorted (its photon tables' slots, every rank's
  after the sharded all-gather; a static size);
- diff.py: ``diff.steps`` and ``diff.step_replays``, the gradient steps
  taken and those that were a graph's replay, and
  ``diff.truncated_steps``, the steps whose pair merge truncated at its
  caps, counted on the device (read here, when the summary is taken).

**Spans** (:class:`span`): a name, the start and end in ns on the host's
wall clock (``time.time_ns``, the clock of the torch profiler's host
events), the span open when it began (its parent) and the id of the
outermost span open (``call``: the spans of one ``render()`` call share
it), and the keywords given. They go in a ring of the last
:data:`SPAN_RING`, and each name keeps its count, total and recent
durations; a span whose ``how`` keyword says how it went keeps them under
``name.how`` too (``render.caps_measure.measured``). While a torch
profiler runs a span is also a host operation of its name in the
profiler's trace (``_RecordFunctionFast``: a ``cpu_op``, so the host
timeline shows it; ``record_function``'s user
annotations would each add a device-side event spanning the GPU work
under it, which a trace's kernel counts and busy time would take for
kernels). The port's spans: ``render.caps_measure``, ``graphs.capture``
and ``cuda.library_load``, which the benchmark's set-up metrics read;
``render.block``, ``cli -v``'s block time; and ``render.render``,
``render.host_read`` and ``graphs.warmup``, which with the others name
the device's idle gaps (the summary's ``idle``).

**Stage clocks** (:func:`stamp`): while the block runner renders a block on
a card (:func:`block`), each stage of an iteration ends with a stamp: a
one-thread kernel (``csrc/trace_stamp.cu``) that writes the device's
``%globaltimer`` into row ``iteration mod ROWS`` of a small float64 ring on
the card, in the stage's slot (:data:`STAGES`; the bounces of the walks in
:data:`BOUNCES`, each with its live lanes; a stage may carry a count too:
the cell merge's ``merge_prep`` its live photons and ``merge_kernel`` its
candidate pairs, the pair merge's ``pair_expand`` its candidate pairs and
``pair_shade`` its survivors). A gradient step (``diff.loss_and_grad``)
stamps ``start``, then :data:`GRAD_STAGES` alone: ``grad_forward`` at
the loss and ``grad_backward`` at the gradients, the checkpoint's
recomputation inside it; its caller arms the clock (:func:`block`). The
``start`` stamp reads the iteration from device memory (a graph's 0-dim
input buffer) and leaves the row for the stamps after it, so a replay
stamps its own row. Stamps are
captured into the iteration's graph (whether a graph stamps is part of its
key, graphs.py) and write nothing but the ring, so images do not change.
The block's rows ride in the block's one host read (render.py). A
stage's time is its stamp less the stamp before it in time; the gaps
between one iteration's last stamp and the next one's first are the
device's time outside the iteration graphs, each named by the innermost
span open on the host when it began: the device's clock is fitted to the
host's once a device at its first block, and again whenever the summary
is taken, and a time between the two fits maps onto the host's clock by
the line through them (the summary's ``clocks`` give the drift between
them). :func:`enable` turns the stamps off for graphs captured after
it.

Nothing runs in the background and nothing is written to disk: a span or
a counter costs its own few instructions, and the summary's arithmetic
and its fresh reading of each device's clock run when it is asked for.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import numpy as np
import torch

# Spans kept (the ring), and durations kept a name for its median.
SPAN_RING = 4096
DURATIONS_KEPT = 1024
# Rows of the stage clocks' ring: a block's iterations beyond the last
# ROWS are not kept (the port's largest automatic block is 64).
ROWS = 64
# Bounces of a walk with a stamp each (longer paths stamp their first).
MAX_BOUNCES = 32
# Iterations recorded a device, oldest dropped first.
ROWS_KEPT = 4096
STAGES = ("start", "light_walk", "splat_flush", "camera_walk", "exchange",
          "merge_prep", "merge_kernel", "pair_tables", "pair_expand",
          "pair_shade", "ring", "finish", "grad_forward", "grad_backward")
# The stamps of a gradient step (diff.py): its forward to the loss, then
# the backward with the checkpoint's recomputation. The step holds back
# every other stamp, which the recomputation would stamp a second time.
GRAD_STAGES = ("grad_forward", "grad_backward")
# The stages of a merge: the cell merge's (ops/merge.py) or the pair
# merge's (algorithms/vcm.py::merge_stage); the summary's ``merge`` sums
# those an iteration stamped.
MERGE_STAGES = ("merge_prep", "merge_kernel", "pair_tables", "pair_expand",
                "pair_shade")
BOUNCES = ("light.sample", *(f"light.b{i}" for i in range(MAX_BOUNCES)),
           "camera.sample", *(f"camera.b{i}" for i in range(MAX_BOUNCES)))
_CALIBRATION = "calibration"
SLOT_NAMES = (*STAGES, *BOUNCES, _CALIBRATION)
SLOTS = len(SLOT_NAMES)
_SLOT = {name: i for i, name in enumerate(SLOT_NAMES)}
OUTSIDE = "outside render()"
# A profiler host operation of a given name, without a device-side event.
_HostOp = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_device_clocks = True
_spans: collections.deque = collections.deque(maxlen=SPAN_RING)
_totals: dict = {}
_local = threading.local()
_ids = itertools.count(1)
_clocks: dict = {}
_armed = None
_held = frozenset()
_ranks: list = []


def enable(device: bool = True) -> None:
    """Turn the device's stage clocks on (the default) or off. Graphs
    captured while they are off hold no stamp; a graph's key holds the
    setting, so the next block after a change captures anew."""
    global _device_clocks
    _device_clocks = bool(device)


def reset() -> None:
    """Forget the spans, their totals, the recorded iterations and the
    ranks' summaries (not the counters, nor the clocks' calibration)."""
    _spans.clear()
    _totals.clear()
    _ranks.clear()
    for clock in _clocks.values():
        clock.blocks.clear()
        clock.kept = 0


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------


_reporters: dict = {}


def report_counters(owner: str, read) -> None:
    """Have :func:`summary` give ``read()``'s {name: value} under
    ``counters``: each module reports its own (graphs.py, render.py) once,
    at import, under its ``owner`` name."""
    _reporters[owner] = read


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span(contextlib.ContextDecorator):
    """``with span(name, **attrs) as s:`` records one span (see the module
    docstring); ``s.seconds`` is its length once it has ended and
    ``s.attrs`` may be added to before. Also a decorator."""

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.t0 = self.t1 = None

    def _recreate_cm(self):
        return span(self.name, **self.attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.call = self.id if parent is None else parent.call
        self._rf = None
        if torch.autograd._profiler_enabled() and _HostOp is not None:
            self._rf = _HostOp(self.name)
            self._rf.__enter__()
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _spans.append(self)
        ns = self.t1 - self.t0
        how = self.attrs.get("how")
        for name in (self.name, *(() if how is None else
                                  (f"{self.name}.{how}",))):
            total = _totals.get(name)
            if total is None:
                total = _totals[name] = [0, 0, collections.deque(
                    maxlen=DURATIONS_KEPT)]
            total[0] += 1
            total[1] += ns
            total[2].append(ns)
        return False

    @property
    def seconds(self) -> float:
        end = time.time_ns() if self.t1 is None else self.t1
        return (end - self.t0) / 1e9


def spans() -> list:
    """The ring's spans, oldest first, as dicts (name, start_ns, end_ns,
    id, parent, call, attrs)."""
    return [dict(name=s.name, start_ns=s.t0, end_ns=s.t1, id=s.id,
                 parent=s.parent, call=s.call, attrs=dict(s.attrs))
            for s in _spans]


def _span_totals() -> dict:
    return {name: dict(count=c, total_s=t / 1e9,
                       median_s=float(np.median(d)) / 1e9)
            for name, (c, t, d) in _totals.items()}


# ---------------------------------------------------------------------------
# Stage clocks
# ---------------------------------------------------------------------------


def stamp_kernel(times, lanes, row, iteration, count, base: int,
                 slot: int) -> None:
    """Launch csrc/trace_stamp.cu: ``times[r, slot] = %globaltimer - base``
    and ``lanes[r, slot] = count`` (-1 without one), both float64 [ROWS,
    SLOTS], where ``r`` is ``iteration mod ROWS`` (which it also writes to
    ``row``, int64) or, without an iteration, ``row``'s. ``iteration`` and
    ``count`` are 0-dim int64 device tensors or None; the kernel reads them
    from device memory, so a graph's replay takes their values."""
    from .ops import _cuda

    req = _cuda.require
    dev = times.device
    req(dev.type == "cuda", "stamp_kernel needs CUDA tensors")
    req(times.shape == (ROWS, SLOTS) and lanes.shape == (ROWS, SLOTS),
        "stamp_kernel: a [ROWS, SLOTS] ring")
    req(0 <= slot < SLOTS, "stamp_kernel: slot out of range")
    req(times.dtype == lanes.dtype == torch.float64,
        "stamp_kernel: a float64 ring")
    for t in (times, lanes, row, iteration, count):
        if t is not None:
            req(t.device == dev and t.is_contiguous(),
                "stamp_kernel: contiguous tensors on one device")
    for t in (row, iteration, count):
        if t is not None:
            req(t.dtype == torch.int64, "stamp_kernel: int64 counters")
    for t in (iteration, count, row):
        if t is not None:
            req(t.numel() == 1, "stamp_kernel: one value")
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _cuda.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.svcm_trace_stamp(ptr(times), ptr(lanes), ptr(row),
                                  ptr(iteration), ptr(count), int(base),
                                  ROWS, SLOTS, slot, stream)
    _cuda.check(status, "svcm_trace_stamp")
    stamp_kernel.launches += 1


# Launches on the device, replays included (graphs.py).
stamp_kernel.launches = 0


class _Clock:
    """One device's ring of stamps and what was read of it: ``ring``
    [2, ROWS, SLOTS] float64, the times (ns since ``base``, the device's
    clock at the first fit) then the lanes; ``row`` the current row;
    ``host0`` the host's ns at the first fit; ``last`` the latest refit
    (device ns since ``base``, host ns) or None; ``blocks`` the recorded
    blocks (first iteration, times [n, SLOTS] and lanes [n, SLOTS] int64),
    oldest first."""

    def __init__(self, dev: torch.device):
        self.device = dev
        self.ring = torch.zeros((2, ROWS, SLOTS), dtype=torch.float64,
                                device=dev)
        self.ring[1] = -1
        self.row = torch.zeros((), dtype=torch.int64, device=dev)
        self.blocks: collections.deque = collections.deque()
        self.start = self.k = self.kept = self.base = 0
        self.base, self.host0 = self.fit()
        self.last = None

    def launch(self, slot: int, iteration=None, count=None) -> None:
        if iteration is not None and not isinstance(iteration, torch.Tensor):
            iteration = torch.full((), int(iteration), dtype=torch.int64,
                                   device=self.device)
        stamp_kernel(self.ring[0], self.ring[1], self.row, iteration, count,
                     self.base, slot)

    def fit(self) -> tuple:
        """Both clocks at one moment: one stamp after a synchronize,
        bracketed by host reads of the span clock -> (device ns since
        ``base``, host ns)."""
        torch.cuda.synchronize(self.device)
        h0 = time.time_ns()
        self.launch(_SLOT[_CALIBRATION], 0)
        torch.cuda.synchronize(self.device)
        h1 = time.time_ns()
        base = int(self.ring[0, 0, _SLOT[_CALIBRATION]])
        self.ring[0, 0, _SLOT[_CALIBRATION]] = 0     # not a stamp
        return base, (h0 + h1) // 2

    def refit(self) -> None:
        """Read both clocks again (:func:`summary`): device times between
        the first fit and this one map onto the host's clock by the line
        through the two."""
        self.last = self.fit()

    def to_host(self, ns: int) -> int:
        """Host ns of ``ns`` device ns since ``base``."""
        if self.last is None or self.last[0] <= 0:
            return self.host0 + ns
        return self.host0 + round(ns * (self.last[1] - self.host0)
                                  / self.last[0])

    def drift(self) -> dict:
        """How far the device's clock ran ahead of the host's between the
        two fits, in parts per million of the host's time, and over how
        many host seconds."""
        device_ns, host_ns = self.last
        over = host_ns - self.host0
        return dict(drift_ppm=(device_ns - over) / over * 1e6 if over else
                    0.0, over_s=over / 1e9)

    def rows(self) -> torch.Tensor:
        """The whole ring, flat: a view that joins the block's one host
        read with no kernel of its own."""
        return self.ring.view(-1)

    def record(self, values) -> None:
        """Keep the current block's rows (its last ROWS iterations) of the
        ring as read back (:meth:`rows`)."""
        n = min(self.k, ROWS)
        first = self.start + self.k - n
        ring = np.asarray(values, dtype=np.float64).reshape(2, ROWS, SLOTS)
        rows = ring[:, np.arange(first, first + n) % ROWS].astype(np.int64)
        self.blocks.append((first, rows[0], rows[1]))
        self.kept += n
        while self.kept > ROWS_KEPT:
            self.kept -= len(self.blocks.popleft()[1])


def _clock_for(dev: torch.device):
    """The device's clock (made, and fitted, at its first use on a card),
    or None on the CPU unless one was set there."""
    key = (dev.type, dev.index)
    if key not in _clocks and dev.type == "cuda":
        _clocks[key] = _Clock(dev)
    return _clocks.get(key)


@contextlib.contextmanager
def block(dev: torch.device, start: int, k: int):
    """Arm the stamps of ``dev``'s clock for the block of ``k`` iterations
    from ``start`` (render.py) -> yields the clock, whose ``rows()`` join
    the block's host read and whose ``record()`` keeps them; yields None
    where the clocks are off or the device has none."""
    global _armed
    clock = _clock_for(dev) if _device_clocks else None
    if clock is None:
        yield None
        return
    clock.start, clock.k = start, k
    _armed = clock
    try:
        yield clock
    finally:
        _armed = None


@contextlib.contextmanager
def paused(*names):
    """No stamps inside, or, given ``names``, none of those: the ring
    exchange's hops, whose merges would each overwrite the merge's slots,
    and a sharded pass whose caller stamps its ``finish`` after the sums
    over ranks."""
    global _armed, _held
    saved = _armed, _held
    if names:
        _held = _held | frozenset(names)
    else:
        _armed = None
    try:
        yield
    finally:
        _armed, _held = saved


def stamping():
    """Which stamps launch now, part of a graph's key: None outside an
    armed block, else the names held back (:func:`paused`)."""
    return None if _armed is None else _held


def stamp(name: str, iteration=None, count=None) -> None:
    """End of stage or bounce ``name`` on the armed device (a no-op
    outside a block, and for a bounce past MAX_BOUNCES). ``iteration`` (a
    0-dim int64 device tensor or an int) starts the iteration's row;
    ``count`` (0-dim int64) is a bounce's live lanes or what a stage
    counts."""
    clock = _armed
    slot = _SLOT.get(name)
    if clock is None or slot is None or name in _held:
        return
    clock.launch(slot, iteration, count)


# ---------------------------------------------------------------------------
# Summary
# ---------------------------------------------------------------------------


def _iterations(blocks):
    """Each iteration of recorded ``blocks`` in order, as (start, end,
    {stage: ns}, {bounce: (ns, lanes)}, new_block, {stage: count}) with
    start and end in ns since the fit, the counts of the stages whose
    stamp carried one; rows whose start is not after the previous row's
    end (never stamped, or left from an earlier iteration) are skipped."""
    stage_slots = np.arange(len(STAGES))
    prev_end = 0
    for _, times, lanes in blocks:
        new_block = True
        for t, n in zip(times, lanes):
            start = t[0]
            if start <= prev_end:
                continue
            valid = t >= start
            st = stage_slots[valid[:len(STAGES)]]
            order = st[np.argsort(t[st], kind="stable")]
            stages = {STAGES[s]: int(t[s] - t[p])
                      for p, s in zip(order, order[1:])}
            counts = {STAGES[s]: int(n[s]) for s in order[1:] if n[s] >= 0}
            every = np.nonzero(valid[:-1])[0]
            every = every[np.argsort(t[every], kind="stable")]
            bounces = {SLOT_NAMES[s]: (int(t[s] - t[p]), int(n[s]))
                       for p, s in zip(every, every[1:])
                       if s >= len(STAGES)}
            end = int(t[order[-1]])
            yield int(start), end, stages, bounces, new_block, counts
            new_block = False
            prev_end = end


def _stats(ns) -> dict:
    ms = np.asarray(ns, dtype=np.float64) / 1e6
    return dict(median_ms=float(np.median(ms)), min_ms=float(ms.min()),
                max_ms=float(ms.max()), iterations=int(ms.size))


def _stats_with(ns_by_name: dict, extra: dict, key: str) -> dict:
    """:func:`_stats` of each name's ns, with the median of its ``extra``
    values under ``key`` where it has any."""
    out = {}
    for name, ns in ns_by_name.items():
        out[name] = _stats(ns)
        if name in extra:
            out[name][key] = float(np.median(extra[name]))
    return out


def _name_gaps(gaps) -> dict:
    """{span name: seconds} of host-clock gaps [(start ns, length ns)],
    each named by the innermost span open at its start."""
    out = {}
    if not gaps:
        return out
    t0 = np.array([s.t0 for s in _spans], dtype=np.int64)
    t1 = np.array([s.t1 for s in _spans], dtype=np.int64)
    names = [s.name for s in _spans]
    for at, length in gaps:
        open_ = np.nonzero((t0 <= at) & (t1 > at))[0]
        name = names[open_[np.argmax(t0[open_])]] if open_.size else OUTSIDE
        out[name] = out.get(name, 0.0) + length / 1e9
    return out


def _clock_summary(clocks) -> dict:
    stages, bounces, lanes, counts = {}, {}, {}, {}
    shares, gaps = [], []
    for clock in clocks:
        prev = None             # the last iteration's end, this device
        block_from = idle = None
        for start, end, st, bo, new_block, co in _iterations(
                clock.blocks):
            if new_block:
                if block_from is not None and prev > block_from:
                    shares.append(idle / (prev - block_from))
                block_from, idle = (start if prev is None else prev), 0
            if prev is not None:
                idle += start - prev
                gaps.append((clock.to_host(prev), start - prev))
            prev = end
            merge = [st[s] for s in MERGE_STAGES if s in st]
            for name, ns in (*st.items(), ("iteration", end - start),
                             *((("merge", sum(merge)),) if merge else ())):
                stages.setdefault(name, []).append(ns)
            for name, c in co.items():
                counts.setdefault(name, []).append(c)
            for name, (ns, live) in bo.items():
                bounces.setdefault(name, []).append(ns)
                if live >= 0:
                    lanes.setdefault(name, []).append(live)
        if block_from is not None and prev > block_from:
            shares.append(idle / (prev - block_from))
    return dict(
        stages=_stats_with(stages, counts, "count"),
        bounces=_stats_with(bounces, lanes, "lanes"),
        idle=dict(share_median=float(np.median(shares)) if shares else None,
                  blocks=len(shares), gaps_s=_name_gaps(gaps)))


def block_stages(dev: torch.device) -> dict:
    """{stage: median ms} over the last recorded block of ``dev``'s clock
    (``render(verbose=True)``'s line); {} without one."""
    clock = _clocks.get((dev.type, dev.index))
    if clock is None or not clock.blocks:
        return {}
    st = {}
    for _, _, stages, _, _, _ in _iterations([clock.blocks[-1]]):
        for name, ns in stages.items():
            st.setdefault(name, []).append(ns)
    return {name: float(np.median(ns)) / 1e6 for name, ns in st.items()}


def keep_ranks(summaries: list) -> None:
    """Keep a spawned job's ranks' summaries, in rank order
    (``multihost.spawn``): :func:`summary`'s ``ranks``."""
    _ranks[:] = list(summaries)


def summary() -> dict:
    """What the trace holds, as a plain dict:

    - ``counters``: {name: value}, as the modules report them
      (:func:`report_counters`);
    - ``spans``: {name: {count, total_s, median_s}}, also under
      ``name.how`` for a span with a ``how``;
    - ``stages`` and ``bounces``: {name: {median_ms, min_ms, max_ms,
      iterations}} of device ms an iteration, over every recorded
      iteration (a bounce also with the median of its live ``lanes``, a
      stage whose stamp carried a count with the median ``count``); the
      stages add ``iteration`` (first to last stamp) and ``merge`` (the
      sum of the iteration's :data:`MERGE_STAGES`: the cell merge's
      preparation plus kernel, or the pair merge's tables, expansion and
      shading);
    - ``idle``: ``share_median``, the median over blocks of the device's
      share outside the iteration graphs (gaps between an iteration's
      last stamp and the next one's first, the gap before a block's first
      iteration included, over the time from the previous block's end to
      this one's), the number of ``blocks`` it was taken over, and
      ``gaps_s``: those gaps' seconds by the span open when each began
      (``"outside render()"`` where none was);
    - ``clocks``: {device: {drift_ppm, over_s}}, how far each device's
      clock ran ahead of the host's since its first fit (read again now,
      :meth:`_Clock.refit`);
    - ``ranks``: the kept ranks' summaries (:func:`keep_ranks`), else [].
    """
    counts = {}
    for read in _reporters.values():
        counts.update(read())
    out = dict(counters=counts, spans=_span_totals())
    for clock in _clocks.values():
        clock.refit()
    out.update(_clock_summary(list(_clocks.values())))
    out["clocks"] = {str(clock.device): clock.drift()
                     for clock in _clocks.values()}
    out["ranks"] = list(_ranks)
    return out
