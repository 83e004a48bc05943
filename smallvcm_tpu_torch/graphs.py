"""Each iteration as one device program: CUDA graphs.

The port's counterpart of the JAX package's compiled iteration and block
(``vcm.render_block_with_stats``, ``render.py::_simple_block`` and
``_make_block_runner``). On a card, :func:`stage` captures a stage
function once as a CUDA graph and replays it on every later call with the
same key, so a stage's thousands of small kernels cost one host launch.
The stages are:

- the whole iteration of the VCM family on one process
  (``algorithms/vcm.py::iteration_stage``: light walk, splat flush, camera
  stage, the cell merge or the pair merge at static caps, framebuffer
  sums), replayed k times for a block of k iterations
  (``vcm.render_block_with_stats``);
- the whole pass of pt and el (``pathtracer.render_pass``,
  ``eyelight.render_pass``), k replays a block;
- the whole iteration of the VCM family on a sharded rank of an NCCL
  group (``vcm.sharded_iteration_stage``: the same stages on the rank's
  paths, with the photon exchange, the merge at static caps and the sums
  over ranks inside the graph, the counterpart of the JAX package's
  ``_vcm_program``), and the whole pass of a sharded el or pt rank with
  its framebuffer sum (``parallel/sharding.py::simple_stage``);
- the light walk and the camera stage on their own
  (``vcm.light_walk``, ``camera_walk``) on sharded ranks of a gloo group,
  whose collectives stage through host memory and cannot be captured:
  the merge, the exchange, the splat flush and the framebuffer sums run
  eagerly between those two graphs.

What stays outside every graph: the sums over a block's iterations (a
few launches an iteration), the per-iteration scalars' fills, and the
block's one host read at its end (overflow, merge stats, rays and
luminance, ``render.py``).

A stage function is called as ``fn(scene, *tensors, *scalars, *static)``:

- ``tensors``: device tensors, or NamedTuples of them. A replay reads them
  from the graph's input buffers: the tensors of the capturing call,
  cloned, or, for the outputs of another graph (the light walk's vertices
  fed to the camera stage), those outputs themselves. A later call's
  tensors are copied into the buffers first, unless they are the buffers.
- ``scalars``: Python numbers that change between calls (the iteration,
  the radius, r^2, the vm normalization, the two MIS weights). Each
  reaches ``fn`` as a 0-dim device tensor (int -> int64, float ->
  float32), which a replay fills first. ``fn`` uses them only in device
  arithmetic: a Python number derived from one would be frozen into the
  capture.
- ``static``: hashable values of the key, frozen into the capture (the
  merge caps among them: grown caps are a new key, and :func:`drop`
  frees the old graph's memory pool).
- ``fn`` makes no host read (``.item()``, ``.tolist()``, ``nonzero``,
  boolean indexing) and no host-to-device copy, and launches on the
  current stream.

A replay returns the graph's output tensors, which the next replay of the
same graph overwrites: a caller that keeps one across calls clones it.

The key is (``fn``, the scene's tensors by identity and its host
metadata, the shapes, dtypes and devices of ``tensors``, the scalars'
types, ``static``, the device). A graph holds raw pointers to the scene's
memory, and the sweep kernels' scene block is copied into its kernel
nodes, so an entry goes when any of the scene's tensors dies (as
``ops/sweep.py::_BLOCKS`` does): ``diff.apply_params`` or the report do
not pin stale graphs.

The first call of a key runs ``fn`` eagerly: it builds the kernel
library, packs the scene block and lets CUDA load its modules. The second
captures (``torch.cuda.graph``, on its side stream) and replays; later
calls replay. Eager and replayed stages give the same bits, so which call
captured does not show in the image, and a one-iteration run never
captures.

Graphs apply on a CUDA device, outside :func:`eager`, whenever autograd
would record nothing. Under grad mode with a scene tensor or input that
requires grad (``diff.py``'s gradients, the sweep's autograd Function in
``ops/sweep.py``) the stage runs eagerly, always. There is no other way
back to eager launches on a card: a failed capture or replay raises.

The kernels' ``.launches`` counters (``ops/sweep.py``, ``ops/merge.py``,
the stage clocks' ``trace.stamp_kernel``) and the exchanges' ``.bytes``
counters (``parallel/comm.py``) are bumped in Python, which runs at
capture and not at replay. So a capture takes its increments back and
records them, and each replay adds them: the counters count launches and
bytes on the device, the merge's one a replay of the whole-iteration
graph. They and ``stage``'s own counters are reported to
``trace.summary()``. A key's first, eager call is the span
``graphs.warmup`` and its capture the span ``graphs.capture`` (trace.py),
whose seconds ``stage.capture_s`` sums. The stage functions stamp the
device's stage clocks while the block runner has them armed
(``trace.stamp``): which stamps a graph holds is part of its key.

The first call of a sharded key runs eagerly too, so its collectives
create the group's NCCL communicator before any capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils import _pytree as pytree

from . import trace
from .ops import merge as merge_ops
from .ops import sweep as sweep_ops
from .parallel import comm

_EAGER = 0


@contextlib.contextmanager
def eager():
    """Run every stage eagerly inside the block: the A/B reference of the
    graphs on a card (chip_smoke.py, the tests)."""
    global _EAGER
    _EAGER += 1
    try:
        yield
    finally:
        _EAGER -= 1


def _counters():
    """(name, holder, attribute) of each counter bumped in Python beside a
    device launch or transfer: the kernels' launches, the exchanges'
    bytes."""
    return (("sweep.closest_hit_launches", sweep_ops.sweep_kernel,
             "launches"),
            ("sweep.any_hit_launches", sweep_ops.occluded_kernel,
             "launches"),
            ("merge.launches", merge_ops.merge_cells_kernel, "launches"),
            ("comm.all_gather_bytes", comm.all_gather_columns, "bytes"),
            ("comm.ring_shift_bytes", comm.ring_shift, "bytes"),
            ("trace.stamp_launches", trace.stamp_kernel, "launches"))


def _read_counters() -> list:
    return [getattr(h, a) for _, h, a in _counters()]


def _add_counters(values) -> None:
    for (_, h, a), v in zip(_counters(), values):
        setattr(h, a, getattr(h, a) + v)


def _scene_leaves(scene):
    """-> (the scene's tensors, its other leaves) in field order."""
    tensors, meta = [], []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            tensors.append(obj)
        elif isinstance(obj, tuple):
            for v in obj:
                walk(v)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))
        else:
            meta.append(obj)

    walk(scene)
    return tensors, tuple(meta)


def why_eager(scene, tensors=()):
    """Why a stage of ``scene`` on ``tensors`` runs eagerly -> "autograd",
    "eager()" or "cpu"; None when it runs as a graph."""
    flat = [*_scene_leaves(scene)[0], *pytree.tree_leaves(tensors)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        return "autograd"
    if _EAGER:
        return "eager()"
    if scene.device.type != "cuda":
        return "cpu"
    return None


def _scalar(value, dev):
    dtype = torch.int64 if isinstance(value, int) else torch.float32
    return torch.full((), value, dtype=dtype, device=dev)


class _Graph:
    """A captured stage: the graph, its input and output tensors and the
    counters' increments (:func:`_counters`) one replay makes."""

    def __init__(self, graph, inputs, scalars, outputs, out_spec,
                 increments):
        self.graph = graph
        self.inputs = inputs
        self.scalars = scalars
        self.outputs = outputs
        self.out_spec = out_spec
        self.increments = increments

    def replay(self, flat_in, scalars):
        for buf, t in zip(self.inputs, flat_in):
            if t is not buf:
                buf.copy_(t)
        for buf, v in zip(self.scalars, scalars):
            buf.fill_(v)
        self.graph.replay()
        _add_counters(self.increments)
        stage.replays += 1
        return pytree.tree_unflatten(self.outputs, self.out_spec)


class _Entry:
    """One key's state: weak references to the scene's tensors, the
    finalizers that drop the entry when one dies, and the graph once
    captured (None after the warm-up call)."""

    def __init__(self, key, scene_tensors):
        self.refs = tuple(map(weakref.ref, scene_tensors))
        self.finalizers = [weakref.finalize(t, _scene_tensor_died, key)
                           for t in scene_tensors]
        self.graph = None

    def alive_for(self, scene_tensors) -> bool:
        return all(r() is t for r, t in zip(self.refs, scene_tensors))

    def drop(self):
        for f in self.finalizers:
            f.detach()


_ENTRIES: dict = {}
# A capture's gc.collect() may run a finalizer: keys whose scene lost a
# tensor meanwhile are dropped once the capture has ended.
_CAPTURING = False
_DEAD: list = []


def _drop(key):
    entry = _ENTRIES.pop(key, None)
    if entry is not None:
        entry.drop()


def _scene_tensor_died(key):
    if _CAPTURING:
        _DEAD.append(key)
    else:
        _drop(key)


def drop(fn, static: tuple) -> int:
    """Forget every captured or warmed-up stage of ``fn`` with these
    static values (its graph's private memory pool goes with it, once its
    outputs are no longer held) -> the number of entries dropped."""
    keys = [k for k in _ENTRIES if k[0] is fn and k[5] == static]
    for k in keys:
        _drop(k)
    return len(keys)


def drop_group(group) -> int:
    """Forget every stage whose static values hold ``group`` (the sharded
    graphs, which captured its collectives) -> the number dropped. A
    group's NCCL communicator must outlive the graphs that launch its
    kernels: see ``parallel/multihost.py::shutdown``."""
    keys = [k for k in _ENTRIES if any(v is group for v in k[5])]
    for k in keys:
        _drop(k)
    return len(keys)


def _owned(t) -> bool:
    """Is ``t`` an output tensor of a captured graph?"""
    return any(t is o for e in _ENTRIES.values() if e.graph is not None
               for o in e.graph.outputs)


def _capture(fn, scene, flat_in, in_spec, scalars, static, dev) -> _Graph:
    global _CAPTURING
    inputs = [t if _owned(t) else t.clone() for t in flat_in]
    bufs = [_scalar(v, dev) for v in scalars]
    before = _read_counters()
    graph = torch.cuda.CUDAGraph()
    _CAPTURING = True
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn(scene, *pytree.tree_unflatten(inputs, in_spec), *bufs,
                     *static)
        increments = [c - b for c, b in zip(_read_counters(), before)]
    finally:
        _CAPTURING = False
        _add_counters([b - c for c, b in zip(_read_counters(), before)])
        while _DEAD:
            _drop(_DEAD.pop())
    outputs, out_spec = pytree.tree_flatten(out)
    return _Graph(graph, inputs, bufs, outputs, out_spec, increments)


def stage(fn, scene, tensors: tuple, scalars: tuple, static: tuple):
    """``fn(scene, *tensors, *scalars, *static)``: eagerly, or as a CUDA
    graph replay (see the module docstring for the contract and the key).
    Counts captures, their host seconds and replays in ``stage.captures``,
    ``stage.capture_s`` and ``stage.replays``."""
    flat_in, in_spec = pytree.tree_flatten(tensors)
    dev = scene.device
    if why_eager(scene, flat_in) is not None:
        return fn(scene, *tensors, *(_scalar(v, dev) for v in scalars),
                  *static)
    geo, meta = _scene_leaves(scene)
    key = (fn, tuple(map(id, geo)), meta,
           tuple((t.shape, t.dtype, t.device) for t in flat_in),
           tuple(type(v) for v in scalars), static, dev, trace.stamping())
    entry = _ENTRIES.get(key)
    if entry is not None and not entry.alive_for(geo):
        _drop(key)
        entry = None
    name = getattr(fn, "__qualname__", repr(fn))
    if entry is None:
        _ENTRIES[key] = _Entry(key, geo)
        with trace.span("graphs.warmup", fn=name):
            return fn(scene, *tensors, *(_scalar(v, dev) for v in scalars),
                      *static)
    with torch.cuda.device(dev):
        if entry.graph is None:
            with trace.span("graphs.capture", fn=name) as s:
                entry.graph = _capture(fn, scene, flat_in, in_spec, scalars,
                                       static, dev)
            stage.captures += 1
            stage.capture_s += s.seconds
        return entry.graph.replay(flat_in, scalars)


stage.captures = 0
stage.capture_s = 0.0
stage.replays = 0


def _report() -> dict:
    return {**{name: getattr(h, a, 0) for name, h, a in _counters()},
            "graphs.captures": stage.captures,
            "graphs.replays": stage.replays,
            "graphs.capture_s": stage.capture_s}


trace.report_counters("graphs", _report)
