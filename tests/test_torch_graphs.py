"""The graph stages (smallvcm_tpu_torch/graphs.py) on the CPU.

A CUDA graph freezes every Python value its stage computes at capture:
an RNG stream id, a MIS weight, a branch on the iteration. There is no
card here, so ``torch.fx.experimental.proxy_tensor.make_fx`` (real
tracing) stands in for the capture: like a CUDA graph it records the
device operations of one call and freezes every Python value it sees.
:class:`FxGraphs` plays ``graphs.stage``'s part with it (the first call of
a key eager, the second traced then replayed, later calls replayed), and
each stage of the slice (the VCM light walk and camera stage, each
staged on its own, pt's and el's pass) is traced at one iteration and
replayed at three others, bit for bit against the eager stage. It does not see host reads that only
set a shape (boolean indexing, ``nonzero``): capture on the card refuses
those (chip_smoke.py phase 16).

The whole VCM-family iteration (``vcm.iteration_stage``, the graph of a
block's every iteration on a card) is traced and replayed the same way
through render() here, and for vcm, ppm and lt in
tests/test_torch_iteration_graph.py. Its cell merge runs there as
``merge_cells_plain``, whose pair expansion reads the host (it is the CPU
stand-in for the kernel); the tests wrap it in an opaque custom op
(:func:`_opaque_merge_cells`), as the kernel is one opaque node of the
graph that reads its live count and scalars from device memory. With that
op, tracing refuses any other host read (``aten._local_scalar_dense``).

Also: the tensor-iteration RNG against the int form and the JAX
package's, the MIS-weight tensors against ``compute_misc``'s floats, and
when ``graphs.stage`` chooses eager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from smallvcm_tpu_torch import graphs
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import eyelight, pathtracer, vcm
from smallvcm_tpu_torch.core import rng as trng
from smallvcm_tpu_torch.ops import merge as M
from smallvcm_tpu_torch.ops import sweep as S
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

torch.set_num_threads(2)

RES = 8
N = RES * RES
MAX_PATH = 4
SEED = 1234
TRACED_AT = 2
REPLAYED_AT = (0, 1, 3)


class FxGraphs:
    """``graphs.stage`` with ``make_fx`` in place of CUDA-graph capture."""

    def __init__(self):
        self.traced = {}
        self.captures = 0
        self.replays = 0

    def stage(self, fn, scene, tensors, scalars, static):
        flat, spec = pytree.tree_flatten(tensors)
        bufs = [graphs._scalar(v, scene.device) for v in scalars]

        def call(*args):
            return fn(scene, *pytree.tree_unflatten(list(args[:len(flat)]),
                                                    spec),
                      *args[len(flat):], *static)

        key = (fn, static, tuple(t.shape for t in flat))
        if key not in self.traced:
            self.traced[key] = None
            return call(*flat, *bufs)
        if self.traced[key] is None:
            self.traced[key] = make_fx(call, tracing_mode="real")(*flat,
                                                                  *bufs)
            self.captures += 1
        self.replays += 1
        return self.traced[key](*flat, *bufs)


@torch.library.custom_op("svcm_test::merge_cells", mutates_args=())
def _merge_cells_op(qpos: torch.Tensor, qtab: torch.Tensor,
                    ranges: torch.Tensor, ppos: torch.Tensor,
                    ptab: torch.Tensor, r2: torch.Tensor,
                    vc_weight: torch.Tensor, n_live: torch.Tensor,
                    max_path_length: int, min_path_length: int,
                    ppm: bool) -> torch.Tensor:
    return M.merge_cells_plain(
        qpos, qtab, ranges, ppos, ptab, r2, vc_weight, n_live=n_live,
        max_path_length=max_path_length, min_path_length=min_path_length,
        ppm=ppm)


@_merge_cells_op.register_fake
def _(qpos, qtab, ranges, ppos, ptab, r2, vc_weight, n_live,
      max_path_length, min_path_length, ppm):
    return qtab.new_empty((3, qtab.shape[0]))


def _opaque_merge_cells(qpos, qtab, ranges, ppos, ptab, r2, vc_weight, *,
                        max_path_length, min_path_length, ppm,
                        n_live=None):
    """ops/merge.py::merge_cells as one opaque op, as the kernel is."""
    dev = qtab.device
    live = torch.full((), qtab.shape[0]) if n_live is None else n_live
    return _merge_cells_op(qpos, qtab, ranges, ppos, ptab,
                           M._dev_scalar(r2, dev),
                           M._dev_scalar(vc_weight, dev), live,
                           max_path_length, min_path_length, ppm)


@pytest.fixture(scope="module")
def scene():
    return load_cornell_box((RES, RES), SCENE_CONFIGS[0], device="cpu")


@pytest.fixture(scope="module")
def fx():
    return FxGraphs()


def _leaves(out):
    return pytree.tree_leaves(out)


def _assert_bitwise(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), (what, i)
        else:
            assert a == b, (what, i)


def _replays_equal_eager(fx, monkeypatch, run, what):
    """``run(iteration)`` eagerly, then through ``fx``: warm-up and trace
    at TRACED_AT, replays at REPLAYED_AT, each bit for bit."""
    want = {it: run(it) for it in (TRACED_AT, *REPLAYED_AT)}
    before = (fx.captures, fx.replays)
    with monkeypatch.context() as m:
        m.setattr(graphs, "stage", fx.stage)
        run(TRACED_AT)                       # warm-up: eager
        got = {it: run(it) for it in (TRACED_AT, *REPLAYED_AT)}
    assert fx.replays - before[1] >= len(got)
    assert fx.captures > before[0], f"{what}: nothing was traced"
    for it, out in got.items():
        _assert_bitwise(out, want[it], f"{what} at iteration {it}")


def _misc(scene, it):
    return vcm.compute_misc(scene, it, N, 0.003, 0.75, True, True)


def _walk_scalars(scene, it):
    """(the walks' scalars: the iteration and the two MIS weights, the
    light path count)."""
    m = _misc(scene, it)
    return (it, m.mis_vm_weight, m.mis_vc_weight), m.light_sub_path_count


def _light(scene, it):
    scalars, count = _walk_scalars(scene, it)
    return graphs.stage(vcm.light_walk, scene, (torch.arange(N),), scalars,
                        (count, RES, RES, SEED, MAX_PATH, 0, True, True,
                         False, "threefry"))


def test_light_walk_replays_bit_for_bit(scene, fx, monkeypatch):
    """The VCM light walk (vertices, camera splat rows, rays) through
    graphs.stage, traced at one iteration, at three others."""
    _replays_equal_eager(fx, monkeypatch, lambda it: _light(scene, it),
                         "light walk")


def test_camera_stage_replays_bit_for_bit(scene, fx, monkeypatch):
    """The VCM camera stage (colour, merge queries, rays) through
    graphs.stage on each iteration's own light vertices."""
    verts = {it: _light(scene, it)[0] for it in (TRACED_AT, *REPLAYED_AT)}

    def run(it):
        scalars, count = _walk_scalars(scene, it)
        return graphs.stage(vcm.camera_walk, scene,
                            (verts[it], torch.arange(N)), scalars,
                            (count, RES, SEED, MAX_PATH, 0, True, True,
                             False, "threefry"))

    _replays_equal_eager(fx, monkeypatch, run, "camera stage")


def test_pt_pass_replays_bit_for_bit(scene, fx, monkeypatch):
    def run(it):
        return pathtracer.render_core(scene, it, torch.arange(N), RES, RES,
                                      SEED, MAX_PATH)

    _replays_equal_eager(fx, monkeypatch, run, "pt")


def test_el_pass_replays_bit_for_bit(scene, fx, monkeypatch):
    """Traced at iteration 2, replayed at 1: the centre-sample branch is a
    select on the iteration tensor, not a Python branch."""
    def run(it):
        return eyelight.render_core(scene, it, torch.arange(N), RES, RES,
                                    SEED)

    _replays_equal_eager(fx, monkeypatch, run, "el")
    # Iteration 1 samples pixel centres: no jitter in the image's rays.
    img1, _ = run(1)
    img0, _ = run(0)
    assert not torch.equal(img0, img1)


def test_render_through_traced_stages_equals_eager(scene, fx, monkeypatch):
    """Four VCM iterations through render(), in two blocks of two, with
    each whole iteration (light walk, flush, camera stage, merge at static
    caps, sums) replayed from its trace: the image and rays are the eager
    ones, bit for bit."""
    cfg = R.RenderConfig(algorithm="vcm", iterations=4, resolution=(RES, RES),
                         max_path_length=MAX_PATH, block_size=2)
    want, _, _, want_rays = R.render(scene, cfg)
    before = fx.replays
    with monkeypatch.context() as m:
        m.setattr(graphs, "stage", fx.stage)
        m.setattr(M, "merge_cells", _opaque_merge_cells)
        got, _, _, rays = R.render(scene, cfg)
    assert fx.replays - before == 3          # iterations 1 (traced) to 3
    assert torch.equal(got, want) and rays == want_rays


@pytest.mark.parametrize("generator", ["threefry", "tea"])
@pytest.mark.parametrize("iteration,stage,bounce", [
    (0, trng.STAGE_CAMERA_JITTER, 0),
    (3, trng.STAGE_LIGHT_WALK, 7),
    (8388607, trng.STAGE_CAMERA_NEE, 63),
])
def test_tensor_iteration_rng_equals_int_and_jax(generator, iteration, stage,
                                                 bounce):
    # JAX is imported here: tests/test_torch_sharded_graph.py's ranks
    # import this module and need only the port.
    import jax.numpy as jnp

    from smallvcm_tpu.core import rng as jrng

    ids = np.random.default_rng(iteration % 97).integers(
        0, 2 ** 32, size=1024, dtype=np.uint64).astype(np.uint32)
    pid = torch.from_numpy(ids.astype(np.int64))
    it_t = torch.tensor(iteration, dtype=torch.int64)
    stream_t = trng.make_stream(it_t, stage, bounce)
    assert isinstance(stream_t, torch.Tensor) and stream_t.dim() == 0
    assert int(stream_t) == trng.make_stream(iteration, stage, bounce)
    from_tensor = trng.uniform_slots(SEED, stream_t, pid, 5, generator)
    from_int = trng.uniform_slots(
        SEED, trng.make_stream(iteration, stage, bounce), pid, 5, generator)
    want = np.asarray(jrng.uniform_slots(
        SEED, jrng.make_stream(jnp.asarray(iteration, jnp.int32), stage,
                               bounce), ids, 5, generator))
    assert torch.equal(from_tensor, from_int)
    np.testing.assert_array_equal(from_tensor.numpy(), want)


@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False)])
def test_mis_weight_tensors_equal_compute_misc(scene, flags):
    """The graphs' float32 scalar inputs hold compute_misc's floats
    exactly, and add and multiply as those floats do."""
    d = torch.from_numpy(np.random.default_rng(5).uniform(
        1e-3, 1e3, 4096).astype(np.float32))
    for it in range(6):
        misc = vcm.compute_misc(scene, it, N, 0.003, 0.75, *flags)
        for w in (misc.mis_vm_weight, misc.mis_vc_weight):
            t = graphs._scalar(w, scene.device)
            assert t.dtype == torch.float32 and t.dim() == 0
            assert float(t) == w
            assert torch.equal(d * t, d * w) and torch.equal(t + d, w + d)


def test_stage_chooses_eager_off_the_card(scene):
    """On the CPU every stage runs eagerly; under autograd with a scene
    leaf that requires grad it is eager on any device, and so is a stage
    whose static values hold a gloo group; graphs.eager() says so too."""
    assert graphs.why_eager(scene) == "cpu"
    with graphs.eager():
        assert graphs.why_eager(scene) == "eager()"
    assert graphs.why_eager(scene) == "cpu"
    leaf = scene.materials.ior.detach().requires_grad_(True)
    s = dataclasses.replace(scene, materials=scene.materials._replace(
        ior=leaf))
    assert graphs.why_eager(s) == "autograd"
    with torch.no_grad():
        assert graphs.why_eager(s) == "cpu"
    t = torch.zeros(3, requires_grad=True)
    assert graphs.why_eager(scene, (t,)) == "autograd"
    # A gloo group's collectives stage through host memory: a sharded
    # stage of one runs eagerly on any device.
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        assert graphs.why_eager(scene, (), ("k", 1, group)) == "gloo"
        assert graphs.why_eager(scene, (), ("k", 1, None)) == "cpu"
        with graphs.eager():
            assert graphs.why_eager(scene, (), (group,)) == "eager()"
    finally:
        dist.destroy_process_group()
    # The eager path runs the stage function with 0-dim scalar tensors.
    seen = []
    counts = (graphs.stage.captures, graphs.stage.replays)
    graphs.stage(lambda sc, p, it, w, k: seen.append((it, w, k)), scene,
                 (torch.arange(2),), (5, 0.25), ("k",))
    (it, w, k), = seen
    assert it.dtype == torch.int64 and int(it) == 5 and it.dim() == 0
    assert w.dtype == torch.float32 and float(w) == 0.25 and k == "k"
    assert (graphs.stage.captures, graphs.stage.replays) == counts


def test_stage_cache_warms_captures_replays_and_drops(monkeypatch):
    """graphs.stage's own bookkeeping, with a stand-in capture (the real
    one needs a card): the first call of a key runs eagerly, the second
    captures, later ones replay with their tensors copied into the input
    buffers and their scalars filled; a replay adds the captured kernel
    launches; the entry goes when a tensor of its scene dies."""
    scene = load_cornell_box((4, 4), SCENE_CONFIGS[0], device="cpu")
    calls = []

    def fn(sc, pix, it, w, k):
        calls.append(int(it))
        S.sweep_kernel.launches += 2          # as if it launched twice
        return pix * it + w, (pix + k,)

    def capture(fn, sc, flat_in, in_spec, scalars, static, dev):
        inputs = [t.clone() for t in flat_in]
        bufs = [graphs._scalar(v, dev) for v in scalars]
        ref = weakref.ref(sc)      # a graph holds no reference to its scene
        run = lambda: pytree.tree_leaves(fn(
            ref(), *pytree.tree_unflatten(inputs, in_spec), *bufs, *static))
        outputs = run()

        class Replayed:
            def replay(self):
                for o, n in zip(outputs, run()):
                    o.copy_(n)

        spec = pytree.tree_flatten(fn(sc, *inputs, *bufs, *static))[1]
        return graphs._Graph(Replayed(), inputs, bufs, outputs, spec,
                             [2, 0, 0])

    monkeypatch.setattr(graphs, "why_eager", lambda *a: None)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    before = len(graphs._ENTRIES)
    pix = torch.arange(4)
    out0 = graphs.stage(fn, scene, (pix,), (1, 0.5), (10,))
    assert calls == [1] and len(graphs._ENTRIES) == before + 1
    launches = S.sweep_kernel.launches
    out1 = graphs.stage(fn, scene, (pix,), (2, 0.25), (10,))
    assert torch.equal(out1[0], pix * 2 + 0.25) and torch.equal(out0[0],
                                                                pix + 0.5)
    got = graphs.stage(fn, scene, (pix + 1,), (3, 0.0), (10,))
    assert torch.equal(got[0], (pix + 1) * 3) and got[1][0] is out1[1][0]
    assert S.sweep_kernel.launches > launches
    other = graphs.stage(fn, scene, (pix,), (3, 0.0), (11,))  # new key
    assert torch.equal(other[1][0], pix + 11)
    assert len(graphs._ENTRIES) == before + 2
    del scene, out0, out1, got, other
    gc.collect()
    assert len(graphs._ENTRIES) == before
