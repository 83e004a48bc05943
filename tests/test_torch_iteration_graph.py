"""The whole VCM-family iteration as one graph (``vcm.iteration_stage``), on
the CPU.

``make_fx`` stands in for CUDA-graph capture (tests/test_torch_graphs.py's
:class:`FxGraphs`): each iteration of vcm, ppm and lt, traced at one
iteration, replays bit for bit at three others, with the plain cell merge
as one opaque op (the kernel's place in the graph), so no per-iteration
value (radius, r^2, vm normalization, MIS weights, RNG streams) is frozen
and tracing refuses any host read outside the merge op. A dispatch
recorder then refuses ``item``, ``nonzero``, ``masked_select`` and
boolean indexing anywhere in the iteration: the merge's live counts and
the splat flush's sentinel rows stay on the device.

The pair merge (``merge_backend="xla"``, at static caps) needs no opaque
op: its iteration is traced and replayed whole, and the recorder sees no
host read in it either.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.ops import merge as M
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

from .test_torch_graphs import (MAX_PATH, RES, SEED, FxGraphs, _misc,
                                _opaque_merge_cells, _replays_equal_eager)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return load_cornell_box((RES, RES), SCENE_CONFIGS[0], device="cpu")


@pytest.fixture(scope="module")
def fx():
    return FxGraphs()


class HostReadRecorder(TorchDispatchMode):
    """Records the operators that read device data on the host to size or
    steer work: a capture on the card refuses them."""

    HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
                  "aten::masked_select", "aten::item")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        # aten::index / index_put(_): a boolean mask among the indices.
        bool_index = name.startswith("aten::index") and len(args) > 1 \
            and isinstance(args[1], (list, tuple)) and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool
                for t in args[1])
        if name in self.HOST_READS or bool_index:
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def _block(scene, alg, it, **kw):
    """One block of one iteration of ``alg`` at caps the merge cannot
    overflow -> (image, rays, overflow, stats)."""
    use_vc, use_vm, lt_only, ppm = R._VCM_FLAGS[alg]
    return vcm.render_block_with_stats(
        scene, it, RES, RES, 1, SEED, MAX_PATH, 0, use_vc=use_vc,
        use_vm=use_vm, light_trace_only=lt_only, ppm=ppm, photon_factor=9.0,
        query_factor=9.0, pair_factor=64.0, **kw)[:4]


@pytest.mark.parametrize("alg", ["vcm", "ppm", "lt"])
def test_iteration_stage_replays_bit_for_bit(scene, fx, monkeypatch, alg):
    """The whole iteration, traced at one iteration, replayed at three
    others: no per-iteration value (radius, r^2, vm normalization, MIS
    weights, RNG streams) is frozen, and nothing reads the host outside
    the opaque merge op (tracing would refuse it)."""
    monkeypatch.setattr(M, "merge_cells", _opaque_merge_cells)
    _replays_equal_eager(fx, monkeypatch, lambda it: _block(scene, alg, it),
                         f"{alg} iteration")
    _, _, overflow, stats = _block(scene, alg, 1)
    assert int(overflow) == 0
    assert (int(stats[1]) > 0) == (alg != "lt")


@pytest.mark.parametrize("alg", ["vcm", "bpm"])
def test_iteration_stage_makes_no_host_read(scene, monkeypatch, alg):
    """The whole iteration's operators, recorded: no item, nonzero,
    masked_select or boolean index (the merge's and the splat flush's
    live counts stay on the device)."""
    monkeypatch.setattr(M, "merge_cells", _opaque_merge_cells)
    _misc(scene, 2)        # the scene radius's one read, kept per tensor
    rec = HostReadRecorder()
    with rec:
        _block(scene, alg, 2)
    assert rec.reads == []


@pytest.mark.parametrize("alg,chunks", [("vcm", 1), ("bpm", 2)])
def test_pair_merge_iteration_replays_bit_for_bit(scene, fx, monkeypatch,
                                                 alg, chunks):
    """The whole iteration with the pair merge at static caps, traced at
    one iteration and replayed at three others, with nothing opaque: the
    merge makes no host read for tracing to refuse."""
    run = lambda it: _block(scene, alg, it, merge_backend="xla",
                            merge_chunks=chunks, radius_factor=0.05)
    _replays_equal_eager(fx, monkeypatch, run, f"{alg} xla iteration")
    _, _, overflow, stats = run(1)
    assert int(overflow) == 0 and int(stats[0]) > 0


@pytest.mark.parametrize("photon_factor", [9.0, 0.05])
def test_pair_merge_iteration_makes_no_host_read(scene, photon_factor):
    """No item, nonzero, masked_select or boolean index in the iteration
    with the pair merge, whether its caps hold or overflow."""
    _misc(scene, 2)
    rec = HostReadRecorder()
    with rec:
        _, _, overflow, _, _ = vcm.render_block_with_stats(
            scene, 2, RES, RES, 1, SEED, MAX_PATH, 0, radius_factor=0.05,
            photon_factor=photon_factor, query_factor=9.0,
            pair_factor=64.0, merge_backend="xla")
    assert rec.reads == []
    assert (int(overflow) > 0) == (photon_factor < 1.0)
