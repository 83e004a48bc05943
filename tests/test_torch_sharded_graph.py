"""The sharded iteration as one device program, on two gloo CPU ranks.

On an NCCL group every sharded iteration is one CUDA graph with its
collectives inside (``vcm.sharded_iteration_stage``, ``sharding.
simple_stage``), the counterpart of the JAX package's ``_vcm_program`` and
``_SIMPLE_PROGRAMS``. A CPU has neither NCCL nor CUDA graphs, so this file
holds the graph functions, run eagerly on two gloo ranks, against what the
card's graph must reproduce. The ranks are spawned once for the module
(``multihost.spawn``, a file:// rendezvous), in a thread, so that the JAX
package's sharded programs compile meanwhile; scene 1, 16x16, max path
length 4 (tests/test_torch_sharding.py's sizes). Checks:

1. ``render_block_with_stats(group=...)`` (a block of two iterations, each
   ``sharded_iteration_stage``) on each rank against the single process's
   block at the same caps: the image within rtol 1e-4 / atol 1e-6
   (test_torch_sharding.py's bound) and the same on both ranks, equal
   rays, no overflow; vcm with the all-gather and with the ring, ppm, lt
   and bpt, the cell merge and the pair merge ("xla").
2. A dispatch recorder (tests/test_torch_iteration_graph.py) finds no host
   read in either stage function; the c10d collectives it sees are not
   host reads.
3. ``make_fx`` traces the sharded iteration at iteration 2 (ppm with the
   ring and the cell merge, bpm with the all-gather and the pair merge)
   and ``simple_stage`` through ``sharded_simple_iteration`` (el, pt),
   with the plain cell merge and the four collectives as opaque ops, and
   the trace replays iterations 0, 1 and 3 bit for bit.
4. The sharded cell merge at caps: at caps that hold, the slot-count
   image bit for bit; at 0.05 both ranks overflow and the overflow is their
   sum; from 0.05 the block runner grows both ranks to the same factors by
   the JAX rule, and the image is the single process's at those caps
   within rtol 1e-4 / atol 1e-6 (test_torch_sharding.py's bound).
5. The pair merge's two-rank iteration against the JAX package's
   ``sharded_render_iteration_with_stats`` on two virtual CPU devices:
   overflow and stats equal as integers (caps that hold, both exchanges;
   caps that spill pairs, photons and queries at once), the image within
   test_torch_slice.py's bound.
6. The exchanges' ``.bytes`` counters after a stand-in capture and
   replays equal those of as many eager calls.

JAX is imported inside the test that uses it: the ranks import this module
and need only the port.
"""

from __future__ import annotations

import contextlib
import io
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from smallvcm_tpu_torch import graphs
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.ops import merge as M
from smallvcm_tpu_torch.parallel import comm, multihost, sharding
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

from .test_torch_graphs import FxGraphs, _assert_bitwise, _opaque_merge_cells
from .test_torch_iteration_graph import HostReadRecorder

RES = 16
N = RES * RES
MAXLEN = 4
RANKS = 2
SEED = 1234
CAPS = dict(pair_factor=64.0, photon_factor=4.0, query_factor=4.0)
# (algorithm, photon exchange, merge backend) of check 1.
STAGE_CASES = (("vcm", "allgather", "auto"), ("vcm", "ring", "auto"),
               ("vcm", "allgather", "xla"), ("vcm", "ring", "xla"),
               ("ppm", "allgather", "auto"), ("ppm", "ring", "xla"),
               ("lt", "allgather", "auto"), ("bpt", "allgather", "auto"))
HOST_READ_CASES = (("vcm", "allgather", "auto"), ("bpm", "ring", "auto"),
                   ("vcm", "ring", "xla"))
# ppm and bpm: the exchange and the merge with fewer operations to trace
# than vcm's (a trace takes ~16 s on one CPU core, vcm's ~23 s); the
# single process's vcm iteration is traced in
# tests/test_torch_iteration_graph.py.
FX_CASES = (("ppm", "ring", "auto"), ("bpm", "allgather", "xla"))
TRACED_AT = 2
REPLAYED_AT = (0, 1, 3)
TINY = 0.05
# Check 5: (what spills, exchange, resolution, pair, photon and query
# factors). At 32x32 a rank's ~1,340 candidate pairs pass the pair merge's
# 1,024-row floor, so pair factor 0.05 spills them; 0.5 spills photons and
# queries (and so leaves fewer pairs than the floor).
JAX_CASES = (("nothing", "ring", RES, 64.0, 4.0, 4.0),
             ("pairs", "allgather", 32, 0.05, 4.0, 4.0),
             ("photons+queries", "allgather", 32, 64.0, 0.5, 0.5))


def _scene(res=RES):
    return load_cornell_box((res, res), SCENE_CONFIGS[1], device="cpu")


def _flags(alg):
    use_vc, use_vm, lt_only, ppm = R._VCM_FLAGS[alg]
    return dict(use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only,
                ppm=ppm)


def _graph_block(scene, group, alg, exchange, backend, start, k, **caps):
    """``k`` iterations from ``start`` through the sharded graph function
    (eager on the CPU) -> (image sum, rays, overflow, stats max)."""
    return vcm.render_block_with_stats(
        scene, start, RES, RES, k, SEED, MAXLEN, 0, **_flags(alg),
        merge_backend=backend, group=group, vm_exchange=exchange,
        **{**CAPS, **caps})[:4]


def _own_share(scene, group, it, res, vm_exchange="allgather",
               merge_backend="auto", pair_factor=24.0, photon_factor=None,
               query_factor=None):
    """This rank's vcm iteration ``it`` before the sums over ranks
    (``vcm._iteration_body`` on its shard) -> (image, rays, overflow,
    stats)."""
    n = res * res
    scalars = [graphs._scalar(v, scene.device) for v in
               vcm.iteration_scalars(scene, it, n, 0.003, 0.75, True, True)]
    static = vcm.iteration_static(
        res, res, SEED, MAXLEN, 0, True, True, False, False, "threefry",
        photon_factor, query_factor, merge_backend, pair_factor)
    pix = comm.shard_ids(n, comm.world_size(group), comm.rank(group),
                         scene.device)
    return vcm._iteration_body(scene, pix, n, *scalars, *static,
                               vm_exchange, group)


# -- the collectives as opaque ops (check 3) -----------------------------------

_GROUP = []
_COMM = {name: getattr(comm, name) for name in (
    "all_gather_columns", "ring_shift", "framebuffer_sum", "all_reduce_sum")}


@torch.library.custom_op("svcm_test_shard::all_gather_columns",
                         mutates_args=())
def _all_gather_op(x: torch.Tensor) -> torch.Tensor:
    return _COMM["all_gather_columns"](x, _GROUP[0])


@_all_gather_op.register_fake
def _(x):
    w = comm.world_size(_GROUP[0])
    return x.new_empty((*x.shape[:-1], w * x.shape[-1]))


@torch.library.custom_op("svcm_test_shard::ring_shift", mutates_args=())
def _ring_shift_op(x: torch.Tensor) -> torch.Tensor:
    return _COMM["ring_shift"](x, _GROUP[0])


@torch.library.custom_op("svcm_test_shard::framebuffer_sum", mutates_args=())
def _framebuffer_sum_op(x: torch.Tensor) -> torch.Tensor:
    return _COMM["framebuffer_sum"](x, _GROUP[0])


@torch.library.custom_op("svcm_test_shard::all_reduce_sum", mutates_args=())
def _all_reduce_sum_op(x: torch.Tensor) -> torch.Tensor:
    return _COMM["all_reduce_sum"](x, _GROUP[0])


for _op in (_ring_shift_op, _framebuffer_sum_op, _all_reduce_sum_op):
    _op.register_fake(lambda x: torch.empty_like(x))

_OPAQUE_COMM = dict(
    all_gather_columns=lambda x, group=None: _all_gather_op(x),
    ring_shift=lambda x, group=None: _ring_shift_op(x),
    framebuffer_sum=lambda x, group=None: _framebuffer_sum_op(x),
    all_reduce_sum=lambda x, group=None: _all_reduce_sum_op(x))


class _C10dRecorder(HostReadRecorder):
    """HostReadRecorder that also lists the c10d operators it saw."""

    def __init__(self):
        super().__init__()
        self.c10d = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name.startswith("c10d::"):
            self.c10d.add(name)
        return super().__torch_dispatch__(func, types, args, kwargs)


# -- a stand-in capture (check 6) -----------------------------------------------


class _StandInGraph:
    """A CUDA graph that records nothing: a replay runs no operation, so
    only graphs.py's counter bookkeeping shows."""

    def replay(self):
        pass


@contextlib.contextmanager
def _stand_in_capture(graph, **kw):
    yield


def _bytes_through_graphs(scene, group, exchange, k):
    """``.bytes`` added by a block of ``k`` iterations through graphs.stage
    with a stand-in capture (warm-up eager, capture, k - 2 replays), and by
    the same block under ``graphs.eager()``."""
    counters = (comm.all_gather_columns, comm.ring_shift)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(graphs, "why_eager", lambda *a: None)
        mp.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        mp.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
        mp.setattr(torch.cuda, "graph", _stand_in_capture)
        before = [c.bytes for c in counters]
        stage = (graphs.stage.captures, graphs.stage.replays)
        _graph_block(scene, group, "vcm", exchange, "auto", 0, k)
        graphed = [c.bytes - b for c, b in zip(counters, before)]
        stage = (graphs.stage.captures - stage[0],
                 graphs.stage.replays - stage[1])
        static = vcm.sharded_static(vcm.iteration_static(
            RES, RES, SEED, MAXLEN, 0, True, True, False, False, "threefry",
            CAPS["photon_factor"], CAPS["query_factor"], "auto",
            CAPS["pair_factor"], 1), exchange, group)
        dropped = graphs.drop(vcm.sharded_iteration_stage, static)
    finally:
        mp.undo()
    before = [c.bytes for c in counters]
    with graphs.eager():
        _graph_block(scene, group, "vcm", exchange, "auto", 0, k)
    eager = [c.bytes - b for c, b in zip(counters, before)]
    return dict(graphed=graphed, eager=eager, stage=stage, dropped=dropped)


# -- the ranks' work -------------------------------------------------------------


def _fx_replays(run):
    """``run(iteration)`` eagerly, then through :class:`FxGraphs` with the
    plain cell merge and the collectives opaque: warm-up and trace at
    TRACED_AT, replays at REPLAYED_AT -> (eager outputs, replayed outputs,
    captures, replays)."""
    want = {it: run(it) for it in (TRACED_AT, *REPLAYED_AT)}
    fx = FxGraphs()
    # The iteration's view of comm, with the collectives opaque (the
    # collectives themselves still count their bytes in comm).
    opaque = types.SimpleNamespace(**{**vars(comm), **_OPAQUE_COMM})
    mp = pytest.MonkeyPatch()
    mp.setattr(graphs, "stage", fx.stage)
    mp.setattr(M, "merge_cells", _opaque_merge_cells)
    mp.setattr(vcm, "comm", opaque)
    mp.setattr(sharding, "comm", opaque)
    try:
        run(TRACED_AT)                       # warm-up: eager
        got = {it: run(it) for it in (TRACED_AT, *REPLAYED_AT)}
    finally:
        mp.undo()
    return want, got, fx.captures, fx.replays


def _grow_run(scene, group):
    """A block of two from cell-merge caps of TINY through the block
    runner."""
    cfg = R.RenderConfig(algorithm="vcm", resolution=(RES, RES),
                         max_path_length=MAXLEN, group=group,
                         photon_factor=TINY, query_factor=TINY)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        block = R._make_block_runner(scene, cfg, "vcm")(
            0, 2, torch.zeros((RES, RES, 3)))
    return dict(img=block.accum, stats=block.stats, caps=R._caps_of(cfg),
                out=out.getvalue())


def _rank_work():
    """Runs in every rank: every check's results."""
    torch.set_num_threads(1)
    group = multihost.global_group()
    w, rank = comm.world_size(group), comm.rank(group)
    scene = _scene()
    out = {}
    # 1. The sharded blocks, for the single process's to match.
    for case in STAGE_CASES:
        out["stage", case] = _graph_block(scene, group, *case, 1, 2)
    # 2. No host read.
    mp = pytest.MonkeyPatch()
    mp.setattr(M, "merge_cells", _opaque_merge_cells)
    try:
        for case in HOST_READ_CASES:
            rec = _C10dRecorder()
            with rec:
                _graph_block(scene, group, *case, 2, 1)
            out["reads", case] = (rec.reads, sorted(rec.c10d))
    finally:
        mp.undo()
    for alg in ("el", "pt"):
        rec = _C10dRecorder()
        with rec:
            sharding.simple_stage(scene, torch.tensor(2), alg, RES, RES,
                                  SEED, MAXLEN, 0, "threefry", w, rank, group)
        out["reads", alg] = (rec.reads, sorted(rec.c10d))
    # 3. make_fx: traced at one iteration, replayed at three others.
    _GROUP[:] = [group]
    for case in FX_CASES:
        out["fx", case] = _fx_replays(
            lambda it: _graph_block(scene, group, *case, it, 1))
    for alg in ("el", "pt"):
        out["simple", alg] = _fx_replays(
            lambda it: sharding.sharded_simple_iteration(
                group, alg, scene, it, RES, RES, SEED, MAXLEN))
    # 4. The cell merge at caps.
    for exchange in ("allgather", "ring"):
        slots = sharding.sharded_render_iteration_with_stats(
            group, scene, 1, RES, RES, SEED, MAXLEN, vm_exchange=exchange)
        capped = sharding.sharded_render_iteration_with_stats(
            group, scene, 1, RES, RES, SEED, MAXLEN, vm_exchange=exchange,
            photon_factor=CAPS["photon_factor"],
            query_factor=CAPS["query_factor"])
        local = _own_share(scene, group, 1, RES, exchange,
                           photon_factor=TINY, query_factor=TINY)[2]
        summed = sharding.sharded_render_iteration_with_stats(
            group, scene, 1, RES, RES, SEED, MAXLEN, vm_exchange=exchange,
            photon_factor=TINY, query_factor=TINY)[2]
        out["caps", exchange] = (slots, capped, int(local), int(summed))
    out["grow"] = _grow_run(scene, group)
    # 5. The pair merge's iteration, for the JAX package's to match.
    for name, exchange, res, pf, phf, qf in JAX_CASES:
        kw = dict(vm_exchange=exchange, merge_backend="xla", pair_factor=pf,
                  photon_factor=phf, query_factor=qf)
        sc = _scene(res)
        img, rays, ovf, stats = sharding.sharded_render_iteration_with_stats(
            group, sc, 0, res, res, SEED, MAXLEN, **kw)
        # This rank's own merge overflow and stats, before the sums.
        _, _, local_ovf, local_stats = _own_share(sc, group, 0, res, **kw)
        out["jax", name] = (img, int(rays), int(ovf), stats.tolist(),
                            int(local_ovf), local_stats.tolist())
    # 6. The exchanges' byte counters through a stand-in capture.
    for exchange in ("allgather", "ring"):
        out["bytes", exchange] = _bytes_through_graphs(scene, group,
                                                       exchange, 4)
    return out


@pytest.fixture(scope="module")
def ranks_job():
    """The two ranks, started in a thread: the JAX programs of check 5
    compile meanwhile."""
    pool = ThreadPoolExecutor(1)
    job = pool.submit(multihost.spawn, RANKS, "cpu", _rank_work)
    yield job
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(ranks_job):
    return ranks_job.result()


@pytest.fixture(scope="module")
def jax_runs(ranks_job):
    """The JAX package's two-device sharded iteration for every JAX case:
    (image, rays, overflow, stats)."""
    from smallvcm_tpu.parallel import sharding as jsharding
    from smallvcm_tpu.scene.scene import load_cornell_box as jload

    mesh = jsharding.make_mesh(RANKS)
    out = {}
    for name, exchange, res, pf, phf, qf in JAX_CASES:
        img, rays, ovf, stats = jsharding.sharded_render_iteration_with_stats(
            mesh, jload((res, res), SCENE_CONFIGS[1]), 0, res, res, SEED,
            MAXLEN, pair_factor=pf, photon_factor=phf, query_factor=qf,
            vm_exchange=exchange, merge_backend="xla")
        out[name] = (np.asarray(img), int(rays), int(ovf),
                     np.asarray(stats).tolist())
    return out


# -- 5. against the JAX package (first: its programs compile meanwhile) --------


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_pair_merge_iteration_matches_jax_sharded(jax_runs, ranks, case):
    from .test_torch_slice import assert_image_close

    name, exchange, res, _, phf, qf = case
    want_img, want_rays, want_ovf, want_stats = jax_runs[name]
    img, rays, ovf, stats, _, _ = ranks[0]["jax", name]
    assert ranks[1]["jax", name][1:4] == (rays, ovf, stats)
    assert (rays, ovf, stats) == (want_rays, want_ovf, want_stats)
    locals_ = [out["jax", name][4:] for out in ranks]
    assert ovf == sum(o for o, _ in locals_)
    n = res * res
    photon_cap = vcm._pad_mult(int(phf * n), 8)        # the gathered photons
    query_cap = vcm._pad_mult(int(qf * (n // RANKS)), 8)
    for local_ovf, (_, n_p, n_q) in locals_:
        # Which kind spills on each rank: photons and queries from the live
        # counts over their caps, pairs (and survivors) the rest.
        spill_p, spill_q = max(n_p - photon_cap, 0), max(n_q - query_cap, 0)
        rest = local_ovf - spill_p - spill_q
        assert (spill_p > 0, spill_q > 0, rest > 0) == {
            "nothing": (False, False, False), "pairs": (False, False, True),
            "photons+queries": (True, True, False)}[name]
    assert_image_close(img.numpy(), want_img)


# -- 1. the sharded block against the single process's ----------------------


@pytest.mark.parametrize("case", STAGE_CASES)
def test_sharded_stage_equals_stage_by_stage(ranks, case):
    """Each rank's sharded block against the single process's block at the
    same caps: only the order of the sums over ranks differs."""
    alg, _, backend = case
    want_img, want_rays, want_ovf, _ = vcm.render_block_with_stats(
        _scene(), 1, RES, RES, 2, SEED, MAXLEN, 0, **_flags(alg),
        merge_backend=backend, **CAPS)[:4]
    assert float(want_img.mean()) > 0.0 and int(want_ovf) == 0
    for out in ranks:
        img, rays, overflow, _ = out["stage", case]
        torch.testing.assert_close(img, want_img, rtol=1e-4, atol=1e-6)
        assert int(rays) == int(want_rays) and int(overflow) == 0
    img = ranks[0]["stage", case][0]
    assert torch.equal(img, ranks[1]["stage", case][0])
    merges = R._VCM_FLAGS[alg][1]
    assert (int(ranks[0]["stage", case][3][1]) > 0) == merges


@pytest.mark.parametrize("alg", ["el", "pt"])
def test_simple_stage_equals_stage_by_stage(ranks, alg):
    """``simple_stage`` through ``sharded_simple_iteration``, traced once
    with its sums opaque, replays other iterations bit for bit."""
    for out in ranks:
        want, got, captures, replays = out["simple", alg]
        assert captures == 1 and replays == len(got)
        for it in got:
            _assert_bitwise(got[it], want[it], (alg, it))
    assert float(ranks[0]["simple", alg][0][TRACED_AT][0].mean()) > 0.0


# -- 2. no host read ------------------------------------------------------------


@pytest.mark.parametrize("case", [*HOST_READ_CASES, "el", "pt"])
def test_sharded_stages_make_no_host_read(ranks, case):
    for out in ranks:
        reads, c10d = out["reads", case]
        assert reads == []
        assert any(name.startswith("c10d::allreduce") for name in c10d)


# -- 3. make_fx: traced once, replayed at other iterations ---------------------


@pytest.mark.parametrize("case", FX_CASES)
def test_sharded_iteration_replays_bit_for_bit(ranks, case):
    for out in ranks:
        want, got, captures, replays = out["fx", case]
        assert captures == 1 and replays == len(got)
        for it in got:
            _assert_bitwise(got[it], want[it], (case, it))


# -- 4. the sharded cell merge at caps -------------------------------------------


@pytest.mark.parametrize("exchange", ["allgather", "ring"])
def test_cell_merge_caps_under_a_group(ranks, exchange):
    slots, capped, local0, summed0 = ranks[0]["caps", exchange]
    _, _, local1, summed1 = ranks[1]["caps", exchange]
    # Caps that hold: the slot-count tables' image and counts, bit for bit.
    _assert_bitwise(capped, slots, exchange)
    assert int(capped[2]) == 0 and int(capped[3][1]) > 0
    # Caps of 0.05 spill on both ranks; every rank reads their sum.
    assert local0 > 0 and local1 > 0
    assert summed0 == summed1 == local0 + local1


def test_sharded_cell_merge_grows_alike_to_the_single_process(ranks,
                                                              capsys):
    first = ranks[0]["grow"]
    for run in (out["grow"] for out in ranks):
        assert run["caps"] == first["caps"] and run["stats"] == first["stats"]
        assert torch.equal(run["img"], first["img"])
    assert "merge cap overflow" in first["out"]    # only rank 0 prints
    # JAX's rule over a rank's paths, from the stats summed over the ranks.
    n_shard = N // RANKS
    _, n_p, n_q = first["stats"]
    assert first["caps"]["photon_factor"] == R._grow(TINY, n_p, n_shard)
    assert first["caps"]["query_factor"] == R._grow(TINY, n_q, n_shard)
    cfg = R.RenderConfig(algorithm="vcm", resolution=(RES, RES),
                         max_path_length=MAXLEN, merge_caps_frozen=True,
                         **first["caps"])
    single = R._make_block_runner(_scene(), cfg, "vcm")(
        0, 2, torch.zeros((RES, RES, 3)))
    assert "overflow" not in capsys.readouterr().out
    assert float(single.accum.mean()) > 0.0
    torch.testing.assert_close(first["img"], single.accum, rtol=1e-4,
                               atol=1e-6)


# -- 6. the exchanges' byte counters through capture and replays --------------


@pytest.mark.parametrize("exchange", ["allgather", "ring"])
def test_exchange_bytes_count_replays(ranks, exchange):
    table = 17 * (MAXLEN - 1) * (N // RANKS) * 4     # one rank's packed table
    for out in ranks:
        rec = out["bytes", exchange]
        assert rec["stage"] == (1, 3) and rec["dropped"] == 1
        assert rec["graphed"] == rec["eager"]
        want = [4 * table, 0] if exchange == "allgather" else [0, 4 * table]
        assert rec["eager"] == want
