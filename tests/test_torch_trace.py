"""The port's trace (smallvcm_tpu_torch/trace.py): counters, spans, the
device's stage clocks and the benchmark's readers of them.

On the CPU the stage clocks run on a stand-in clock (host ns in place of
``%globaltimer``, written where the stamp kernel would write), so the
stamps' placement, the block's read and the summary's arithmetic run
here; the card's own tests (marked ``cuda``) check the kernel's stamps.
The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_trace.py
"""

import contextlib
import sys
import time

import pytest
import torch

from benchmark.harness import spec
from smallvcm_tpu_torch import graphs, trace
from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.ops import sweep as S
from smallvcm_tpu_torch.parallel import comm, multihost
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

torch.set_num_threads(2)

RES = 8
NEW_METRICS = ("stage_ms.light_walk", "stage_ms.camera_walk",
               "stage_ms.merge", "stage_ms.exchange", "idle_share.replays",
               "caps_measure_s", "graph_capture_s", "library_load_s",
               "rerendered_blocks")


class HostClock(trace._Clock):
    """The stage clock on the CPU: a stamp writes the host's ns (the span
    clock, so the fit is exact) where the kernel writes the device's."""

    def launch(self, slot, iteration=None, count=None):
        if iteration is not None:
            self.row.fill_(int(iteration) % trace.ROWS)
        r = int(self.row)
        self.ring[0, r, slot] = time.time_ns() - self.base
        self.ring[1, r, slot] = -1 if count is None else int(count)

    def fit(self):
        now = time.time_ns()
        return now - self.base, now


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    """A trace of the test's own, with its merge caps in a cache of its
    own and the device clocks on."""
    monkeypatch.setenv("SMALLVCM_TPU_TORCH_CACHE", str(tmp_path / "caps"))
    trace.reset()
    trace.enable(device=True)
    yield
    trace.enable(device=True)
    trace.reset()


@pytest.fixture
def cpu_clock(monkeypatch):
    clock = HostClock(torch.device("cpu"))
    monkeypatch.setitem(trace._clocks, ("cpu", None), clock)
    return clock


def _scene():
    return load_cornell_box((RES, RES), SCENE_CONFIGS[0], device="cpu")


def _render(alg, iterations=2, block=2, **kw):
    cfg = R.RenderConfig(algorithm=alg, iterations=iterations,
                         resolution=(RES, RES), max_path_length=4,
                         block_size=block, **kw)
    return R.render(_scene(), cfg)


def _spans(name):
    return [s for s in trace.spans() if s["name"] == name]


def test_spans_nest_and_carry_their_parent_and_call_id():
    with trace.span("outer", what=1) as outer:
        with trace.span("inner") as inner:
            pass
        with trace.span("inner") as again:
            again.attrs["late"] = True
    with trace.span("alone") as alone:
        pass

    @trace.span("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    got = {s["id"]: s for s in trace.spans()}
    assert got[inner.id]["parent"] == outer.id
    assert got[inner.id]["call"] == got[again.id]["call"] == outer.id
    assert got[outer.id]["parent"] is None and got[outer.id]["call"] == \
        outer.id
    assert got[alone.id]["call"] == alone.id != outer.id
    assert got[again.id]["attrs"] == {"late": True}
    assert got[outer.id]["attrs"] == {"what": 1}
    s = got[outer.id]
    assert s["start_ns"] <= got[inner.id]["start_ns"] <= got[inner.id][
        "end_ns"] <= got[again.id]["start_ns"] <= s["end_ns"]
    totals = trace.summary()["spans"]
    assert totals["inner"]["count"] == 2 and totals["decorated"]["count"] \
        == 2
    assert totals["outer"]["total_s"] == pytest.approx(outer.seconds)
    # A render's spans share the id of its render.render span.
    _render("pt", iterations=1, block=1)
    call = _spans("render.render")[0]["id"]
    for name in ("render.block", "render.host_read", "graphs.warmup"):
        assert all(s["call"] == call for s in _spans(name)), name


def test_spans_show_in_the_profiler_as_host_operations_only():
    """Under torch.profiler a span is a host operation of its name, not a
    user annotation, which would add a device-side event of its own."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer.op"):
            with trace.span("inner.op"):
                torch.ones(3).add_(1)
    got = {e.name(): e for e in prof.profiler.kineto_results.events()
           if e.name() in ("outer.op", "inner.op")}
    assert set(got) == {"outer.op", "inner.op"}
    for e in got.values():
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()
    assert got["outer.op"].start_ns() <= got["inner.op"].start_ns()
    assert trace.summary()["spans"]["inner.op"]["count"] == 1


def test_rerendered_blocks_count_the_overflow_retry(capsys):
    before = trace.summary()["counters"]
    _render("vcm", photon_factor=0.05, query_factor=0.05,
            merge_caps_frozen=True)
    out = capsys.readouterr().out
    after = trace.summary()["counters"]
    assert out.count("merge cap overflow; re-rendering block") == 1
    assert after["render.rerendered_blocks"] == \
        before["render.rerendered_blocks"] + 1
    # The block was read twice: once overflowing, once again.
    assert len(_spans("render.host_read")) == 2


def test_caps_measure_span_measured_once_then_cached():
    scene = _scene()
    for want in ("measured", "cached"):
        cfg = R.RenderConfig(algorithm="vcm", resolution=(RES, RES),
                             max_path_length=4)
        assert R._ensure_merge_caps(scene, cfg, "vcm") == want
        assert R._ensure_merge_caps(scene, cfg, "vcm") == "frozen"
    caps = [s["attrs"]["how"] for s in _spans("render.caps_measure")]
    assert caps == ["measured", "cached"]
    totals = trace.summary()["spans"]
    assert totals["render.caps_measure"]["count"] == 2
    assert totals["render.caps_measure.measured"]["count"] == 1
    assert totals["render.caps_measure.cached"]["count"] == 1
    assert totals["render.caps_measure"]["total_s"] == pytest.approx(
        totals["render.caps_measure.measured"]["total_s"]
        + totals["render.caps_measure.cached"]["total_s"])


class _StandInGraph:
    def replay(self):
        pass


@contextlib.contextmanager
def _stand_in_capture(graph, **kw):
    yield


def test_capture_and_replay_bookkeeping_of_the_counters(monkeypatch):
    """With a stand-in capture: each call of a stage adds its launches and
    bytes once, whether it ran eagerly, captured or replayed; captures,
    replays and the capture spans count alike."""
    monkeypatch.setattr(graphs, "why_eager", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    scene = _scene()

    def fn(sc, pix, it, k):
        S.sweep_kernel.launches += 2
        comm.ring_shift.bytes += 8
        return pix * it + k

    stage = graphs.stage
    before = (S.sweep_kernel.launches, comm.ring_shift.bytes,
              stage.captures, stage.replays, stage.capture_s)
    for it in range(4):
        out = graphs.stage(fn, scene, (torch.arange(3),), (it,), (5,))
    assert torch.equal(out, torch.arange(3) * 1 + 5)  # the capture's bits
    assert S.sweep_kernel.launches == before[0] + 8
    assert comm.ring_shift.bytes == before[1] + 32
    assert (stage.captures, stage.replays) == (before[2] + 1, before[3] + 3)
    name = fn.__qualname__
    capture, = _spans("graphs.capture")
    warmup, = _spans("graphs.warmup")
    assert capture["attrs"] == warmup["attrs"] == {"fn": name}
    assert stage.capture_s - before[4] == pytest.approx(
        (capture["end_ns"] - capture["start_ns"]) / 1e9)
    assert graphs.drop(fn, (5,)) == 1


def test_device_clocks_off_capture_a_new_key(monkeypatch, cpu_clock):
    """Whether a graph stamps is part of its key: an armed block captures
    its own graph, and with the clocks off the same stage is a new key."""
    monkeypatch.setattr(graphs, "why_eager", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    scene, dev = _scene(), torch.device("cpu")

    def fn(sc, pix, it):
        trace.stamp("start", it)
        return pix + it

    def calls(n):
        for it in range(n):
            with trace.block(dev, it, 1):
                graphs.stage(fn, scene, (torch.arange(3),), (it,), ())

    captures = graphs.stage.captures
    calls(3)
    assert graphs.stage.captures == captures + 1
    trace.enable(device=False)
    calls(3)
    assert graphs.stage.captures == captures + 2
    assert graphs.drop(fn, ()) == 2


@pytest.mark.parametrize("alg", ["vcm", "pt"])
def test_images_equal_bit_for_bit_with_the_clocks_off(alg, cpu_clock):
    on, _, _, rays_on = _render(alg, iterations=3)
    assert cpu_clock.blocks
    trace.enable(device=False)
    off, _, _, rays_off = _render(alg, iterations=3)
    assert torch.equal(on, off) and rays_on == rays_off


def test_stage_clocks_on_the_stand_in_clock(cpu_clock, capsys):
    """The stamps of a VCM and a pt block: every stage and bounce, each
    iteration's stages summing to its first-to-last time, live lanes that
    fall with the bounces, idle gaps named by spans, and the per-block
    line of ``render(verbose=True)``."""
    img, _, done, _ = R.render(_scene(), R.RenderConfig(
        algorithm="vcm", iterations=4, resolution=(RES, RES),
        max_path_length=4, block_size=2), verbose=True)
    out = capsys.readouterr().out
    assert out.count("stage_ms: light_walk=") == 2 and "merge_kernel=" in out
    s = trace.summary()
    assert {"light_walk", "splat_flush", "camera_walk", "merge_prep",
            "merge_kernel", "finish", "iteration", "merge"} <= set(
                s["stages"])
    assert "exchange" not in s["stages"] and "ring" not in s["stages"]
    assert all(v["iterations"] == 4 for v in s["stages"].values())
    assert {"light.sample", "light.b0", "light.b2", "camera.sample",
            "camera.b0", "camera.b3"} <= set(s["bounces"])
    assert s["bounces"]["light.b0"]["lanes"] == RES * RES
    assert s["bounces"]["camera.b0"]["lanes"] == RES * RES
    assert s["bounces"]["camera.b3"]["lanes"] < RES * RES
    assert "lanes" not in s["bounces"]["camera.sample"]
    # start, light sample, 3 light bounces, light walk, splat flush, camera
    # sample, 4 camera bounces, camera walk, merge preparation and kernel,
    # finish.
    for _, times, _ in cpu_clock.blocks:
        for t in times:
            assert (t >= t[0]).sum() == 16
    for start, end, stages, _, _ in trace._iterations(cpu_clock.blocks):
        assert sum(stages.values()) == end - start
    assert s["idle"]["blocks"] == 2 and 0 <= s["idle"]["share_median"] < 1
    assert set(s["idle"]["gaps_s"]) <= {"render.host_read", "render.block",
                                        "render.render", "render.caps_"
                                        "measure", trace.OUTSIDE}

    trace.reset()
    R.render(_scene(), R.RenderConfig(algorithm="pt", iterations=2,
                                      resolution=(RES, RES),
                                      max_path_length=4, block_size=2))
    s = trace.summary()
    assert set(s["stages"]) == {"camera_walk", "finish", "iteration"}
    assert {f"camera.b{i}" for i in range(4)} | {"camera.sample"} == set(
        s["bounces"])


def test_a_larger_block_keeps_its_last_rows(cpu_clock):
    _render("el", iterations=trace.ROWS + 6, block=trace.ROWS + 6)
    first, times, _ = cpu_clock.blocks[-1]
    assert first == 6 and len(times) == trace.ROWS
    assert trace.summary()["stages"]["iteration"]["iterations"] == \
        trace.ROWS


def test_summary_has_its_documented_shape(cpu_clock):
    _render("vcm")
    s = trace.summary()
    assert set(s) == {"counters", "spans", "stages", "bounces", "idle",
                      "clocks", "ranks"}
    assert {"sweep.closest_hit_launches", "sweep.any_hit_launches",
            "merge.launches", "comm.all_gather_bytes",
            "comm.ring_shift_bytes", "trace.stamp_launches",
            "graphs.captures", "graphs.replays", "graphs.capture_s",
            "render.rerendered_blocks"} == set(s["counters"])
    assert s["counters"]["comm.all_gather_bytes"] == \
        comm.all_gather_columns.bytes
    assert s["counters"]["graphs.replays"] == graphs.stage.replays
    assert set(s["spans"]["render.render"]) == {"count", "total_s",
                                                "median_s"}
    for group in ("stages", "bounces"):
        for v in s[group].values():
            assert {"median_ms", "min_ms", "max_ms", "iterations"} <= set(v)
            assert v["min_ms"] <= v["median_ms"] <= v["max_ms"]
    assert set(s["idle"]) == {"share_median", "blocks", "gaps_s"}
    assert set(s["clocks"]) == {"cpu"}
    assert set(s["clocks"]["cpu"]) == {"drift_ppm", "over_s"}
    assert s["ranks"] == []


def test_paused_holds_back_the_named_stamps(cpu_clock):
    """``paused(*names)`` drops just those stamps and is part of a graph's
    key; ``paused()`` drops every one."""
    slot = trace._SLOT
    with trace.block(torch.device("cpu"), 0, 1):
        assert trace.stamping() == frozenset()
        trace.stamp("start", 0)
        with trace.paused("finish"):
            assert trace.stamping() == frozenset({"finish"})
            trace.stamp("finish")
            trace.stamp("camera_walk")
        assert cpu_clock.ring[0, 0, slot["finish"]] == 0
        assert cpu_clock.ring[0, 0, slot["camera_walk"]] > 0
        with trace.paused():
            assert trace.stamping() is None
            trace.stamp("merge_prep")
        assert cpu_clock.ring[0, 0, slot["merge_prep"]] == 0
        trace.stamp("finish")
        assert cpu_clock.ring[0, 0, slot["finish"]] > 0
    assert trace.stamping() is None


def test_device_times_map_onto_the_host_by_the_two_fits(cpu_clock):
    """Gaps are placed on the host's clock by the line through the first
    fit and the latest one; the drift is the device's lead over it."""
    clock = cpu_clock
    assert clock.to_host(5_000) == clock.host0 + 5_000   # one fit only
    clock.last = (2_000_000, clock.host0 + 1_000_000)    # twice as fast
    assert clock.to_host(1_000_000) == clock.host0 + 500_000
    assert clock.drift() == {"drift_ppm": 1e6, "over_s": 1e-3}
    clock.last = (1_000_000, clock.host0 + 1_000_000)
    assert clock.drift()["drift_ppm"] == 0
    trace.summary()                        # refits on the stand-in clock
    assert clock.last[1] - clock.host0 == clock.last[0]


def test_trace_imports_nothing_above_it():
    """The lowest layers import trace.py, so it imports none of the port
    but the kernels' library loader, and that inside the stamp's launch."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(trace))
    top = {n.module for n in tree.body if isinstance(n, ast.ImportFrom)}
    assert all(not m or not m.startswith(".") for m in top - {"__future__"})
    inner = [(n.level, n.module, [a.name for a in n.names])
             for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and n.level]
    assert inner == [(1, "ops", ["_cuda"])]


class CountingClock(HostClock):
    """The stand-in clock counting its stamps by name."""

    def launch(self, slot, iteration=None, count=None):
        name = trace.SLOT_NAMES[slot]
        self.counts[name] = self.counts.get(name, 0) + 1
        super().launch(slot, iteration, count)


def _sharded_finish_stamps():
    """On a gloo rank: the stamps of one sharded pt and one sharded VCM
    iteration, by name, on a stand-in clock."""
    from smallvcm_tpu_torch.parallel import sharding

    dev = torch.device("cpu")
    clock = CountingClock(dev)
    trace._clocks[("cpu", None)] = clock
    scene = load_cornell_box((RES, RES), SCENE_CONFIGS[0], device="cpu")
    out = {}
    for alg in ("pt", "vcm"):
        clock.counts = {}
        with trace.block(dev, 0, 1):
            if alg == "pt":
                sharding.sharded_simple_iteration(
                    None, "pt", scene, 0, RES, RES, max_path_length=3)
            else:
                sharding.sharded_render_iteration_with_stats(
                    None, scene, 0, RES, RES, max_path_length=3)
        out[alg] = dict(clock.counts)
    return out


def test_sharded_wrappers_stamp_finish_once_after_the_sums():
    for counts in multihost.spawn(2, "cpu", _sharded_finish_stamps):
        for alg in ("pt", "vcm"):
            assert counts[alg]["start"] == 1, alg
            assert counts[alg]["finish"] == 1, alg


def _rank_work(tag):
    with trace.span(tag, rank=torch.distributed.get_rank()):
        pass
    return torch.distributed.get_rank()


def test_spawn_brings_back_every_ranks_summary():
    assert multihost.spawn(2, "cpu", _rank_work, "test.work") == [0, 1]
    ranks = trace.summary()["ranks"]
    assert len(ranks) == 2
    for r, s in enumerate(ranks):
        assert s["spans"]["test.work"]["count"] == 1
        assert set(s) == {"counters", "spans", "stages", "bounces", "idle",
                          "clocks", "ranks"}


def _planted(stage_ms, share, spans_s, rerendered):
    return dict(
        counters={"render.rerendered_blocks": rerendered},
        spans={n: dict(count=1, total_s=v, median_s=v)
               for n, v in spans_s.items()},
        stages={n: dict(median_ms=v, min_ms=v, max_ms=v, iterations=3)
                for n, v in stage_ms.items()},
        bounces={}, idle=dict(share_median=share, blocks=3, gaps_s={}),
        ranks=[])


WANT = {"stage_ms.light_walk": 20.0, "stage_ms.camera_walk": 50.0,
        "stage_ms.merge": 3.0, "stage_ms.exchange": 7.0,
        "idle_share.replays": 0.25, "caps_measure_s": 4.0,
        "graph_capture_s": 1.5, "library_load_s": 0.5,
        "rerendered_blocks": 0.0}


def _summary_of(scale, rerendered=0):
    return _planted(
        dict(light_walk=20.0 * scale, camera_walk=50.0 * scale,
             merge=3.0 * scale, exchange=7.0 * scale),
        0.0025 * scale,
        {"render.caps_measure.measured": 4.0 * scale,
         "graphs.capture": 1.5 * scale, "cuda.library_load": 0.5 * scale},
        rerendered)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_none_without_a_trace_and_the_value_of_one(name,
                                                          monkeypatch):
    reader = spec.load_reader(name)
    traced = {"profile": {"kernels": 1}}
    assert reader.read({}) is None
    with monkeypatch.context() as m:
        m.delitem(sys.modules, "smallvcm_tpu_torch.trace")
        assert reader.read(traced) is None     # a port without the module
    m = pytest.MonkeyPatch()
    try:
        m.setattr(trace, "summary", lambda: _summary_of(1.0))
        assert reader.read({}) is None         # not a traced run on a card
        assert reader.read(traced) == pytest.approx(WANT[name])
        m.setattr(trace, "summary", lambda: _planted({}, None, {}, None))
        assert reader.read(traced) is None     # nothing recorded
        # Four ranks: the most of any rank.
        ranks = [_summary_of(s) for s in (0.5, 2.0, 1.0)]
        m.setattr(trace, "summary", lambda: dict(_summary_of(9.0),
                                                 ranks=ranks))
        want = WANT[name] * 2.0
        assert reader.read(traced) == pytest.approx(want)
    finally:
        m.undo()


# -- on a card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _card_render(dev, alg, iterations=6, block=3):
    scene = load_cornell_box((64, 64), SCENE_CONFIGS[0], device=dev)
    cfg = R.RenderConfig(algorithm=alg, iterations=iterations,
                         resolution=(64, 64), block_size=block)
    img, _, _, rays = R.render(scene, cfg)
    return img.cpu(), rays


# Each stamp of an iteration at the default path length, in program order.
ORDER = {
    "vcm": ["start", "light.sample", *(f"light.b{i}" for i in range(9)),
            "light_walk", "splat_flush", "camera.sample",
            *(f"camera.b{i}" for i in range(10)), "camera_walk",
            "merge_prep", "merge_kernel", "finish"],
    "pt": ["start", "camera.sample", *(f"camera.b{i}" for i in range(10)),
           "camera_walk", "finish"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["vcm", "pt"])
def test_stamps_increase_within_every_iteration_on_card(dev, alg):
    launches = trace.stamp_kernel.launches
    _card_render(dev, alg)
    assert trace.stamp_kernel.launches > launches
    clock = trace._clocks[(dev.type, dev.index)]
    slots = [trace._SLOT[name] for name in ORDER[alg]]
    rows = 0
    for _, times, _ in clock.blocks:
        for t in times:
            assert (t >= t[0]).sum() == len(slots)
            assert all(t[a] <= t[b] for a, b in zip(slots, slots[1:]))
            assert t[slots[-1]] > t[slots[0]]
            rows += 1
    assert rows == 6
    for start, end, stages, _, _ in trace._iterations(clock.blocks):
        # The stages sum to the first-to-last stamp time (within 1%).
        assert sum(stages.values()) == pytest.approx(end - start, rel=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["vcm", "pt"])
def test_images_bit_for_bit_with_the_clocks_on_and_off_on_card(dev, alg):
    on, rays_on = _card_render(dev, alg)
    trace.enable(device=False)
    launches = trace.stamp_kernel.launches
    off, rays_off = _card_render(dev, alg)
    assert trace.stamp_kernel.launches == launches
    assert torch.equal(on, off) and rays_on == rays_off
