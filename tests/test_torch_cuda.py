"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The file imports nothing of JAX, so it also runs where only the
port is installed, without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the RNG kernel bit for bit (integer arithmetic, and an
exact conversion to float); the sweeps exactly: closest-hit distances and occlusion
answers bit for bit (both sides round each product and sum alike; the
kernels are built with -fmad=false), primitive ids equal except on exact
ties; the BSDF and lights kernels and the cell merge's preparation bit
for bit, any NaN equal to any NaN (one IEEE f32 op per torch op, the same
CUDA math library for sin, cos and pow; min, max and sorts exact);
the merge's per-query sums to
rtol 1e-4 / atol 1e-6 (the kernel sums a query's photons in another
order); a whole render on the card against the same render on the CPU
with the slice test's bound (rtol 1e-4 on >= 99% of pixels, mean to
1e-4), since 1-ulp differences can flip a Russian-roulette decision.
"""

import numpy as np
import pytest
import torch

from smallvcm_tpu_torch import render as R
from smallvcm_tpu_torch.algorithms import vcm
from smallvcm_tpu_torch.core import rng
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.ops import bsdf as B
from smallvcm_tpu_torch.ops import lights as L
from smallvcm_tpu_torch.ops import merge as M
from smallvcm_tpu_torch.ops import sweep as S
from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _rays(seed, n, dev):
    r = np.random.default_rng(seed)
    lo = np.array([[-1.27], [-1.25], [-1.28]], np.float32)
    hi = np.array([[1.28], [1.30], [1.28]], np.float32)
    org = (lo + (hi - lo) * r.random((3, n))).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    to = lambda a: V3(*(torch.from_numpy(c.copy()).to(dev) for c in a))
    return to(org), to(d)


@pytest.mark.parametrize("config", SCENE_CONFIGS)
def test_sweep_kernel_matches_plain(dev, config):
    scene = load_cornell_box((8, 8), config, device=dev)
    org, d = _rays(config, 100_000, dev)
    before = S.sweep_kernel.launches
    dk, pk = S.sweep_kernel(scene, org, d)
    dp, pp = S.sweep_plain(scene, org, d)
    torch.cuda.synchronize()
    assert S.sweep_kernel.launches == before + 1
    assert torch.equal(dk, dp)
    mism = pk != pp
    if bool(mism.any()):
        # Only where the two nearest distances are equal.
        all_t = torch.cat([S.tri_distances(scene, org, d),
                           S.sphere_distances(scene, org, d)], dim=1)
        t2 = torch.topk(all_t, 2, dim=1, largest=False).values
        assert bool((t2[mism, 0] == t2[mism, 1]).all())


@pytest.mark.parametrize("config", SCENE_CONFIGS)
def test_occluded_kernel_matches_plain(dev, config):
    """The any-hit entry against occluded_plain, bit for bit, with 0%, 35%
    and 100% of the lanes active and with no mask; and with the point
    broadcast over a window of 4 as connect_vertices passes it."""
    from smallvcm_tpu_torch.ops import intersect as I

    scene = load_cornell_box((8, 8), config, device=dev)
    n = 100_000
    org, d = _rays(60 + config, n, dev)
    r = np.random.default_rng(config)
    dist = torch.from_numpy(r.uniform(0.0, 3.0, n).astype(np.float32)).to(dev)
    u = torch.from_numpy(r.random(n)).to(dev)
    for active in (u < 0.0, u < 0.35, u < 1.0):
        before = S.occluded_kernel.launches
        got = S.occluded_kernel(scene, org, d, dist, active)
        want = S.occluded_plain(scene, org, d, dist, active)
        torch.cuda.synchronize()
        assert S.occluded_kernel.launches == before + 1
        assert got.dtype == torch.bool and torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())
    assert torch.equal(I.occluded(scene, org, d, dist), want)  # no mask

    w, m = 4, n // 4
    point = V3(*(c[:m] for c in org))
    view = V3(*(c[None].expand(w, m) for c in point))
    dw, distw = V3(*(c.reshape(w, m) for c in d)), dist.reshape(w, m)
    act = (u < 0.35).reshape(w, m)
    got = I.occluded(scene, view, dw, distw, act)
    full = S.occluded_plain(scene, V3(*(c.repeat(w) for c in point)), d,
                            dist, act.reshape(-1))
    assert torch.equal(got.reshape(-1), full)


# Active shares of the any-hit tests: none, one lane, one in 4,096, 4%,
# 16% (the main path's NEE calls), 50% and every lane.
SHARES = {"none": 0.0, "one": None, "1_in_4096": 1 / 4096, "4pct": 0.04,
          "16pct": 0.16, "half": 0.5, "all": 1.0}


def _shadow_case(dev, m, n_point, seed, share):
    """Shadow rays of ``m`` lanes whose point is broadcast over ``n_point``
    (ray i from point[i % n_point]) -> (point, direction, dist, active),
    ``share`` of the lanes active (None: one lane)."""
    r = np.random.default_rng(seed)
    point, d = _rays(seed, m, dev)
    point = V3(*(c[:n_point].contiguous() for c in point))
    dist = torch.from_numpy(r.uniform(0.0, 3.0, m).astype(np.float32)).to(dev)
    if share is None:
        active = torch.zeros(m, dtype=torch.bool, device=dev)
        active[int(r.integers(m))] = True
    else:
        active = torch.from_numpy(r.random(m) < share).to(dev)
    return point, d, dist, active


def _held_to_plain(scene, point, d, dist, active):
    """Launch the any-hit kernel once -> its answer, after checking it
    against occluded_plain bit for bit."""
    before = S.occluded_kernel.launches
    got = S.occluded_kernel(scene, point, d, dist, active)
    want = S.occluded_plain(scene, point, d, dist, active)
    torch.cuda.synchronize()
    assert S.occluded_kernel.launches == before + (dist.numel() > 0)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("share", list(SHARES))
@pytest.mark.parametrize("m", [262_144, 1_179_648])
def test_occluded_kernel_active_shares(dev, m, share):
    """The any-hit kernel against occluded_plain at the main path's call
    sizes (one pass of rays; a vertex-connection window of 4.5 passes) at
    every active share, from no lane to all."""
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device=dev)
    point, d, dist, active = _shadow_case(dev, m, m, 70, SHARES[share])
    got = _held_to_plain(scene, point, d, dist, active)
    assert int(got.sum()) <= int(active.sum())
    if share in ("half", "all"):
        assert 0 < int(got.sum()) < int(active.sum())


@pytest.mark.parametrize("case", ["below_window", "ragged", "empty",
                                  "broadcast", "odd_offset"])
def test_occluded_kernel_shapes(dev, case):
    """Fewer lanes than one block's window, a lane count that is not a
    multiple of the widest window, no lane, a point broadcast over w = 4
    passes whose count is not a multiple of the window, and a mask that
    starts at an odd address (the byte-by-byte path)."""
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[1], device=dev)
    m = {"below_window": 100, "ragged": 4_195_304, "empty": 0,
         "broadcast": 1_200_000, "odd_offset": 1_179_648}[case]
    n_point = 300_000 if case == "broadcast" else max(m, 1)
    point, d, dist, active = _shadow_case(dev, m, n_point, 71, 0.3)
    if case == "odd_offset":
        buf = torch.zeros(m + 1, dtype=torch.bool, device=dev)
        buf[1:] = active
        active = buf[1:]
        assert active.data_ptr() % 2 == 1 and active.is_contiguous()
    if case == "empty":
        point = V3(*(torch.zeros(1, device=dev) for _ in range(3)))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes, blocks = S.occluded_plan(m, n_sm)
    window = S.OCCLUDED_BLOCK * lanes
    assert {"below_window": m < window, "ragged": m % window != 0,
            "empty": blocks == 0, "broadcast": m % window != 0,
            "odd_offset": lanes > 1}[case]
    got = _held_to_plain(scene, point, d, dist, active)
    assert got.numel() == m and (m == 0 or bool(got.any()))


def test_occluded_kernel_graph_replays(dev):
    """The any-hit kernel captured in a CUDA graph and replayed with two
    other masks and points copied into its inputs: each replay gives its
    own inputs' plain answer, so nothing of an earlier launch (a list, a
    count) is left over."""
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device=dev)
    m, n_point = 1_048_576, 262_144
    inputs = [_shadow_case(dev, m, n_point, 80 + k, share)
              for k, share in enumerate((0.3, 0.04, 0.6))]
    static = [V3(*(c.clone() for c in inputs[0][0])),
              V3(*(c.clone() for c in inputs[0][1])),
              inputs[0][2].clone(), inputs[0][3].clone()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        S.occluded_kernel(scene, *static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = S.occluded_kernel(scene, *static)
    for point, d, dist, active in inputs[1:] + inputs[:1]:
        for dst, src in zip((*static[0], *static[1], static[2], static[3]),
                            (*point, *d, dist, active)):
            dst.copy_(src)
        graph.replay()
        want = S.occluded_plain(scene, point, d, dist, active)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and bool(want.any())


def test_sweep_dispatch_and_wrapper_checks(dev):
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device=dev)
    org, d = _rays(9, 300, dev)
    before = S.sweep_kernel.launches
    dist, prim = S.sweep(scene, V3(*(c[None].expand(2, 300) for c in org)), d)
    assert dist.shape == prim.shape == (2, 300) and dist.is_cuda
    assert S.sweep_kernel.launches == before + 1
    with pytest.raises(ValueError, match="forward-only"):
        S.sweep_kernel(scene, V3(org.x.clone().requires_grad_(), org.y,
                                 org.z), d)
    with pytest.raises(ValueError, match="float32"):
        S.sweep_kernel(scene, V3(*(c.double() for c in org)), d)
    assert S.sweep_kernel.launches == before + 1
    occ = S.occluded_kernel.launches
    dist = torch.full((300,), 0.5, device=dev)
    with pytest.raises(ValueError, match="bool"):
        S.occluded_kernel(scene, org, d, dist, (dist > 0.0).float())
    with pytest.raises(ValueError, match="multiple"):
        S.occluded_kernel(scene, V3(*(c[:7] for c in org)), d, dist,
                          dist > 0.0)
    assert S.occluded_kernel.launches == occ


def _merge_tables(dev, ppm):
    """Merge tables of one real VCM (or ppm) iteration at 64x64, with a
    merge radius large enough that most queries find photons."""
    res = 64
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1], device=dev)
    use_vc = not ppm
    misc = vcm.compute_misc(scene, 0, n, 0.02, 0.75, use_vc, True)
    verts, queries = vcm.trace_iteration(scene, 0, res, res, 1234, 10, 0,
                                         0.02, 0.75, use_vc, ppm)
    return M.merge_prep(scene, misc, queries, verts, n), misc


@pytest.mark.parametrize("ppm", [False, True])
def test_merge_kernel_matches_plain(dev, ppm):
    tabs, misc = _merge_tables(dev, ppm)
    assert int((tabs.ranges[M.ROWS:] > tabs.ranges[:M.ROWS]).sum()) > 0
    args = (*tabs[:5], misc.radius_sqr, misc.mis_vc_weight)
    kw = dict(max_path_length=10, min_path_length=0, ppm=ppm)
    before = M.merge_cells_kernel.launches
    got = M.merge_cells(*args, **kw)
    want = M.merge_cells_plain(*args, **kw)
    torch.cuda.synchronize()
    assert M.merge_cells_kernel.launches == before + 1
    assert float(want.abs().sum()) > 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    again = M.merge_cells_kernel(*args, **kw)
    assert torch.equal(got, again)  # no atomics: bitwise repeatable


def test_render_on_card_matches_cpu(dev):
    res = (16, 16)
    cfg = R.RenderConfig(algorithm="vcm", iterations=2, resolution=res)
    want, _, _, want_rays = R.render(
        load_cornell_box(res, SCENE_CONFIGS[0], device="cpu"), cfg)
    scene = load_cornell_box(res, SCENE_CONFIGS[0], device=dev)
    got, _, _, rays = R.render(scene, cfg)
    again, _, _, _ = R.render(scene, cfg)
    assert torch.equal(got, again)
    assert abs(rays / want_rays - 1.0) < 1e-3
    got, want = got.cpu().numpy(), want.numpy()
    assert np.isfinite(got).all() and want.mean() > 0.0
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert ok.mean() >= 0.99
    assert abs(got.mean() / want.mean() - 1.0) <= 1e-4


@pytest.mark.parametrize("alg", ["vcm", "pt", "el", "lt", "bpm"])
def test_graphs_equal_eager_on_card(dev, alg):
    """The trace stages as CUDA graphs (graphs.py) against graphs.eager():
    iterations 0 (eager), 1 (captured) and 2-3 (replayed) bit for bit,
    with equal rays and kernel launch counts (replays counted)."""
    from smallvcm_tpu_torch import graphs

    def run():
        scene = load_cornell_box((16, 16), SCENE_CONFIGS[0], device=dev)
        cfg = R.RenderConfig(algorithm=alg, resolution=(16, 16))
        counters = (S.sweep_kernel, S.occluded_kernel, M.merge_cells_kernel)
        before = [c.launches for c in counters]
        out = []
        for it in range(4):
            img, rays = R.render_iteration(scene, cfg, alg, it)
            out.append((img.clone(), int(rays)))
        return out, [c.launches - b for c, b in zip(counters, before)]

    captures = graphs.stage.captures
    got, got_launches = run()
    assert graphs.stage.captures > captures
    with graphs.eager():
        want, want_launches = run()
    assert got_launches == want_launches and got_launches[0] > 0
    for (a, ra), (b, rb) in zip(got, want):
        assert torch.equal(a, b) and ra == rb


@pytest.mark.parametrize("alg", ["vcm", "ppm", "pt"])
def test_blocks_equal_eager_and_single_iterations_on_card(dev, alg,
                                                         tmp_path,
                                                         monkeypatch):
    """A block of four through render() (each iteration one replay of the
    iteration graph) against the same render under graphs.eager() and with
    --block 1: bit for bit, equal rays and kernel launches, the merge
    launched once an iteration; tiny frozen caps grow, render the block
    again and give the same bits."""
    from smallvcm_tpu_torch import graphs

    monkeypatch.setenv("SMALLVCM_TPU_TORCH_CACHE", str(tmp_path))
    scene = load_cornell_box((16, 16), SCENE_CONFIGS[0], device=dev)
    counters = (S.sweep_kernel, S.occluded_kernel, M.merge_cells_kernel)

    def run(**kw):
        cfg = R.RenderConfig(algorithm=alg, iterations=4,
                             resolution=(16, 16), **kw)
        before = [c.launches for c in counters]
        img, _, done, rays = R.render(scene, cfg)
        assert done == 4
        return img, rays, [c.launches - b for c, b in zip(counters, before)]

    if alg != "pt":
        # Size the merge caps first: a measurement's launches are not the
        # render's.
        R._ensure_merge_caps(scene, R.RenderConfig(algorithm=alg,
                                                   resolution=(16, 16)),
                             R.resolve_algorithm(scene, alg))
    captures = graphs.stage.captures
    got = run(block_size=4)
    assert graphs.stage.captures > captures
    assert got[2][2] == (4 if alg != "pt" else 0)
    with graphs.eager():
        eager = run(block_size=4)
    singles = run(block_size=1)
    for other in (eager, singles):
        assert torch.equal(other[0], got[0]) and other[1:] == got[1:]
    if alg != "pt":
        forced = run(block_size=4, photon_factor=0.05, query_factor=0.05,
                     merge_caps_frozen=True)
        assert torch.equal(forced[0], got[0]) and forced[1] == got[1]


@pytest.fixture
def nccl_group(dev, tmp_path):
    """A one-rank NCCL group on the card (a file:// store), destroyed with
    the graphs that hold it."""
    import torch.distributed as dist

    from smallvcm_tpu_torch.parallel import multihost

    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    dist.init_process_group("nccl", init_method=(tmp_path / "rdv").as_uri(),
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("alg,kw", [("vcm", {}), ("vcm", {"vm_exchange":
                                                        "ring"}),
                                    ("vcm", {"merge_backend": "xla"}),
                                    ("pt", {})])
def test_one_rank_nccl_graph_equals_eager_on_card(dev, nccl_group, alg, kw,
                                                  tmp_path, monkeypatch):
    """A block of four on a one-rank NCCL group through render(): each
    iteration ONE CUDA graph with its collectives inside (one capture),
    bit for bit the same render under graphs.eager() and the single
    process's at the same caps, with equal rays and kernel launches."""
    from smallvcm_tpu_torch import graphs

    monkeypatch.setenv("SMALLVCM_TPU_TORCH_CACHE", str(tmp_path))
    scene = load_cornell_box((16, 16), SCENE_CONFIGS[0], device=dev)
    counters = (S.sweep_kernel, S.occluded_kernel, M.merge_cells_kernel)

    def run(**extra):
        cfg = R.RenderConfig(algorithm=alg, iterations=4, block_size=4,
                             resolution=(16, 16), **kw, **extra)
        before = [c.launches for c in counters]
        img, _, done, rays = R.render(scene, cfg)
        assert done == 4
        return img, rays, [c.launches - b for c, b in zip(counters, before)]

    captures = graphs.stage.captures
    got = run(group=nccl_group)
    assert graphs.stage.captures == captures + 1
    cell_merge = alg == "vcm" and kw.get("merge_backend") != "xla"
    assert got[2][2] == (4 if cell_merge else 0)
    with graphs.eager():
        eager = run(group=nccl_group)
    single = run(merge_caps_frozen=True)
    assert float(got[0].mean()) > 0.0
    for other in (eager, single):
        assert torch.equal(other[0], got[0]) and other[1:] == got[1:]


def test_sweep_autograd_matches_plain(dev):
    """The kernel's autograd Function against the plain sweep's autograd,
    on the card: distances to rtol 1e-6, ray gradients to rtol 1e-5."""
    for config in SCENE_CONFIGS:
        scene = load_cornell_box((8, 8), config, device=dev)
        org, d = _rays(40 + config, 100_000, dev)
        wts = torch.rand(100_000, device=dev)

        def grads(use_kernel):
            rays = [a.clone().requires_grad_() for a in (*org, *d)]
            o, dd = V3(*rays[:3]), V3(*rays[3:])
            dist, _ = S.sweep(scene, o, dd) if use_kernel else \
                S.sweep_plain(scene, o, dd)
            out = torch.where(dist < S.BIG_DIST, dist, 0.0)
            return out, torch.autograd.grad((out * wts).sum(), rays)

        before = S.sweep_kernel.launches
        got_t, got = grads(True)
        assert S.sweep_kernel.launches == before + 1
        want_t, want = grads(False)
        torch.testing.assert_close(got_t, want_t, rtol=1e-6, atol=0.0)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_pt_on_card_matches_cpu(dev):
    res = (16, 16)
    for alg in ("el", "pt"):
        cfg = R.RenderConfig(algorithm=alg, iterations=2, resolution=res)
        want, _, _, want_rays = R.render(
            load_cornell_box(res, SCENE_CONFIGS[1], device="cpu"), cfg)
        before = S.sweep_kernel.launches
        got, _, _, rays = R.render(
            load_cornell_box(res, SCENE_CONFIGS[1], device=dev), cfg)
        assert S.sweep_kernel.launches > before
        assert abs(rays / want_rays - 1.0) < 1e-3
        got, want = got.cpu().numpy(), want.numpy()
        ok = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=-1)
        assert ok.mean() >= 0.99
        assert abs(got.mean() / want.mean() - 1.0) <= 1e-4


def _sparse_vertices(seed, l, n, span):
    """Synthetic vertex table (scripts/check_kernel_tpu.py's shape of
    case): uniform positions over ``span``, random unit directions."""
    r = np.random.default_rng(seed)
    unit = lambda: (lambda a: a / np.linalg.norm(a, axis=0))(
        r.normal(size=(3, l, n)).astype(np.float32))
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return vcm.StoredVertices(
        position=V3(*f(r.uniform(0, span, (3, l, n)))),
        throughput=V3(*f(r.uniform(0.1, 1.0, (3, l, n)))),
        in_dir=V3(*f(unit())), normal=V3(*f(unit())),
        mat_id=torch.from_numpy(r.integers(0, 9, (l, n))),
        d_vcm=f(r.uniform(0, 2, (l, n))), d_vc=torch.zeros((l, n)),
        d_vm=f(r.uniform(0, 2, (l, n))),
        valid=torch.from_numpy(r.random((l, n)) < 0.6),
    )


@pytest.mark.parametrize("span_radii", [6.0, 120.0])
def test_pair_merge_on_card_matches_cpu_and_cell_kernel(dev, span_radii):
    """The pair merge on the card against itself on the CPU, and the cell
    kernel against the pair merge (rtol 3e-5 / atol 1e-7, per-query
    summation order), on a dense and on the sparse 32x32 case."""
    res = 32
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1], device="cpu")
    misc = vcm.compute_misc(scene, 0, n, 0.05, 0.75, True, True)
    span = misc.radius * span_radii
    q = _sparse_vertices(1, 4, n, span)
    lv = _sparse_vertices(2, 5, n, span)
    to = lambda v: vcm.StoredVertices(*(
        V3(*(c.to(dev) for c in f)) if isinstance(f, V3) else f.to(dev)
        for f in v))
    # The dense case (6 radii) has 1,329,797 candidate pairs: a pair cap of
    # 2048 rows a path holds them, so nothing overflows on either device.
    caps = (8 * n, 2048 * n, False, 7, 0, 5 * n, 4 * n, n)
    want, w_ovf, w_stats = vcm.merge_stage(scene, misc, q, lv, *caps)
    assert float(want.x.abs().sum()) > 0.0 and int(w_ovf) == 0
    scene_d = scene.to(dev)
    got, g_ovf, g_stats = vcm.merge_stage(scene_d, misc, to(q), to(lv),
                                          *caps)
    assert int(g_ovf) == 0 and g_stats.tolist() == w_stats.tolist()
    before = M.merge_cells_kernel.launches
    cells = M.merge_stage(scene_d, misc, to(q), to(lv), False, 7, 0, n)
    assert M.merge_cells_kernel.launches == before + 1
    for g, t_, w in zip(got, cells, want):
        torch.testing.assert_close(g.cpu(), w, rtol=3e-5, atol=1e-7)
        torch.testing.assert_close(t_, g, rtol=3e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The RNG kernel (csrc/rng_slots.cu) against the plain int64 chain
# ---------------------------------------------------------------------------


def _ids(n, seed, dev):
    """n path ids: 0, 2**32 - 1 and ids above 2**32 (taken mod 2**32)
    first, then random ones below 2**34."""
    edge = [0, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 7, 2 ** 40 + 3, 1]
    r = np.random.default_rng(seed)
    ids = np.concatenate([np.array(edge, np.int64),
                          r.integers(0, 2 ** 34, max(n - len(edge), 0))])
    return torch.from_numpy(ids[:n].astype(np.int64)).to(dev)


@pytest.mark.parametrize("generator", ["threefry", "tea"])
@pytest.mark.parametrize("seed", [1234, 2 ** 32 + 3])
@pytest.mark.parametrize("n_slots", [1, 2, 3, 4, 5])
def test_uniform_slots_kernel_matches_plain(dev, generator, seed, n_slots):
    """Bit for bit, with the stream as an int and as a 0-dim device
    tensor, through uniform_slots' dispatch: one launch a call."""
    ids = _ids(4099, seed % 1000 + n_slots, dev)
    stream = rng.make_stream(12345, rng.STAGE_CAMERA_NEE, 7)
    want = rng._uniform_slots_plain(seed, stream, ids, n_slots, generator)
    before = rng.uniform_slots_kernel.launches
    for s in (stream, torch.tensor(stream, dtype=torch.int64, device=dev)):
        got = rng.uniform_slots(seed, s, ids, n_slots, generator)
        assert got.shape == (4099, n_slots) and got.dtype == torch.float32
        assert got.is_cuda and torch.equal(got, want)
    torch.cuda.synchronize()
    assert rng.uniform_slots_kernel.launches == before + 2


@pytest.mark.parametrize("n", [0, 1, 257, 262_144])
def test_uniform_slots_kernel_sizes(dev, n):
    """Every size of the main path and its edges, both generators, odd and
    even slots, and ids of any leading shape ([2, n / 2] gives [2, n / 2,
    n_slots])."""
    ids = _ids(n, n, dev)
    stream = torch.tensor(rng.make_stream(3, rng.STAGE_LIGHT_WALK, 1),
                          dtype=torch.int64, device=dev)
    before = rng.uniform_slots_kernel.launches
    for generator in ("threefry", "tea"):
        for n_slots in (3, 4):
            got = rng.uniform_slots_kernel(99, stream, ids, n_slots,
                                           generator)
            want = rng._uniform_slots_plain(99, stream, ids, n_slots,
                                            generator)
            assert got.shape == (n, n_slots) and torch.equal(got, want)
    torch.cuda.synchronize()
    assert rng.uniform_slots_kernel.launches == before + (4 if n else 0)
    if n % 2 == 0 and n:
        got = rng.uniform_slots(99, stream, ids.view(2, n // 2), 5)
        assert torch.equal(got, rng._uniform_slots_plain(
            99, stream, ids, 5).view(2, n // 2, 5))


def test_uniform_slots_kernel_graph_reads_the_iteration(dev):
    """Captured once in a CUDA graph with the stream made from a 0-dim
    iteration buffer: each replay after the buffer changes gives that
    iteration's bits, so no stream is frozen into the capture."""
    ids = _ids(262_144, 5, dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)

    def draw():
        return rng.uniform_slots(
            1234, rng.make_stream(it, rng.STAGE_CAMERA_WALK, 3), ids, 4)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = draw()
    seen = []
    for k in (1, 2, 8388607, 0):
        it.fill_(k)
        graph.replay()
        want = rng._uniform_slots_plain(
            1234, rng.make_stream(k, rng.STAGE_CAMERA_WALK, 3), ids, 4)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        seen.append(out.clone())
    assert not torch.equal(seen[0], seen[1])


def test_uniform_slots_kernel_wrapper_checks(dev):
    ids = torch.arange(64, dtype=torch.int64, device=dev)
    before = rng.uniform_slots_kernel.launches
    for args, match in (
            ((1234, 9, ids.int(), 2), "int64"),
            ((1234, 9, ids.view(8, 8).t(), 2), "contiguous"),
            ((1234, 9, ids.float(), 2), "integer"),
            ((1234, 9, ids, 0), "n_slots"),
            ((1234, 9, ids, 2, "philox"), "generator"),
            ((1234, torch.tensor(9, dtype=torch.int32, device=dev), ids, 2),
             "stream")):
        with pytest.raises(ValueError, match=match):
            rng.uniform_slots(*args)
    assert rng.uniform_slots_kernel.launches == before


@pytest.mark.parametrize("alg,calls", [("pt", 21), ("vcm", 31)])
def test_iteration_graphs_equal_plain_rng_on_card(dev, alg, calls,
                                                  monkeypatch):
    """A pt and a VCM iteration at 64x64 (iteration 0 eager, 1 captured,
    2-3 replayed) give bitwise the same images and rays with the kernel as
    with uniform_slots patched to the plain int64 chain, and the kernel is
    launched once a call: pt 21 and VCM 31 an iteration, replays counted."""
    from smallvcm_tpu_torch import graphs

    def run():
        scene = load_cornell_box((64, 64), SCENE_CONFIGS[0], device=dev)
        cfg = R.RenderConfig(algorithm=alg, resolution=(64, 64))
        before = rng.uniform_slots_kernel.launches
        out = []
        for it in range(4):
            img, rays = R.render_iteration(scene, cfg, alg, it)
            out.append((img.clone(), int(rays)))
        return out, rng.uniform_slots_kernel.launches - before

    captures = graphs.stage.captures
    got, launches = run()
    assert graphs.stage.captures > captures
    assert launches == 4 * calls
    monkeypatch.setattr(rng, "uniform_slots", rng._uniform_slots_plain)
    want, plain_launches = run()
    assert plain_launches == 0
    for (a, ra), (b, rb) in zip(got, want):
        assert torch.equal(a, b) and ra == rb


# ---------------------------------------------------------------------------
# The BSDF kernel (csrc/bsdf.cu) against the plain chain
# ---------------------------------------------------------------------------


def _differ(got, want) -> str:
    """'' where ``got`` equals ``want`` bit for bit (any NaN equal to any
    NaN), else what differs: lanes and the largest gap in ulps."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return f"{got.shape} {got.dtype} against {want.shape} {want.dtype}"
    got, want = got.contiguous(), want.contiguous()
    if got.dtype != torch.float32:
        bad = got != want
        return f"{int(bad.sum())} lanes" if bool(bad.any()) else ""
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    bad = (gi != wi) & ~(torch.isnan(got) & torch.isnan(want))
    if not bool(bad.any()):
        return ""
    ulps = (gi[bad].long() - wi[bad].long()).abs().max()
    return f"{int(bad.sum())} lanes, up to {int(ulps)} ulps"


def _assert_same(got, want, what):
    flat = lambda x: list(B._leaves(x))
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    diffs = {k: d for k, (g, w) in enumerate(zip(got, want))
             if (d := _differ(g, w))}
    assert not diffs, f"{what}: output planes differ {diffs}"


def _bsdf_lanes(n, seed, dev, mat_dtype=torch.int64):
    """Scene 0 and n lanes mixing hits and misses, valid and invalid
    material ids, every material (the glass hit from inside and outside),
    zero, tiny, huge and NaN directions and normals, and uniforms with 0
    and the largest float below 1."""
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0], device=dev)
    m = scene.materials.ior.shape[0]
    r = np.random.default_rng(seed)

    def dirs():
        d = r.normal(size=(3, n)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        d[:, :8] = np.array([[0, 0, 0], [1e-30, 0, 0], [3e30, 1, 0],
                             [np.nan, 0, 1], [0, 0, 1], [0, 0, -1],
                             [0.995, 0.1, 0], [1, 0, 0]], np.float32).T
        return d

    ray, nrm, gen = dirs(), dirs(), dirs()
    mat = r.integers(-1, m, n)
    hit = r.random(n) < 0.85
    u = r.random((n, 4), dtype=np.float32)
    below_one = np.nextafter(np.float32(1), np.float32(0))
    u[:6, :3] = np.array([[0, 0, 0], [below_one] * 3, [0.5, 0, 1e-7],
                          [0, 0.5, 0.9999], [1e-30, 1 - 1e-7, 0.3],
                          [0.25, 0.75, 0.6]])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    v3 = lambda a: V3(*(to(c) for c in a))
    return (scene.materials, v3(ray), v3(nrm), to(mat).to(mat_dtype),
            to(hit), v3(gen), to(u))


@pytest.mark.parametrize("mat_dtype", [torch.int64, torch.int32])
def test_bsdf_setup_kernel_matches_plain(dev, mat_dtype):
    mats, ray, nrm, mat, hit, _, _ = _bsdf_lanes(262_144, 1, dev, mat_dtype)
    want = B.setup_plain(mats, ray, nrm, mat, hit)
    before = B.bsdf_kernel.launches
    got = B.setup(mats, ray, nrm, mat, hit)
    torch.cuda.synchronize()
    assert B.bsdf_kernel.launches == before + 1
    assert isinstance(got, B.BsdfState)
    _assert_same(got, want, "setup")
    # The lanes cover what they are meant to.
    glass = (mat == 7) & got.valid
    assert bool((glass & (got.local_dir_fix.z < 0)).any())
    assert bool((glass & (got.local_dir_fix.z > 0)).any())
    assert bool(got.valid.any()) and not bool(got.valid.all())


def test_bsdf_evaluate_kernel_matches_plain(dev):
    mats, ray, nrm, mat, hit, gen, _ = _bsdf_lanes(262_144, 2, dev)
    state = B.setup_plain(mats, ray, nrm, mat, hit)
    before = B.bsdf_kernel.launches
    _assert_same(B.evaluate(mats, state, gen),
                 B.evaluate_plain(mats, state, gen), "evaluate")
    assert B.bsdf_kernel.launches == before + 1


@pytest.mark.parametrize("fix_is_light", [False, True])
def test_bsdf_sample_kernel_matches_plain(dev, fix_is_light):
    """The uniforms as the walks pass them: columns of an [N, 4] draw."""
    mats, ray, nrm, mat, hit, _, u = _bsdf_lanes(262_144, 3, dev)
    state = B.setup_plain(mats, ray, nrm, mat, hit)
    us = (u[:, 0], u[:, 1], u[:, 2])
    before = B.bsdf_kernel.launches
    got = B.sample(mats, state, *us, fix_is_light=fix_is_light)
    want = B.sample_plain(mats, state, *us, fix_is_light=fix_is_light)
    _assert_same(got, want, "sample")
    events = set(got[4].unique().tolist())
    assert events == {B.EV_DIFFUSE, B.EV_PHONG, B.EV_REFLECT, B.EV_REFRACT}
    # Fused with pdf's rev_pdf_w of the sampled direction, as
    # sample_scattering calls it: the bits of the two plain calls.
    fused = B.sample_with_pdf(mats, state, *us, fix_is_light=fix_is_light)
    _assert_same(fused, (*want, B.pdf(mats, state, want[1])[1]),
                 "sample_with_pdf")
    assert B.bsdf_kernel.launches == before + 2


@pytest.mark.parametrize("layout", ["expanded", "contiguous"])
def test_bsdf_evaluate_kernel_on_a_window(dev, layout):
    """[8, N] as connect_vertices runs it: the camera state expanded from
    [N] (stride 0 along the window, read from its base) or a contiguous
    [8, N] state, against the plain path on the same operands."""
    w, n = 8, 262_144
    mats, ray, nrm, mat, hit, _, _ = _bsdf_lanes(w * n, 4, dev)
    if layout == "expanded":
        base = B.setup_plain(mats, ray[:n], nrm[:n], mat[:n], hit[:n])
        bro = lambda a: a.unsqueeze(0).expand(w, n)
        state = B.BsdfState(*(V3(*map(bro, f)) if isinstance(f, V3)
                              else bro(f) for f in base))
    else:
        view = lambda a: a.view(w, n)
        state = B.setup_plain(mats, V3(*map(view, ray)),
                              V3(*map(view, nrm)), view(mat), view(hit))
    gen = V3(*(c.view(w, n) for c in _bsdf_lanes(w * n, 5, dev)[5]))
    before = B.bsdf_kernel.launches
    got = B.evaluate(mats, state, gen)
    assert B.bsdf_kernel.launches == before + 1
    assert got[1].shape == (w, n) and got[1].is_contiguous()
    _assert_same(got, B.evaluate_plain(mats, state, gen),
                 f"evaluate, {layout}")
    if layout == "contiguous":  # the light side's setup fused with evaluate
        ops = (mats, V3(*(c.view(w, n) for c in ray)),
               V3(*(c.view(w, n) for c in nrm)), mat.view(w, n),
               hit.view(w, n))
        _assert_same(B.setup_evaluate(*ops, gen),
                     (*B.evaluate_plain(mats, state, gen), state.cont_prob),
                     "setup_evaluate")


def test_bsdf_setup_kernel_at_a_merge_cap(dev):
    """The pair merge's survivor rows (1,835,008) with int32 material ids,
    as merge_prep passes them."""
    n = 1_835_008
    mats, ray, nrm, mat, hit, _, _ = _bsdf_lanes(n, 6, dev, torch.int32)
    _assert_same(B.setup(mats, ray, nrm, mat, hit),
                 B.setup_plain(mats, ray, nrm, mat, hit), "setup at a cap")


def test_bsdf_kernels_in_a_graph_replay(dev):
    """setup, evaluate, sample and sample_with_pdf captured in one CUDA
    graph: a replay on new inputs copied into the captured ones gives the
    plain path's bits, and the capture launched each kernel once."""
    n = 262_144
    mats, ray, nrm, mat, hit, gen, u = _bsdf_lanes(n, 7, dev)

    def chain():
        b = B.setup(mats, ray, nrm, mat, hit)
        s = B.sample(mats, b, u[:, 0], u[:, 1], u[:, 2], fix_is_light=True)
        return b, B.evaluate(mats, b, gen), s, B.sample_with_pdf(
            mats, b, u[:, 0], u[:, 1], u[:, 2], fix_is_light=True)

    def plain():
        b = B.setup_plain(mats, ray, nrm, mat, hit)
        s = B.sample_plain(mats, b, u[:, 0], u[:, 1], u[:, 2], True)
        return (b, B.evaluate_plain(mats, b, gen), s,
                (*s, B.pdf(mats, b, s[1])[1]))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = B.bsdf_kernel.launches
    with torch.cuda.graph(graph):
        out = chain()
    assert B.bsdf_kernel.launches == before + 4
    for seed in (8, 9):
        _, ray2, nrm2, mat2, hit2, gen2, u2 = _bsdf_lanes(n, seed, dev)
        for dst, src in zip((*ray, *nrm, mat, hit, *gen, u),
                            (*ray2, *nrm2, mat2, hit2, *gen2, u2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _assert_same(out, plain(), f"graph replay, seed {seed}")


def _close_grads(got, want, rtol=1e-5):
    """Gradients to rtol, and to rtol of the largest one, NaNs equal: the
    two sides sum the same terms in another order."""
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=rtol * float(b.nan_to_num().abs().max()),
            equal_nan=True)


def test_bsdf_kernel_gradient_matches_plain(dev):
    """Under autograd the kernel runs (ops/bsdf.py::_BsdfKernelFn), once a
    call, and its gradients to the materials, normals and directions are
    the plain chain's autograd's: setup, evaluate, sample_with_pdf and
    setup_evaluate over 262,144 lanes."""
    mats0, ray, nrm, mat, hit, gen, u = _bsdf_lanes(262_144, 11, dev)
    wts = torch.rand(262_144, device=dev)
    live = torch.isfinite(ray.x) & torch.isfinite(nrm.x)

    def grads(kernel):
        mats = [t.clone().requires_grad_() for t in B._leaves(mats0)]
        dirs = [a.clone().requires_grad_() for a in (*nrm, *gen)]
        m, n_, g_ = B._materials_of(mats), V3(*dirs[:3]), V3(*dirs[3:])
        us = (u[:, 0], u[:, 1], u[:, 2])
        before = B.bsdf_kernel.launches
        with torch.enable_grad():
            if kernel:
                b = B.setup(m, ray, n_, mat, hit)
                outs = (*B.evaluate(m, b, g_),
                        *B.sample_with_pdf(m, b, *us, False),
                        *B.setup_evaluate(m, ray, n_, mat, hit, g_))
            else:
                b = B.setup_plain(m, ray, n_, mat, hit)
                s = B.sample_plain(m, b, *us, False)
                outs = (*B.evaluate_plain(m, b, g_), *s,
                        B.pdf(m, b, s[1])[1],
                        *B.evaluate_plain(m, b, g_), b.cont_prob)
            flat = [x for x in B._leaves(outs) if x.requires_grad]
            total = sum(torch.where(live, x * wts, 0.0).nan_to_num().sum()
                        for x in flat)
            gs = torch.autograd.grad(total, mats + dirs, allow_unused=True)
        return ([torch.zeros_like(t) if g is None else g
                 for t, g in zip(mats + dirs, gs)],
                B.bsdf_kernel.launches - before)

    (got, k_launches), (want, p_launches) = grads(True), grads(False)
    assert (k_launches, p_launches) == (4, 0)
    _close_grads(got, want)


@pytest.mark.parametrize("alg", ["pt", "vcm"])
def test_gradient_step_runs_the_bsdf_kernel_on_card(dev, alg, monkeypatch):
    """diff.loss_and_grad at 32x32 launches the BSDF kernel (pt its walk's
    three calls a bounce; VCM also the pair merge's) and gives the loss
    and gradients of the step with every call sent down the plain path."""
    from smallvcm_tpu_torch import diff

    scene = load_cornell_box((32, 32), SCENE_CONFIGS[0], device=dev)
    target = torch.full((32, 32, 3), 0.1, device=dev)

    def step():
        before = B.bsdf_kernel.launches
        loss, g = diff.loss_and_grad(scene, diff.extract_params(scene),
                                     target, 0, alg, 32, 32)
        return loss, list(diff._leaves(g)), B.bsdf_kernel.launches - before

    loss, got, launches = step()
    monkeypatch.setattr(B, "_on_card", lambda *operands: False)
    want_loss, want, plain_launches = step()
    assert launches > 0 and plain_launches == 0
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0.0)
    _close_grads(got, want, rtol=1e-4)


def test_bsdf_kernel_wrapper_checks(dev):
    mats, ray, nrm, mat, hit, gen, u = _bsdf_lanes(64, 10, dev)
    planes = [*ray, *nrm, mat, hit]
    before = B.bsdf_kernel.launches
    bad_mats = mats._replace(ior=mats.ior[:3])
    for args, match in (
            (("shade", mats, planes), "unknown op"),
            (("setup", mats, planes[:7]), "operand planes"),
            (("setup", mats, [*planes[:6], mat.float(), hit]), "operand 6"),
            (("setup", mats, [*planes[:7], hit.float()]), "operand 7"),
            (("setup", mats, [ray.x.double(), *planes[1:]]), "operand 0"),
            (("setup", bad_mats, planes), "materials"),
            (("setup", mats, [*planes[:7], hit.view(1, 1, 64)]),
             "3 dimensions"),
            (("setup", mats, [*planes[:7], hit.cpu()]), "CUDA device"),
            (("evaluate", mats, [*planes, *gen]), "operand planes")):
        with pytest.raises(ValueError, match=match):
            B.bsdf_kernel(*args)
    with pytest.raises(RuntimeError):  # shapes that do not broadcast
        B.bsdf_kernel("setup", mats, [*planes[:7], hit[:10]])
    assert B.bsdf_kernel.launches == before
    empty = B.bsdf_kernel("setup", mats, [p[:0] for p in planes])
    assert len(empty) == 21 and all(e.shape == (0,) for e in empty)
    assert B.bsdf_kernel.launches == before


@pytest.mark.parametrize("alg,calls", [("pt", 30), ("vcm", 73)])
def test_iteration_graphs_equal_plain_bsdf_on_card(dev, alg, calls,
                                                   monkeypatch):
    """A pt and a VCM iteration at 64x64 (iteration 0 eager, 1 captured,
    2-3 replayed) give bitwise the same images and rays with the BSDF
    kernel as with every call sent down the plain path, and the kernel
    runs once a call, replays counted: pt 30 an iteration (10 bounces of
    setup, evaluate, sample) and VCM 73 (9 light bounces of setup,
    evaluate, sample_with_pdf; 10 camera bounces of the same; 8
    connection windows of evaluate and setup_evaluate; the cell merge's
    preparation runs its set-ups inside csrc/merge_prep.cu)."""
    from smallvcm_tpu_torch import graphs

    def run():
        scene = load_cornell_box((64, 64), SCENE_CONFIGS[0], device=dev)
        cfg = R.RenderConfig(algorithm=alg, resolution=(64, 64))
        before = B.bsdf_kernel.launches
        out = []
        for it in range(4):
            img, rays = R.render_iteration(scene, cfg, alg, it)
            out.append((img.clone(), int(rays)))
        return out, B.bsdf_kernel.launches - before

    captures = graphs.stage.captures
    got, launches = run()
    assert graphs.stage.captures > captures
    assert launches == 4 * calls
    monkeypatch.setattr(B, "_on_card", lambda *operands: False)
    want, plain_launches = run()
    assert plain_launches == 0
    for (a, ra), (b, rb) in zip(got, want):
        assert _differ(a, b) == "" and ra == rb


# ---------------------------------------------------------------------------
# The lights kernel (csrc/lights.cu) against the plain chain
# ---------------------------------------------------------------------------

LIGHT_OPS = ("illuminate", "emit", "get_radiance")


def _all_kinds(dev):
    """One table of every light of scenes 0-3 (directional, two area,
    point, background), with scene 0's sphere: lanes of one call pick
    every kind, so a warp branches four ways."""
    scenes = [load_cornell_box((8, 8), c, device=dev) for c in SCENE_CONFIGS]
    planes = [torch.cat(p) for p in zip(*(L._leaves(s.lights)
                                          for s in scenes))]
    return L._lights_of(planes), scenes[0].scene_sphere


def _light_lanes(n, seed, dev, scene_id):
    """Scene ``scene_id``'s lights and sphere ("all": :func:`_all_kinds`)
    and n lanes: light ids with -1 lanes, receiving positions and ray
    directions with zero, tiny, huge, infinite and NaN ones, and an
    [n, 5] draw (its columns strided, as the RNG's output gives them) with
    0 and the largest float below 1."""
    if scene_id == "all":
        lights, sphere = _all_kinds(dev)
    else:
        s = load_cornell_box((8, 8), SCENE_CONFIGS[scene_id], device=dev)
        lights, sphere = s.lights, s.scene_sphere
    l = lights.kind.shape[0]
    r = np.random.default_rng(seed)
    pos = (r.random((3, n)) * 3.0 - 1.5).astype(np.float32)
    d = r.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    bad = np.array([[np.nan, 0, 0], [np.inf, 1, 0], [0, 0, 0],
                    [1e-30, 0, 0], [3e30, 1, 0], [0, 0, -1]], np.float32).T
    pos[:, :6] = bad
    d[:, :6] = bad
    u = r.random((n, 5), dtype=np.float32)
    below_one = np.nextafter(np.float32(1), np.float32(0))
    u[6:10] = np.array([[0] * 5, [below_one] * 5, [0.5, 0, 1e-7, 0.25, 0.75],
                        [1e-30, 1 - 1e-7, 0.5, 0, 0.5]])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    idx = to(r.integers(-1, l, n)).long()
    return lights, sphere, idx, V3(*to(pos)), V3(*to(d)), to(u)


def _light_calls(lights, sphere, idx, pos, d, u):
    """op -> (its call, its plain function's call), the uniforms as
    columns of the draw."""
    ill = (idx, sphere, pos, u[:, 1], u[:, 2])
    em = (idx, sphere, u[:, 1], u[:, 2], u[:, 3], u[:, 4])
    rad = (idx, sphere, d)
    return {
        "illuminate": (lambda: L.illuminate(lights, *ill),
                       lambda: L.illuminate_plain(lights, *ill)),
        "emit": (lambda: L.emit(lights, *em),
                 lambda: L.emit_plain(lights, *em)),
        "get_radiance": (lambda: L.get_radiance(lights, *rad),
                         lambda: L.get_radiance_plain(lights, *rad)),
    }


@pytest.mark.parametrize("scene_id", [0, 1, 2, 3, "all"])
@pytest.mark.parametrize("op", LIGHT_OPS)
def test_lights_kernel_matches_plain(dev, op, scene_id):
    """Each op at 262,144 lanes, one launch, bit for bit (NaNs equal) on
    the directional (scene 0), area (1), point (2) and background (3)
    lights and on one table of all four."""
    ops = _light_lanes(262_144, 21, dev, scene_id)
    call, plain = _light_calls(*ops)[op]
    before = L.lights_kernel.launches
    got = call()
    torch.cuda.synchronize()
    assert L.lights_kernel.launches == before + 1
    assert type(got) is type(plain())
    _assert_same(got, plain(), f"{op}, scene {scene_id}")


def test_lights_kernel_broadcast_point(dev):
    """One receiving point broadcast over the lanes (read with stride
    0)."""
    lights, sphere, idx, pos, d, u = _light_lanes(4096, 22, dev, "all")
    point = V3(*(c[7:8] for c in pos))
    _assert_same(L.illuminate(lights, idx, sphere, point, u[:, 1], u[:, 2]),
                 L.illuminate_plain(lights, idx, sphere, point, u[:, 1],
                                    u[:, 2]), "illuminate, a broadcast point")


def test_lights_kernels_in_a_graph_replay(dev):
    """illuminate, emit and get_radiance captured in one CUDA graph: a
    replay on new inputs copied into the captured ones gives the plain
    path's bits, and the capture launched each kernel once."""
    n = 262_144
    lights, sphere, idx, pos, d, u = _light_lanes(n, 23, dev, "all")
    calls = _light_calls(lights, sphere, idx, pos, d, u)

    def chain():
        return tuple(calls[op][0]() for op in LIGHT_OPS)

    def plain():
        return tuple(calls[op][1]() for op in LIGHT_OPS)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = L.lights_kernel.launches
    with torch.cuda.graph(graph):
        out = chain()
    assert L.lights_kernel.launches == before + 3
    for seed in (24, 25):
        _, _, idx2, pos2, d2, u2 = _light_lanes(n, seed, dev, "all")
        for dst, src in zip((idx, *pos, *d, u), (idx2, *pos2, *d2, u2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _assert_same(out, plain(), f"graph replay, seed {seed}")


def test_lights_kernel_gradient_matches_plain(dev):
    """Under autograd the kernel runs (ops/lights.py::_LightsKernelFn),
    once a call, and its gradients to the light intensity, the receiving
    positions and the ray directions are the plain chain's autograd's,
    over 262,144 lanes of every kind."""
    n = 262_144
    lights0, sphere, idx, pos0, d0, u = _light_lanes(n, 26, dev, "all")
    wts = torch.rand(n, device=dev)
    live = torch.isfinite(pos0.x) & torch.isfinite(d0.x)

    def grads(kernel):
        leaves = [t.clone().requires_grad_()
                  for t in (*lights0.intensity, *pos0, *d0)]
        lights = lights0._replace(intensity=V3(*leaves[:3]))
        pos, d = V3(*leaves[3:6]), V3(*leaves[6:])
        before = L.lights_kernel.launches
        calls = _light_calls(lights, sphere, idx, pos, d, u)
        with torch.enable_grad():
            outs = [calls[op][0 if kernel else 1]() for op in LIGHT_OPS]
            flat = [x for x in L._leaves(outs) if x.requires_grad]
            total = sum(torch.where(live, x * wts, 0.0).nan_to_num().sum()
                        for x in flat)
            gs = torch.autograd.grad(total, leaves, allow_unused=True)
        return ([torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, gs)],
                L.lights_kernel.launches - before)

    (got, k_launches), (want, p_launches) = grads(True), grads(False)
    assert (k_launches, p_launches) == (3, 0)
    _close_grads(got, want)


@pytest.mark.parametrize("alg", ["pt", "vcm"])
def test_gradient_step_runs_the_lights_kernel_on_card(dev, alg,
                                                      monkeypatch):
    """diff.loss_and_grad at 32x32 launches the lights kernel and gives
    the loss and gradients (the light intensity's among them) of the step
    with every light call sent down the plain path."""
    from smallvcm_tpu_torch import diff

    scene = load_cornell_box((32, 32), SCENE_CONFIGS[1], device=dev)
    target = torch.full((32, 32, 3), 0.1, device=dev)

    def step():
        before = L.lights_kernel.launches
        loss, g = diff.loss_and_grad(scene, diff.extract_params(scene),
                                     target, 0, alg, 32, 32)
        return loss, list(diff._leaves(g)), L.lights_kernel.launches - before

    loss, got, launches = step()
    monkeypatch.setattr(L, "_on_card", lambda *operands: False)
    want_loss, want, plain_launches = step()
    assert launches > 0 and plain_launches == 0
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0.0)
    _close_grads(got, want, rtol=1e-4)


def test_lights_kernel_wrapper_checks(dev):
    lights, sphere, idx, pos, d, u = _light_lanes(64, 27, dev, 1)
    planes = [idx, *pos, u[:, 1], u[:, 2]]
    before = L.lights_kernel.launches
    for args, match in (
            (("shade", lights, sphere, planes), "unknown op"),
            (("illuminate", lights, sphere, planes[:5]), "operand planes"),
            (("illuminate", lights, sphere, [idx.float(), *planes[1:]]),
             "operand 0"),
            (("illuminate", lights, sphere, [idx.int(), *planes[1:]]),
             "operand 0"),
            (("illuminate", lights._replace(kind=lights.kind.long()),
              sphere, planes), "lights are"),
            (("illuminate", lights, sphere._replace(
                radius=sphere.radius.cpu()), planes), "CUDA device"),
            (("illuminate", lights, sphere, [*planes[:5], u[:, 2].cpu()]),
             "CUDA device"),
            (("emit", lights, sphere, planes), "operand planes")):
        with pytest.raises(ValueError, match=match):
            L.lights_kernel(*args)
    with pytest.raises(RuntimeError):  # shapes that do not broadcast
        L.lights_kernel("illuminate", lights, sphere,
                        [*planes[:5], u[:10, 2]])
    assert L.lights_kernel.launches == before
    empty = L.lights_kernel("illuminate", lights, sphere,
                            [p[:0] for p in planes])
    assert len(empty) == 10 and all(e.shape == (0,) for e in empty)
    assert L.lights_kernel.launches == before


@pytest.mark.parametrize("alg,calls", [("pt", 20), ("vcm", 21)])
def test_iteration_graphs_equal_plain_lights_on_card(dev, alg, calls,
                                                     monkeypatch):
    """A pt and a VCM iteration at 64x64 (iteration 0 eager, 1 captured,
    2-3 replayed) give bitwise the same images and rays with the lights
    kernel as with every light call sent down the plain path, and the
    kernel runs once a call, replays counted: pt 20 an iteration (10
    bounces of get_radiance and illuminate) and VCM 21 (emit, then 10
    camera bounces of the same two)."""
    from smallvcm_tpu_torch import graphs

    def run():
        scene = load_cornell_box((64, 64), SCENE_CONFIGS[0], device=dev)
        cfg = R.RenderConfig(algorithm=alg, resolution=(64, 64))
        before = L.lights_kernel.launches
        out = []
        for it in range(4):
            img, rays = R.render_iteration(scene, cfg, alg, it)
            out.append((img.clone(), int(rays)))
        return out, L.lights_kernel.launches - before

    captures = graphs.stage.captures
    got, launches = run()
    assert graphs.stage.captures > captures
    assert launches == 4 * calls
    monkeypatch.setattr(L, "_on_card", lambda *operands: False)
    want, plain_launches = run()
    assert plain_launches == 0
    for (a, ra), (b, rb) in zip(got, want):
        assert _differ(a, b) == "" and ra == rb


# ---------------------------------------------------------------------------
# The cell merge's preparation (csrc/merge_prep.cu) against the plain chain
# ---------------------------------------------------------------------------


def _prep_case(dev, scene_id, ranks=1, res=64):
    """A VCM iteration's queries at res x res on ``scene_id``, and its
    light vertices; with ``ranks`` > 1 the light vertices of that many
    iterations side by side, as the all-gather lays out every rank's
    columns (a photon table of ``ranks`` times the query columns)."""
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[scene_id], device=dev)
    misc = vcm.compute_misc(scene, 0, n, 0.02, 0.75, True, True)
    verts, queries = vcm.trace_iteration(scene, 0, res, res, 1234, 10, 0,
                                         0.02, 0.75, True, False)
    if ranks > 1:
        packed = [vcm.pack_vertices(verts)] + [
            vcm.pack_vertices(vcm.trace_iteration(
                scene, it, res, res, 1234, 10, 0, 0.02, 0.75, True,
                False)[0]) for it in range(1, ranks)]
        verts = vcm.unpack_vertices(torch.cat(packed, dim=2))
    return scene, misc, queries, verts, n


@pytest.mark.parametrize("caps", ["slots", "live", "below", "above"])
@pytest.mark.parametrize("scene_id,ranks", [(0, 1), (1, 1), (0, 4)])
def test_merge_prep_kernel_matches_plain(dev, scene_id, ranks, caps):
    """Every field of the kernel's MergeTables equals the plain chain's as
    raw bits (any NaN equal to any NaN), dead rows and the padding of a cap
    above the slot count included, at caps at the slot counts, at the live
    counts, below them (overflow) and above the slot counts; in 17
    launches, the radius read from device memory."""
    scene, misc, queries, verts, n = _prep_case(dev, scene_id, ranks)
    full = M.merge_prep_plain(scene, misc, queries, verts, n)
    n_p, n_q = int(full.n_p), int(full.n_q)
    mp, mq = verts.valid.numel(), queries.valid.numel()
    assert 0 < n_p < mp and 0 < n_q < mq
    assert int((full.ranges[M.ROWS:] > full.ranges[:M.ROWS]).sum()) > 0
    pcap, qcap = {"slots": (None, None), "live": (n_p, n_q),
                  "below": (n_p // 2, n_q // 3),
                  "above": (mp + 300, mq + 77)}[caps]
    if caps == "live":  # the radius as a graph holds it
        misc = misc._replace(radius=torch.full(
            (), misc.radius, dtype=torch.float32, device=dev))
    want = M.merge_prep_plain(scene, misc, queries, verts, n, pcap, qcap)
    before = M.merge_prep_kernel.launches
    got = M.merge_prep(scene, misc, queries, verts, n, pcap, qcap)
    torch.cuda.synchronize()
    assert M.merge_prep_kernel.launches == before + 17
    assert got.ptab.shape[0] == (mp if pcap is None else pcap)
    assert got.qtab.shape[0] == (mq if qcap is None else qcap)
    diffs = {name: d for name, g, w in zip(M.MergeTables._fields, got, want)
             if (d := _differ(g, w))}
    assert not diffs, f"merge_prep: fields differ {diffs}"
    assert M.merge_prep.photon_rows == mp


def test_merge_prep_kernel_wrapper_checks(dev):
    scene, misc, queries, verts, n = _prep_case(dev, 0, res=16)
    before = M.merge_prep_kernel.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        M.merge_prep_kernel(scene, misc, queries, verts._replace(
            d_vm=verts.d_vm.cpu()), n)
    with pytest.raises(ValueError, match="one CUDA device"):
        M.merge_prep_kernel(scene, misc, queries._replace(
            d_vcm=queries.d_vcm.cpu()), verts, n)
    with pytest.raises(ValueError, match="radius"):
        M.merge_prep_kernel(scene, misc._replace(radius=torch.zeros(
            2, device=dev)), queries, verts, n)
    assert M.merge_prep_kernel.launches == before


def test_vcm_iterations_equal_plain_merge_prep_on_card(dev, monkeypatch):
    """Ten VCM iterations at 64x64 (iteration 0 eager, 1 captured, 2-9
    replayed) give bitwise the same images and rays with the kernel
    preparation as with every preparation sent down the plain chain, and
    the kernels launch 17 times an iteration, replays counted."""
    from smallvcm_tpu_torch import graphs

    def run():
        scene = load_cornell_box((64, 64), SCENE_CONFIGS[0], device=dev)
        cfg = R.RenderConfig(algorithm="vcm", resolution=(64, 64))
        before = M.merge_prep_kernel.launches
        out = []
        for it in range(10):
            img, rays = R.render_iteration(scene, cfg, "vcm", it)
            out.append((img.clone(), int(rays)))
        return out, M.merge_prep_kernel.launches - before

    captures = graphs.stage.captures
    got, launches = run()
    assert graphs.stage.captures > captures
    assert launches == 10 * 17
    monkeypatch.setattr(M, "_on_card", lambda *operands: False)
    want, plain_launches = run()
    assert plain_launches == 0
    assert float(want[-1][0].sum()) > 0.0
    for (a, ra), (b, rb) in zip(got, want):
        assert _differ(a, b) == "" and ra == rb


# -- the gradient step as one CUDA graph (diff.loss_and_grad) ---------------

GRAD_RES = 64


def _grad_job(dev, alg):
    """A gradient job at 64x64 on scene 0, its merge radius widened to 5%
    of the scene's so that the few paths merge: (diff, scene, two
    parameter sets, target, loss_and_grad's keywords at the fitted
    caps)."""
    from smallvcm_tpu_torch import diff

    scene = load_cornell_box((GRAD_RES, GRAD_RES), SCENE_CONFIGS[0],
                             device=dev)
    base = diff.extract_params(scene)
    other = base._replace(diffuse=base.diffuse * 0.5,
                          exponent=base.exponent * 2.0)
    target = torch.full((GRAD_RES, GRAD_RES, 3), 0.1, device=dev)
    kw = dict(radius_factor=0.05, **diff.fit_caps(
        scene, base, alg, GRAD_RES, GRAD_RES, radius_factor=0.05))
    return diff, scene, (base, other), target, kw


def _grad_step(diff, scene, params, target, it, alg, **kw):
    """One step -> its loss and every gradient leaf as one flat tensor."""
    loss, g = diff.loss_and_grad(scene, params, target, it, alg, GRAD_RES,
                                 GRAD_RES, **kw)
    return torch.cat([loss.reshape(1), *(x.reshape(-1)
                                         for x in diff._leaves(g))])


@pytest.mark.parametrize("alg", ["vcm", "pt"])
def test_replayed_gradient_step_equals_the_eager_step(dev, alg):
    """The step's graph, captured once, replays the eager step's loss and
    gradients bit for bit at two parameter sets and two iterations: its
    parameter, target and scalar buffers are refilled every call; and it
    adds the eager step's rays to ``diff.traced_rays``."""
    from smallvcm_tpu_torch import graphs

    diff, scene, params, target, kw = _grad_job(dev, alg)
    rays = {}

    def step(p, it, i=None):
        r0 = int(diff.traced_rays(dev))
        out = _grad_step(diff, scene, p, target, it, alg, **kw)
        if i is not None:
            rays.setdefault((i, it), []).append(
                int(diff.traced_rays(dev)) - r0)
        return out

    with graphs.eager():
        want = {(i, it): step(p, it, i) for i, p in enumerate(params)
                for it in (3, 4)}
    captures = graphs.stage.captures
    replays = diff._report()["diff.step_replays"]
    truncated = int(diff.truncated_steps(dev))
    step(params[0], 0)                 # eager: the key's warm-up
    step(params[1], 1)                 # the capture, then its replay
    for i, it in ((0, 3), (1, 4), (1, 3), (0, 4)):
        got = step(params[i], it, i)
        assert torch.equal(got, want[(i, it)]), (i, it)
    assert all(len(r) == 2 and r[0] == r[1] and r[0] > GRAD_RES ** 2
               for r in rays.values()), rays
    assert not torch.equal(want[(0, 3)], want[(1, 3)])
    assert not torch.equal(want[(0, 3)], want[(0, 4)])
    assert float(want[(0, 3)][1:].abs().sum()) > 0.0
    assert graphs.stage.captures == captures + 1
    assert diff._report()["diff.step_replays"] == replays + 5
    assert int(diff.truncated_steps(dev)) == truncated


def test_gradient_step_captures_once_a_key_then_replays(dev):
    from smallvcm_tpu_torch import graphs

    diff, scene, params, target, kw = _grad_job(dev, "vcm")
    c0 = graphs.stage.captures
    r0, s0 = (diff._report()[k] for k in ("diff.step_replays", "diff.steps"))
    for it in range(5):
        _grad_step(diff, scene, params[0], target, it, "vcm", **kw)
    assert graphs.stage.captures == c0 + 1
    assert diff._report()["diff.step_replays"] == r0 + 4
    assert diff._report()["diff.steps"] == s0 + 5
    # Another key (two iterations a step): its own warm-up and capture.
    for it in range(3):
        _grad_step(diff, scene, params[0], target, it, "vcm",
                   n_iterations=2, **kw)
    assert graphs.stage.captures == c0 + 2
    assert diff._report()["diff.step_replays"] == r0 + 6


def test_replayed_gradient_step_makes_no_host_sync(dev):
    """``set_sync_debug_mode("error")`` is silent over a replayed step with
    new parameter values."""
    diff, scene, params, target, kw = _grad_job(dev, "vcm")
    for it in range(2):
        _grad_step(diff, scene, params[0], target, it, "vcm", **kw)
    replays = diff._report()["diff.step_replays"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, g = diff.loss_and_grad(scene, params[1], target, 2, "vcm",
                                     GRAD_RES, GRAD_RES, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert diff._report()["diff.step_replays"] == replays + 1
    assert bool(torch.isfinite(loss))


def test_truncated_gradient_step_is_counted_on_card(dev):
    """A photon cap far too small truncates every step (eager, captured
    and replayed alike), which ``diff.truncated_steps`` and the trace's
    counter count; the fitted caps truncate none."""
    from smallvcm_tpu_torch import trace

    diff, scene, params, target, kw = _grad_job(dev, "vcm")
    before = int(diff.truncated_steps(dev))
    for it in range(3):
        _grad_step(diff, scene, params[0], target, it, "vcm",
                   **dict(kw, photon_factor=0.01))
    assert int(diff.truncated_steps(dev)) == before + 3
    assert trace.summary()["counters"]["diff.truncated_steps"] >= before + 3
    for it in range(3):
        _grad_step(diff, scene, params[0], target, it, "vcm", **kw)
    assert int(diff.truncated_steps(dev)) == before + 3
