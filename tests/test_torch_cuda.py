"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The file imports nothing of JAX, so it also runs where only the
port is installed, without the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the sweep's distances to rtol 1e-6 (both sides round each
product and sum alike; the kernel is built with -fmad=false) and its
primitive ids equal except on exact ties; the merge's per-query sums to
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
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.io.framebuffer import new_fb_planes
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
    scene = load_cornell_box((8, 8), config).to(dev)
    org, d = _rays(config, 100_000, dev)
    before = S.sweep_kernel.launches
    dk, pk = S.sweep_kernel(S.scene_tables(scene), scene.tri_mat.shape[0],
                            scene.sph_mat.shape[0], org, d)
    dp, pp = S.sweep_plain(scene, org, d)
    torch.cuda.synchronize()
    assert S.sweep_kernel.launches == before + 1
    torch.testing.assert_close(dk, dp, rtol=1e-6, atol=0.0)
    mism = pk != pp
    if bool(mism.any()):
        # Only where the two nearest distances are equal.
        all_t = torch.cat([S.tri_distances(scene, org, d),
                           S.sphere_distances(scene, org, d)], dim=1)
        t2 = torch.topk(all_t, 2, dim=1, largest=False).values
        assert bool((t2[mism, 0] == t2[mism, 1]).all())


def test_sweep_dispatch_and_wrapper_checks(dev):
    scene = load_cornell_box((8, 8), SCENE_CONFIGS[0]).to(dev)
    org, d = _rays(9, 300, dev)
    before = S.sweep_kernel.launches
    dist, prim = S.sweep(scene, V3(*(c[None].expand(2, 300) for c in org)), d)
    assert dist.shape == prim.shape == (2, 300) and dist.is_cuda
    assert S.sweep_kernel.launches == before + 1
    tables = S.scene_tables(scene)
    n_tri, n_sph = scene.tri_mat.shape[0], scene.sph_mat.shape[0]
    with pytest.raises(ValueError, match="forward-only"):
        S.sweep_kernel(tables, n_tri, n_sph,
                       V3(org.x.clone().requires_grad_(), org.y, org.z), d)
    with pytest.raises(ValueError, match="float32"):
        S.sweep_kernel(tables, n_tri, n_sph, V3(*(c.double() for c in org)),
                       d)
    assert S.sweep_kernel.launches == before + 1


def _merge_tables(dev, ppm):
    """Merge tables of one real VCM (or ppm) iteration at 64x64, with a
    merge radius large enough that most queries find photons."""
    res = 64
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1]).to(dev)
    pix = torch.arange(n, device=dev)
    use_vc = not ppm
    misc = vcm.compute_misc(scene, 0, n, 0.02, 0.75, use_vc, True)
    verts, _, _ = vcm.trace_light_paths(
        scene, misc, pix, 0, new_fb_planes(res, res, dev), 1234, 10, 0,
        use_vc, True, False)
    _, queries, _ = vcm._camera_stage(scene, misc, verts, pix, 0, res, 1234,
                                      10, 0, use_vc, True, ppm)
    qtab, runs, ptab, _, _ = M.merge_prep(scene, misc, queries, verts, n)
    return qtab, runs, ptab, misc


@pytest.mark.parametrize("ppm", [False, True])
def test_merge_kernel_matches_plain(dev, ppm):
    qtab, runs, ptab, misc = _merge_tables(dev, ppm)
    assert int((runs[:, 0] > 0).sum()) > 0
    args = (qtab, runs, ptab, misc.radius_sqr, misc.mis_vc_weight)
    kw = dict(max_path_length=10, min_path_length=0, ppm=ppm)
    before = M.merge_tiles_kernel.launches
    got = M.merge_tiles(*args, **kw)
    want = M.merge_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    assert M.merge_tiles_kernel.launches == before + 1
    assert float(want.abs().sum()) > 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    again = M.merge_tiles_kernel(*args, **kw)
    assert torch.equal(got, again)  # no atomics: bitwise repeatable


def test_render_on_card_matches_cpu(dev):
    res = (16, 16)
    cfg = R.RenderConfig(algorithm="vcm", iterations=2, resolution=res)
    want, _, _, want_rays = R.render(
        load_cornell_box(res, SCENE_CONFIGS[0]), cfg)
    scene = load_cornell_box(res, SCENE_CONFIGS[0]).to(dev)
    got, _, _, rays = R.render(scene, cfg)
    again, _, _, _ = R.render(scene, cfg)
    assert torch.equal(got, again)
    assert abs(rays / want_rays - 1.0) < 1e-3
    got, want = got.cpu().numpy(), want.numpy()
    assert np.isfinite(got).all() and want.mean() > 0.0
    ok = np.isclose(got, want, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert ok.mean() >= 0.99
    assert abs(got.mean() / want.mean() - 1.0) <= 1e-4


def test_sweep_autograd_matches_plain(dev):
    """The kernel's autograd Function against the plain sweep's autograd,
    on the card: distances to rtol 1e-6, ray gradients to rtol 1e-5."""
    for config in SCENE_CONFIGS:
        scene = load_cornell_box((8, 8), config).to(dev)
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
            load_cornell_box(res, SCENE_CONFIGS[1]), cfg)
        before = S.sweep_kernel.launches
        got, _, _, rays = R.render(
            load_cornell_box(res, SCENE_CONFIGS[1]).to(dev), cfg)
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
def test_pair_merge_on_card_matches_cpu_and_tile_kernel(dev, span_radii):
    """The pair merge on the card against itself on the CPU, and the tile
    kernel against the pair merge (rtol 3e-5 / atol 1e-7, per-query
    summation order), on a dense and on the sparse 32x32 case."""
    res = 32
    n = res * res
    scene = load_cornell_box((res, res), SCENE_CONFIGS[1])
    misc = vcm.compute_misc(scene, 0, n, 0.05, 0.75, True, True)
    span = misc.radius * span_radii
    q = _sparse_vertices(1, 4, n, span)
    lv = _sparse_vertices(2, 5, n, span)
    to = lambda v: vcm.StoredVertices(*(
        V3(*(c.to(dev) for c in f)) if isinstance(f, V3) else f.to(dev)
        for f in v))
    want = vcm.merge_stage(scene, misc, q, lv, False, 7, 0, n)
    assert float(want.x.abs().sum()) > 0.0
    scene_d = scene.to(dev)
    got = vcm.merge_stage(scene_d, misc, to(q), to(lv), False, 7, 0, n)
    before = M.merge_tiles_kernel.launches
    tile = M.merge_stage(scene_d, misc, to(q), to(lv), False, 7, 0, n)
    assert M.merge_tiles_kernel.launches == before + 1
    for g, t_, w in zip(got, tile, want):
        torch.testing.assert_close(g.cpu(), w, rtol=3e-5, atol=1e-7)
        torch.testing.assert_close(t_, g, rtol=3e-5, atol=1e-7)
