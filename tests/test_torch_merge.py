"""PyTorch port vs the JAX package: photon merge, hash-grid sort, framebuffer.

The merge is held against the Pallas merge ``merge_stage_pallas`` run in
interpret mode (itself pinned to the XLA merge by test_pallas_merge.py) on
that file's synthetic vertex distributions, at its bound: rtol 3e-5,
atol 1e-7 (per-query sums are taken in another order). On the CPU the
port evaluates the plain version of its cell walk; the CUDA kernel is
compared with it on a card, in test_torch_cuda.py. The cell walk's photon
ranges are held against brute force: every photon within r of a query is
listed exactly once, and the range lengths count the photons of the
query's 2x2x2 probe cells.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smallvcm_tpu.algorithms import vcm as jvcm
from smallvcm_tpu.io import framebuffer as jfb
from smallvcm_tpu.ops import hashgrid as jgrid
from smallvcm_tpu.ops import pallas_merge as JPM
from smallvcm_tpu.scene.scene import SCENE_CONFIGS
from smallvcm_tpu.scene.scene import load_cornell_box as jload
from smallvcm_tpu_torch.algorithms import vcm as tvcm
from smallvcm_tpu_torch.core.vec3 import V3
from smallvcm_tpu_torch.io import framebuffer as tfb
from smallvcm_tpu_torch.ops import hashgrid as tgrid
from smallvcm_tpu_torch.ops import merge as TM
from smallvcm_tpu_torch.scene.scene import load_cornell_box as tload

from .test_merge_stage import _random_vertices
from .test_torch_core import close, jv, t, tv

torch.set_num_threads(2)

RES = 8
N = RES * RES


def _port_vertices(jverts):
    return tvcm.StoredVertices(*(
        tv(f) if isinstance(f, tuple) else t(f) for f in jverts))


def _port_misc(jmisc):
    return tvcm.VcmMisc(*(float(np.asarray(v)) for v in jmisc))


def _case(seed, span_radii=30.0):
    js = jload((RES, RES), SCENE_CONFIGS[1])
    ts = tload((RES, RES), SCENE_CONFIGS[1], device="cpu")
    misc = jvcm.compute_misc(js, 0, N, 0.05, 0.75, True, True)
    kq, kp = jax.random.split(jax.random.PRNGKey(seed))
    span = float(misc.radius) * span_radii
    queries = _random_vertices(kq, 4, N, 0.0, span, 9)
    light_verts = _random_vertices(kp, 5, N, 0.0, span, 9)
    return js, ts, misc, queries, light_verts


def test_port_misc_matches_jax():
    js, ts = jload((RES, RES)), tload((RES, RES), device="cpu")
    for it, use_vc, use_vm in [(0, True, True), (7, False, True),
                               (123, True, False)]:
        want = jvcm.compute_misc(js, it, N, 0.003, 0.75, use_vc, use_vm)
        got = tvcm.compute_misc(ts, it, N, 0.003, 0.75, use_vc, use_vm)
        np.testing.assert_array_equal(
            np.array(got, np.float32),
            np.array([np.asarray(v) for v in want], np.float32))


@pytest.mark.parametrize("ppm", [False, True])
@pytest.mark.parametrize("seed,span_radii", [(0, 30.0), (1, 30.0),
                                              (0, 6.0), (1, 6.0)])
def test_merge_stage_matches_pallas_merge(ppm, seed, span_radii):
    """test_pallas_merge.py's distribution (30 radii) and a denser one
    (6 radii) where most queries find photons in range."""
    js, ts, misc, queries, light_verts = _case(seed, span_radii)
    want, ovf, stats = JPM.merge_stage_pallas(
        js, misc, queries, light_verts, work_cap=8192, ppm=ppm,
        max_path_length=7, min_path_length=0,
        photon_cap=384, query_cap=256, n_paths=N, interpret=True,
    )
    assert int(ovf) == 0 and int(stats[0]) > 0
    got = TM.merge_stage(ts, _port_misc(misc), _port_vertices(queries),
                         _port_vertices(light_verts), ppm, 7, 0, N)
    if span_radii < 10:
        assert float(got.x.abs().sum()) > 0.0
    close(got, want, rtol=3e-5, atol=1e-7)


def _photon_src(ptab, light_verts):
    """Flat source index of each photon slot, found by its position."""
    pos = np.stack([np.asarray(c).reshape(-1) for c in light_verts.position],
                   axis=1)
    where = {tuple(p): i for i, p in enumerate(pos.tolist())}
    return np.array([where[tuple(p)] for p in np.asarray(ptab)[:3].T.tolist()])


def test_merge_tables_match_pallas_prep():
    """qtab / ptab hold the Pallas prep's rows, permuted by the cell sort
    (matched by source index), and the plain cell walk on them equals the
    Pallas kernel's per-query sums on the Pallas tables. The port's caps
    are the live counts here, so every row is live; its live counts are
    the Pallas prep's."""
    js, ts, misc, queries, light_verts = _case(3, 6.0)
    (jq, jruns, jp), jq_path, n_q, ovf, stats = JPM.merge_prep(
        js, misc, queries, light_verts, 384, 256, N)
    assert int(ovf) == 0
    n_p = int(stats[1])
    tabs = TM.merge_prep(ts, _port_misc(misc), _port_vertices(queries),
                         _port_vertices(light_verts), N, photon_cap=n_p,
                         query_cap=int(n_q))
    qtab, ranges, ptab, q_path = tabs.qtab, tabs.ranges, tabs.ptab, \
        tabs.q_path
    tn_q = qtab.shape[0]
    assert tn_q == int(n_q) and ptab.shape[0] == n_p
    assert int(tabs.n_q) == int(n_q) and int(tabs.n_p) == n_p
    assert ranges.shape == (2 * TM.ROWS, tn_q)
    assert ranges.dtype == torch.int32
    # The walk's position tables repeat the rows' position and length.
    close(tabs.qpos, qtab[:, [0, 1, 2, 28]], rtol=0, atol=0)
    close(tabs.ppos, ptab[:, [0, 1, 2, 12]], rtol=0, atol=0)

    jq_planar = np.asarray(jq).transpose(2, 0, 1).reshape(TM.QF, -1)[:, :tn_q]
    src = lambda tab, path: (np.asarray(tab[28]).astype(np.int64) - 1) * N \
        + np.asarray(path)[:tn_q]
    qtab_f, ptab_f = qtab.T, ptab.T    # field-major, as the Pallas tables
    j_src, t_src = src(jq_planar, jq_path), src(qtab_f, q_path)
    jo, to = np.argsort(j_src), np.argsort(t_src)
    np.testing.assert_array_equal(j_src[jo], t_src[to])
    close(qtab_f[:, to], jq_planar[:, jo], rtol=1e-5, atol=1e-6)

    jp_live = np.asarray(jp)[:, :n_p]
    jps = _photon_src(jp_live, light_verts)
    tps = _photon_src(ptab_f, light_verts)
    jpo, tpo = np.argsort(jps), np.argsort(tps)
    np.testing.assert_array_equal(jps[jpo], tps[tpo])
    close(ptab_f[:, tpo], jp_live[:, jpo], rtol=1e-5, atol=1e-6)

    scal = JPM.make_scal(float(misc.radius_sqr), float(misc.mis_vc_weight))
    want = JPM.run_tile_kernel(scal, jq, jruns, jp, max_path_length=7,
                               min_path_length=0, ppm=False, interpret=True)
    want = np.asarray(want)[:3, :tn_q]
    got = TM.merge_cells(*tabs[:5], float(misc.radius_sqr),
                         float(misc.mis_vc_weight), max_path_length=7,
                         min_path_length=0, ppm=False)
    assert float(got.abs().sum()) > 0.0
    close(got[:, to], want[:, jo], rtol=3e-5, atol=1e-7)


def test_merge_stage_empty_and_kernel_wrapper_refuses_cpu():
    js, ts, misc, queries, light_verts = _case(0)
    lv = _port_vertices(light_verts)
    dead = lv._replace(valid=torch.zeros_like(lv.valid))
    got = TM.merge_stage(ts, _port_misc(misc), _port_vertices(queries), dead,
                         False, 7, 0, N)
    assert all(float(c.abs().sum()) == 0.0 for c in got)
    with pytest.raises(ValueError, match="needs CUDA"):
        TM.merge_cells_kernel(*_kernel_tables().values(), 0.1, 0.0,
                              max_path_length=7, min_path_length=0, ppm=False)


def _kernel_tables():
    """Well-formed CPU tables of 4 queries and 3 photons."""
    return dict(qpos=torch.zeros(4, 4), qtab=torch.zeros(4, TM.QF),
                ranges=torch.zeros(2 * TM.ROWS, 4, dtype=torch.int32),
                ppos=torch.zeros(3, 4), ptab=torch.zeros(3, TM.PF))


@pytest.mark.parametrize("bad,match", [
    ({}, "needs CUDA"),
    ({"qpos": torch.zeros(4, 3)}, "qpos"),
    ({"qtab": torch.zeros(4, TM.QF, dtype=torch.float64)}, "float32"),
    ({"ranges": torch.zeros(2 * TM.ROWS, 4, dtype=torch.int64)}, "int32"),
    ({"ranges": torch.zeros(TM.ROWS, 4, dtype=torch.int32)}, "ranges"),
    ({"ptab": torch.zeros(TM.PF, 3).T}, "contiguous"),
    ({"ptab": torch.zeros(3 * TM.PF + 1)[1:].reshape(3, TM.PF)}, "aligned"),
    ({"qtab": torch.zeros(4, TM.QF, requires_grad=True)}, "forward-only"),
])
def test_cell_kernel_wrapper_refuses(bad, match):
    """The wrapper raises on what the kernel does not take; on a CPU tensor
    it raises rather than run the plain version."""
    tabs = {**_kernel_tables(), **bad}
    with pytest.raises(ValueError, match=match):
        TM.merge_cells_kernel(*tabs.values(), 0.1, 0.0, max_path_length=7,
                              min_path_length=0, ppm=False)


def _np_vertices(rng, pos):
    """Port StoredVertices [L, N] at the given positions [3, L, N], with
    random directions, payload and validity (numpy, from a seed)."""
    shape = pos.shape[1:]
    unit = lambda: (lambda a: a / np.linalg.norm(a, axis=0))(
        rng.normal(size=(3, *shape)).astype(np.float32))
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return tvcm.StoredVertices(
        position=V3(*f(pos)),
        throughput=V3(*f(rng.uniform(0.1, 1, pos.shape))),
        in_dir=V3(*f(unit())), normal=V3(*f(unit())),
        mat_id=torch.from_numpy(rng.integers(0, 9, shape)),
        d_vcm=f(rng.uniform(0, 2, shape)), d_vc=torch.zeros(shape),
        d_vm=f(rng.uniform(0, 2, shape)),
        valid=torch.from_numpy(rng.random(shape) < 0.7),
    )


def _range_case(name):
    """Live rows of the merge tables of one synthetic case -> (tables,
    radius).

    random: uniform in a cube of 6 radii (most queries find photons);
    edge: queries on and just outside the faces and corners of the photon
    bbox, where the probe's neighbour cell clamps onto the query's own;
    wide: photons and queries spread over 3000 radii in x (1500 cells,
    wider than GRID_XY), so a third of them crowd into the clamped last
    x cell."""
    res = 16
    n = res * res
    ts = tload((res, res), SCENE_CONFIGS[1], device="cpu")
    misc = tvcm.compute_misc(ts, 0, n, 0.05, 0.75, True, True)
    r = misc.radius
    rng = np.random.default_rng(["random", "edge", "wide"].index(name))
    if name == "wide":
        lo, hi = np.zeros((3, 1, 1)), np.array([3000.0, 4.0, 4.0])[:, None,
                                                                   None] * r
    else:
        lo, hi = np.zeros((3, 1, 1)), np.full((3, 1, 1), 6.0 * r)
    ppos = lo + (hi - lo) * rng.random((3, 5, n))
    qpos = lo + (hi - lo) * rng.random((3, 4, n))
    if name == "edge":
        # Snap each query coordinate to a bbox face, a hair inside it, or
        # up to r outside it (still inside the padded bbox).
        pmin = ppos.reshape(3, -1).min(1)[:, None, None]
        pmax = ppos.reshape(3, -1).max(1)[:, None, None]
        pick = rng.integers(0, 5, qpos.shape)
        off = rng.uniform(0.0, 0.99 * r, qpos.shape)
        qpos = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                         [pmin - off, pmin, pmax, pmax + off], qpos)
    t = TM.merge_prep(ts, misc, _np_vertices(rng, qpos),
                      _np_vertices(rng, ppos), n)
    # The tables are cap-wide (here the slot counts): dead rows follow the
    # live ones, probe nothing and own no path.
    n_q, n_p = int(t.n_q), int(t.n_p)
    assert t.qtab.shape[0] == 4 * n > n_q and t.ptab.shape[0] == 5 * n > n_p
    assert bool((t.ranges[:, n_q:] == 0).all())
    assert bool((t.q_path[n_q:] == n).all()) and bool((t.q_path[:n_q] < n)
                                                       .all())
    live = t._replace(qpos=t.qpos[:n_q], qtab=t.qtab[:n_q],
                      ranges=t.ranges[:, :n_q], q_path=t.q_path[:n_q],
                      ppos=t.ppos[:n_p], ptab=t.ptab[:n_p])
    return live, r


def _prep_operands():
    """CPU operands of a small preparation: scene 1, 3 query and 4 photon
    slots a path at random positions -> (scene, misc, queries, photons)."""
    ts = tload((RES, RES), SCENE_CONFIGS[1], device="cpu")
    misc = tvcm.compute_misc(ts, 0, N, 0.05, 0.75, True, True)
    rng = np.random.default_rng(5)
    span = 20.0 * misc.radius
    return (ts, misc, _np_vertices(rng, span * rng.random((3, 3, N))),
            _np_vertices(rng, span * rng.random((3, 4, N))))


def _bad_plane(v, field, value):
    """Vertices ``v`` with one plane replaced (a position axis by name)."""
    if field in "xyz":
        return v._replace(position=v.position._replace(**{field: value}))
    return v._replace(**{field: value})


@pytest.mark.parametrize("side,field,make,match", [
    (None, None, None, "needs CUDA"),
    ("photons", "x", lambda t: t.double(), "float32"),
    ("queries", "mat_id", lambda t: t.int(), "int64"),
    ("photons", "valid", lambda t: t.to(torch.uint8), "bool"),
    ("queries", "d_vm", lambda t: t.T.contiguous().T, "contiguous"),
    ("photons", "d_vcm", lambda t: t[:, :-1], r"one \[L, N\] shape"),
    ("queries", "y", lambda t: t.clone().requires_grad_(), "forward-only"),
    ("caps", "photon_cap", 2 ** 27, "int32 indices"),
    ("caps", "query_cap", 2 ** 26, "int32 indices"),
    ("scene", "exponent", lambda t: t.double(), "materials"),
])
def test_prep_kernel_wrapper_refuses(side, field, make, match):
    """The preparation's kernel entry raises on what the kernel does not
    take, before any launch; on CPU tensors it raises rather than run the
    plain chain."""
    ts, misc, queries, photons = _prep_operands()
    caps = {}
    if side == "photons":
        photons = _bad_plane(photons, field, make(
            getattr(photons.position, field, None) if field in "xyz"
            else getattr(photons, field)))
    elif side == "queries":
        queries = _bad_plane(queries, field, make(
            getattr(queries.position, field, None) if field in "xyz"
            else getattr(queries, field)))
    elif side == "caps":
        caps = {field: make}
    elif side == "scene":
        ts = dataclasses.replace(ts, materials=ts.materials._replace(
            **{field: make(getattr(ts.materials, field))}))
    before = TM.merge_prep_kernel.launches
    with pytest.raises(ValueError, match=match):
        TM.merge_prep_kernel(ts, misc, queries, photons, N, **caps)
    assert TM.merge_prep_kernel.launches == before


def test_prep_dispatch_takes_the_plain_chain_on_cpu(monkeypatch):
    """merge_prep on CPU tensors is the plain chain, bit for bit, and adds
    no launch; the counter ``merge.prep_launches`` is in the summary. On
    CUDA operands the dispatch takes the kernel, and the plain chain under
    autograd when an operand requires grad."""
    from smallvcm_tpu_torch import graphs, trace

    ts, misc, queries, photons = _prep_operands()
    before = TM.merge_prep_kernel.launches
    got = TM.merge_prep(ts, misc, queries, photons, N, 50, 60)
    want = TM.merge_prep_plain(ts, misc, queries, photons, N, 50, 60)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert TM.merge_prep_kernel.launches == before
    assert "merge.prep_launches" in trace.summary()["counters"]
    assert any(name == "merge.prep_launches" for name, _, _ in
               graphs._counters())

    taken = []
    monkeypatch.setattr(TM, "_on_card", lambda *operands: True)
    monkeypatch.setattr(TM, "merge_prep_kernel",
                        lambda *a: taken.append("kernel"))
    monkeypatch.setattr(TM, "merge_prep_plain",
                        lambda *a: taken.append("plain"))
    TM.merge_prep(ts, misc, queries, photons, N)
    grad = queries._replace(d_vcm=queries.d_vcm.clone().requires_grad_())
    TM.merge_prep(ts, misc, grad, photons, N)
    with torch.no_grad():
        TM.merge_prep(ts, misc, grad, photons, N)
    assert taken == ["kernel", "plain", "kernel"]


@pytest.mark.parametrize("name", ["random", "edge", "wide"])
def test_cell_ranges_list_each_photon_in_radius_once(name):
    """Brute force over every (query, photon) pair of the tables: the
    ranges list each pair at most once, and every pair within r."""
    t, r = _range_case(name)
    qtab, ranges, ptab = t.qtab, t.ranges, t.ptab
    n_q, n_p = qtab.shape[0], ptab.shape[0]
    pairs = torch.cat([q * n_p + p for q, p in TM.candidate_pairs(ranges)])
    listed = torch.bincount(pairs, minlength=n_q * n_p)
    assert int(listed.max()) == 1
    d = [qtab[:, None, c] - ptab[None, :, c] for c in range(3)]
    near = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            <= float(np.float32(r) * np.float32(r))).reshape(-1)
    assert int(near.sum()) > 20
    assert bool((listed[near] == 1).all())


@pytest.mark.parametrize("name", ["random", "edge", "wide"])
def test_cell_ranges_count_the_probe_cells(name):
    """Each query's summed range lengths equal a brute-force count of the
    photons in its 2x2x2 probe cells (clamped to the grid, each distinct
    cell once); out-of-bbox queries probe nothing."""
    t, r = _range_case(name)
    qtab, ranges, ptab = t.qtab, t.ranges, t.ptab
    inv = np.float32(1.0) / (np.float32(r) * np.float32(2.0))
    pp = ptab[:, :3].T.numpy()
    mins = pp.min(axis=1, keepdims=True)
    grid = np.array([[TM.GRID_XY], [TM.GRID_XY], [TM.GRID_Z]])
    pc = np.clip(np.floor((pp - mins) * inv), 0, grid - 1)
    qp = qtab[:, :3].T.numpy()
    rel = (qp - mins) * inv
    qc = np.clip(np.floor(rel), 0, grid - 1)
    side = np.where(rel - np.floor(rel) < 0.5, -1, 1)
    first = np.clip(qc + np.minimum(side, 0), 0, grid - 1)
    last = np.clip(qc + np.maximum(side, 0), 0, grid - 1)
    inside = ((pc[:, None, :] >= first[:, :, None])
              & (pc[:, None, :] <= last[:, :, None])).all(axis=0)
    want = np.where(qp[0] < 1e18, inside.sum(axis=1), 0)
    got = (ranges[TM.ROWS:] - ranges[:TM.ROWS]).sum(0).numpy()
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [5, 300, 400])
def test_sort_compact_planes_matches(cap):
    r = np.random.default_rng(cap)
    keys = r.integers(0, 40, 320).astype(np.int32)
    keys[r.random(320) < 0.3] = 1 << 19   # dead slots sort last
    planes = r.normal(size=(4, 320)).astype(np.float32)
    want_p, want_src = jgrid.sort_compact_planes(
        jnp.asarray(keys, jnp.uint32), jnp.asarray(planes), cap)
    got_p, got_src = tgrid.sort_compact_planes(t(keys, np.int64), t(planes),
                                               cap)
    close(got_src, want_src)
    close(got_p, want_p, rtol=0, atol=0)


def test_framebuffer_scatters_match():
    r = np.random.default_rng(7)
    res_x, res_y = 12, 10
    p = res_x * res_y
    base = r.random((3, res_y, res_x), dtype=np.float32)
    rgb = r.random((3, 4, 50), dtype=np.float32)
    pix = r.integers(0, p + 1, (4, 50)).astype(np.int32)   # p = dropped
    close(tfb.splat_colors(tv(base), t(pix, np.int64), tv(rgb)),
          jfb.splat_colors(jv(base), jnp.asarray(pix), jv(rgb)),
          rtol=1e-6, atol=1e-7)

    col = r.random((3, p), dtype=np.float32)
    ids = np.arange(p, dtype=np.int64)
    close(tfb.add_color_at_pix(tv(base), t(ids), tv(col)),
          jfb.add_color_at_pix(jv(base), jnp.asarray(ids, jnp.uint32),
                               jv(col)), rtol=0, atol=0)

    sx = r.uniform(0, res_x, 50).astype(np.float32)
    sy = r.uniform(0, res_y, 50).astype(np.float32)
    close(tfb.add_color(tv(base), t(sx), t(sy), tv(rgb[:, 0])),
          jfb.add_color(jv(base), jnp.asarray(sx), jnp.asarray(sy),
                        jv(rgb[:, 0])), rtol=1e-6, atol=1e-7)
    img = base.transpose(1, 2, 0)
    close(tfb.total_luminance(t(img)), jfb.total_luminance(jnp.asarray(img)),
          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ext", ["bmp", "hdr", "pfm", "ppm"])
def test_image_writers_byte_identical(ext, tmp_path, monkeypatch):
    monkeypatch.setenv("SMALLVCM_TPU_NO_NATIVE", "1")
    img = np.random.default_rng(8).gamma(1.0, 0.4, (6, 8, 3)).astype(
        np.float32)
    img[0, 0] = 0.0
    jfb.save_image(img, str(tmp_path / f"j.{ext}"))
    tfb.save_image(torch.from_numpy(img), str(tmp_path / f"t.{ext}"))
    assert (tmp_path / f"t.{ext}").read_bytes() == \
        (tmp_path / f"j.{ext}").read_bytes()
    if ext == "bmp":
        np.testing.assert_array_equal(tfb.load_bmp(str(tmp_path / "t.bmp")),
                                      jfb.load_bmp(str(tmp_path / "j.bmp")))

