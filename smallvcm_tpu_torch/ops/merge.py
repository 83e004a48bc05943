"""Photon merge (vertex merging): table prep, the Hopper tile kernel, post.

Port of ``smallvcm_tpu/ops/pallas_merge.py``, the single-device merge of
VCM's main path (RangeQuery::Process, vertexcm.hxx:130-169):

* :func:`merge_prep` compacts photons and camera queries, sorts both by a
  linear grid-row key ``cz * GRID_XY + cy`` over the photon-bbox grid
  (cell = 2r, hashgrid.hxx:40-107), bakes a planar query table
  ``qtab [QF, query_cap]`` and photon table ``ptab [PF, photon_cap]``, and
  builds for each tile of ``QTILE`` cell-sorted queries a runs table of
  <= 9 disjoint photon-slab runs that cover the 2x2x2 probe neighbourhood
  (hashgrid.hxx:124-138) of every query in the tile.
* :func:`merge_tiles` evaluates every (query, photon) pair of a tile's
  slabs: exact r^2 test, path-length window (vertexcm.hxx:132-135), camera
  BSDF (diffuse + Phong) toward -photon.in_dir, MIS weight
  1/(w_light + 1 + w_camera) [tech. rep. (38)-(39)] (1 for ppm) times the
  photon throughput, summed per query -> ``[3, query_cap]``. CPU tensors
  take :func:`merge_tiles_plain`; CUDA tensors launch
  ``csrc/merge_tiles.cu``.
* :func:`merge_post` scales by the camera throughput and vm normalization
  and sums each query into its path, deterministically.

Caps: eager PyTorch sizes ``photon_cap``/``query_cap`` from the live
counts, rounded up to SLAB/QTILE, so nothing can overflow and there is no
grow-and-retry. That costs one host read per iteration (see merge_prep).
"""

from __future__ import annotations

import torch

from ..core.vec3 import V3
from ..core.vecmath import EPS_COSINE, EPS_PHONG, INV_PI_F
from ..io.framebuffer import deterministic_index_add
from . import _cuda
from . import bsdf as bsdf_ops
from .hashgrid import inv_cell_size, sort_compact_planes

GRID_XY = 1024            # cells along x and y (clamped)
GRID_Z = 512              # cells along z
ROWS = GRID_Z * GRID_XY   # 2^19 (row = cz * GRID_XY + cy)
_KEY_SENT = ROWS          # > any live row id: dead slots sort last
SLAB = 128                # photons per slab (one shared-memory stage)
QTILE = 256               # queries per tile (one CUDA block)
QF = 32                   # f32 fields per baked query
PF = 16                   # f32 fields per baked photon
N_RUNS = 9                # canonical (dy, dz) row classes per tile
RUNCOLS = 1 + 2 * N_RUNS  # col 0 total slabs; then (first slab, cum count)
_QSENT = 3e18             # out-of-world position of dead queries
_PSENT = -3e18            # distinct sentinel for dead photons
_NONE = 1 << 30           # "no interval" marker


def pad_mult(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Pair math (the tile kernel's body; ops/pallas_merge.py::_dense_block)
# ---------------------------------------------------------------------------


def _dense_block(r2, vc_w, qc, pc, *, max_path_length: int,
                 min_path_length: int, ppm: bool):
    """Evaluate broadcast (query, photon) pairs -> 3 RGB blocks.

    ``qc(j)`` is query field j and ``pc(j)`` photon field j, shaped to
    broadcast against each other (e.g. [..., QTILE, 1] x [..., 1, SLAB]).
    Field layouts: see merge_prep.
    """
    # Exact r^2 prefilter (hashgrid.hxx:157-167) + path-length window.
    dx = qc(0) - pc(0)
    dy = qc(1) - pc(1)
    dz = qc(2) - pc(2)
    dist2 = dx * dx + dy * dy + dz * dz
    tlen = qc(28) + pc(12)
    ok = (dist2 <= r2) & (tlen <= float(max_path_length)) & (
        tlen >= float(min_path_length))

    # Camera-BSDF evaluate toward the photon's incoming direction
    # (ops/bsdf.py::evaluate == bsdf.hxx:128-153).
    ldx, ldy, ldz = -pc(3), -pc(4), -pc(5)   # light_dir = -photon.in_dir
    lg_x = qc(3) * ldx + qc(4) * ldy + qc(5) * ldz
    lg_y = qc(6) * ldx + qc(7) * ldy + qc(8) * ldz
    lg_z = qc(9) * ldx + qc(10) * ldy + qc(11) * ldz

    ldf_z = qc(12)
    same_f = (lg_z * ldf_z >= 0.0).to(torch.float32)
    p_diff = qc(16)
    p_phong = qc(17)

    # Diffuse lobe (bsdf.hxx:393-412).
    ok_d = (p_diff > 0.0) & (ldf_z >= EPS_COSINE) & (lg_z >= EPS_COSINE)
    okd_f = ok_d.to(torch.float32) * same_f
    dd = p_diff * (lg_z * INV_PI_F).clamp_min(0.0) * okd_f
    rd = p_diff * (ldf_z * INV_PI_F).clamp_min(0.0) * okd_f

    # Phong lobe (bsdf.hxx:414-450). One pow serves value and pdf: both
    # are gated on dot_r_wi > EPS_PHONG, where their clamped bases agree.
    dotr = qc(13) * lg_x + qc(14) * lg_y + qc(15) * lg_z
    expo = qc(27)
    ok_p = ((p_phong > 0.0) & (ldf_z >= EPS_COSINE) & (lg_z >= EPS_COSINE)
            & (dotr > EPS_PHONG))
    okp_f = ok_p.to(torch.float32) * same_f
    lobe = torch.exp(expo * torch.log(dotr.clamp_min(EPS_PHONG))) * okp_f
    pp = p_phong * (expo + 1.0) * lobe * (0.5 * INV_PI_F)

    dir_pdf = (dd + pp) * qc(18)       # * camera continuation prob
    rev_pdf = (rd + pp) * pc(11)       # * photon continuation prob

    # [tech. rep. (38)-(39)]
    if ppm:
        mis = torch.ones_like(dir_pdf)
    else:
        w_light = pc(9) * vc_w + pc(10) * dir_pdf
        w_camera = qc(19) * vc_w + qc(20) * rev_pdf
        mis = 1.0 / (w_light + 1.0 + w_camera)

    mis = mis * ok.to(torch.float32)
    # factor_c = diffuse_c/pi [diffuse ok] + rho_c * lobe [phong ok]
    return [(qc(21 + c) * okd_f + qc(24 + c) * lobe) * pc(6 + c) * mis
            for c in range(3)]


# ---------------------------------------------------------------------------
# Table preparation
# ---------------------------------------------------------------------------


def _source_planes(verts):
    """Planar [16, L*N] f32 field planes: pos3 | in_dir3 | normal3 | thr3 |
    d_vcm | d_vm | mat_bits | valid (material id bit-cast to f32, so one
    sorted gather moves every field)."""
    flat = lambda a: a.reshape(-1)
    return torch.stack([
        flat(verts.position.x), flat(verts.position.y),
        flat(verts.position.z),
        flat(verts.in_dir.x), flat(verts.in_dir.y), flat(verts.in_dir.z),
        flat(verts.normal.x), flat(verts.normal.y), flat(verts.normal.z),
        flat(verts.throughput.x), flat(verts.throughput.y),
        flat(verts.throughput.z),
        flat(verts.d_vcm), flat(verts.d_vm),
        flat(verts.mat_id).to(torch.int32).view(torch.float32),
        flat(verts.valid).to(torch.float32),
    ], dim=0)


def _cells_of(x, y, z, mins, inv_cell, live):
    """Clamped integer cell coords (cell = 2r, hashgrid.hxx:64) and the
    side of the cell centre each point lies on (-1 / +1 per axis)."""
    rel = lambda a, mn: torch.where(live, (a - mn) * inv_cell, 0.0)
    rx, ry, rz = rel(x, mins[0]), rel(y, mins[1]), rel(z, mins[2])
    cl = lambda r, hi: torch.floor(r).long().clamp(0, hi - 1)
    sgn = lambda r: torch.where(r - torch.floor(r) < 0.5, -1, 1)
    return (
        (cl(rx, GRID_XY), cl(ry, GRID_XY), cl(rz, GRID_Z)),
        (sgn(rx), sgn(ry), sgn(rz)),
    )


def merge_prep(scene, misc, queries, light_verts, n_paths: int):
    """Compaction, cell sort and table bake.

    Returns None when there is nothing to merge, else
    ``(qtab [QF, query_cap], runs [n_tiles, RUNCOLS] int32,
    ptab [PF, photon_cap], q_path [query_cap] int64, n_q)``.

    qtab fields: 0-2 pos | 3-11 frame x/y/z | 12 local_dir_fix.z |
    13-15 reflected fix dir | 16 prob_diff | 17 prob_phong | 18 cont |
    19 d_vcm | 20 d_vm | 21-23 diffuse/pi | 24-26 phong rho | 27 exponent |
    28 path length | 29-31 throughput.
    ptab fields: 0-2 pos | 3-5 in_dir | 6-8 throughput | 9 d_vcm |
    10 d_vm | 11 continuation prob | 12 path length | 13-15 pad.
    """
    n = queries.valid.shape[1]
    n_ph = light_verts.valid.shape[1]
    dev = queries.valid.device
    mats = scene.materials

    psrc = _source_planes(light_verts)
    qsrc = _source_planes(queries)
    pv = psrc[15] > 0.0
    qv0 = qsrc[15] > 0.0
    # The one host read of the merge: live photon/query counts size the
    # compaction caps exactly (no static caps, no overflow retry).
    n_p, n_q = (int(v) for v in torch.stack([pv.sum(), qv0.sum()]).tolist())
    if n_p == 0 or n_q == 0:
        return None
    photon_cap = pad_mult(n_p, SLAB)
    query_cap = pad_mult(n_q, QTILE)
    n_tiles = query_cap // QTILE
    n_slabs = photon_cap // SLAB

    # ---- Photons: bbox, keys, compact + sort, bake. -----------------------
    big = 1e36
    mins = [torch.where(pv, psrc[c], big).min() for c in range(3)]
    maxs = [torch.where(pv, psrc[c], -big).max() for c in range(3)]
    inv_cell = inv_cell_size(misc.radius)

    (pcx, pcy, pcz), _ = _cells_of(psrc[0], psrc[1], psrc[2], mins, inv_cell,
                                   pv)
    pkey = torch.where(pv, pcz * GRID_XY + pcy, _KEY_SENT)
    prows, psrc_idx = sort_compact_planes(pkey, psrc, photon_cap)
    plive = torch.arange(photon_cap, device=dev) < n_p
    # Row ids of the live sorted photons, ascending: row_start[r] (the
    # first sorted photon with row >= r) is a binary search in them.
    srow = pkey[psrc_idx[:n_p]].contiguous()

    p_in = V3(prows[3], prows[4], prows[5])
    p_nrm = V3(prows[6], prows[7], prows[8])
    p_mat = prows[14].contiguous().view(torch.int32)
    p_cont = bsdf_ops.setup(mats, p_in, p_nrm, p_mat, plive).cont_prob
    p_len = (torch.div(psrc_idx, n_ph, rounding_mode="floor") + 1).to(
        torch.float32)
    pm = lambda a: torch.where(plive, a, 0.0)
    zp = torch.zeros((photon_cap,), dtype=torch.float32, device=dev)
    ptab = torch.stack([
        torch.where(plive, prows[0], _PSENT),
        torch.where(plive, prows[1], _PSENT),
        torch.where(plive, prows[2], _PSENT),
        pm(prows[3]), pm(prows[4]), pm(prows[5]),
        pm(prows[9]), pm(prows[10]), pm(prows[11]),
        pm(prows[12]), pm(prows[13]),
        pm(p_cont), pm(p_len), zp, zp, zp,
    ], dim=0)

    # ---- Queries: keys, compact + sort, bake. -----------------------------
    (_, qcy0, qcz0), _ = _cells_of(qsrc[0], qsrc[1], qsrc[2], mins, inv_cell,
                                   qv0)
    qkey_all = torch.where(qv0, qcz0 * GRID_XY + qcy0, _KEY_SENT)
    qrows, qsrc_idx = sort_compact_planes(qkey_all, qsrc, query_cap)
    qlive = torch.arange(query_cap, device=dev) < n_q

    qx, qy, qz = qrows[0], qrows[1], qrows[2]
    # Bbox rejection (hashgrid.hxx:116-122) padded by the merge radius:
    # same-plane camera hits can sit f32 ulps outside the tight photon bbox.
    pad = misc.radius
    in_bbox = (
        (qx >= mins[0] - pad) & (qx <= maxs[0] + pad)
        & (qy >= mins[1] - pad) & (qy <= maxs[1] + pad)
        & (qz >= mins[2] - pad) & (qz <= maxs[2] + pad)
    )
    (_, qcy, qcz), (_, qsy, qsz) = _cells_of(qx, qy, qz, mins, inv_cell,
                                             qlive)

    q_in = V3(qrows[3], qrows[4], qrows[5])
    q_nrm = V3(qrows[6], qrows[7], qrows[8])
    q_mat = qrows[14].contiguous().view(torch.int32)
    b = bsdf_ops.setup(mats, q_in, q_nrm, q_mat, qlive)
    diffuse = mats.diffuse[b.mat_id]
    phong = mats.phong[b.mat_id]
    expo = mats.exponent[b.mat_id]
    rho_s = (expo + 2.0) * (0.5 * INV_PI_F)
    q_len = (torch.div(qsrc_idx, n, rounding_mode="floor") + 1).to(
        torch.float32)
    q_path = torch.remainder(qsrc_idx, n)

    qm = lambda a: torch.where(qlive, a, 0.0)
    # Out-of-bbox queries get the position sentinel too: the reference
    # skips them before probing, but a tile evaluates every resident query
    # against slabs its tile-mates requested.
    q_on = qlive & in_bbox
    lobes_on = qlive & b.valid
    qtab = torch.stack([
        torch.where(q_on, qx, _QSENT),
        torch.where(q_on, qy, _QSENT),
        torch.where(q_on, qz, _QSENT),
        qm(b.frame_x.x), qm(b.frame_x.y), qm(b.frame_x.z),
        qm(b.frame_y.x), qm(b.frame_y.y), qm(b.frame_y.z),
        qm(b.frame_z.x), qm(b.frame_z.y), qm(b.frame_z.z),
        qm(b.local_dir_fix.z),
        qm(-b.local_dir_fix.x), qm(-b.local_dir_fix.y),
        qm(b.local_dir_fix.z),
        # evaluate() gates every lobe on state.valid; zeroed probabilities
        # reproduce that gate exactly.
        torch.where(lobes_on, b.prob_diff, 0.0),
        torch.where(lobes_on, b.prob_phong, 0.0),
        qm(b.cont_prob),
        qm(qrows[12]), qm(qrows[13]),
        qm(diffuse.x * INV_PI_F), qm(diffuse.y * INV_PI_F),
        qm(diffuse.z * INV_PI_F),
        qm(phong.x * rho_s), qm(phong.y * rho_s), qm(phong.z * rho_s),
        qm(expo), qm(q_len),
        qm(qrows[9]), qm(qrows[10]), qm(qrows[11]),
    ], dim=0)

    # ---- Per-tile photon intervals: 9 canonical row classes. -------------
    t = lambda a: a.reshape(n_tiles, QTILE)
    cy_t, cz_t = t(qcy), t(qcz)
    sy_t, sz_t = t(qsy), t(qsz)
    probe_t = t(q_on)

    los, his = [], []
    for dz_c in (-1, 0, 1):
        for dy_c in (-1, 0, 1):
            m = probe_t
            if dy_c != 0:
                m = m & (sy_t == dy_c)
            if dz_c != 0:
                m = m & (sz_t == dz_c)
            tr = ((cz_t + dz_c).clamp(0, GRID_Z - 1) * GRID_XY
                  + (cy_t + dy_c).clamp(0, GRID_XY - 1))
            tr_min = torch.where(m, tr, ROWS).amin(dim=1)
            tr_max = torch.where(m, tr, -1).amax(dim=1)
            empty = tr_max < 0
            lo = torch.searchsorted(srow, torch.where(empty, 0, tr_min))
            hi = torch.searchsorted(srow, torch.where(empty, 0, tr_max + 1))
            bad = empty | (hi <= lo)
            los.append(torch.where(bad, _NONE,
                                   torch.div(lo, SLAB, rounding_mode="floor")))
            his.append(torch.where(
                bad, 0, torch.div(hi + SLAB - 1, SLAB, rounding_mode="floor")))
    s_lo, order = torch.sort(torch.stack(los, dim=1), dim=1, stable=True)
    s_hi = torch.gather(torch.stack(his, dim=1), 1, order)

    # Merge overlapping/adjacent slab ranges (each slab must appear once).
    cummax_hi = torch.cummax(s_hi, dim=1).values
    prev_hi = torch.cat([torch.full_like(cummax_hi[:, :1], -1),
                         cummax_hi[:, :-1]], dim=1)
    group_id = torch.cumsum((s_lo > prev_hi).long(), dim=1) - 1
    glo = torch.stack([torch.where(group_id == g, s_lo, _NONE).amin(dim=1)
                       for g in range(N_RUNS)], dim=1)
    ghi = torch.stack([torch.where(group_id == g, s_hi, 0).amax(dim=1)
                       for g in range(N_RUNS)], dim=1)
    glen = torch.where(glo >= _NONE, 0, (ghi - glo).clamp_min(0))

    # ---- Per-tile runs table: total | (first slab, cum count) x 9. --------
    glo_c = torch.where(glen > 0, glo, 0).clamp(0, n_slabs - 1)
    cums = torch.cumsum(glen, dim=1)
    runs = torch.stack([glo_c, cums], dim=2).reshape(n_tiles, 2 * N_RUNS)
    runs = torch.cat([cums[:, -1:], runs], dim=1).to(torch.int32)
    return qtab, runs.contiguous(), ptab, q_path, n_q


# ---------------------------------------------------------------------------
# The tile evaluation: plain version and Hopper kernel
# ---------------------------------------------------------------------------


def _work_list(runs):
    """(tile, slab) of every slab visit the runs table lists, tile-major."""
    total = runs[:, 0].long()
    k_max = int(total.max()) if runs.shape[0] else 0
    k = torch.arange(k_max, device=runs.device)[None, :]
    slab = torch.zeros((runs.shape[0], k_max), dtype=torch.long,
                       device=runs.device)
    prev = torch.zeros_like(total)[:, None]
    for j in range(N_RUNS):
        lo = runs[:, 1 + 2 * j].long()[:, None]
        cum = runs[:, 2 + 2 * j].long()[:, None]
        sel = (k >= prev) & (k < cum)
        slab = torch.where(sel, lo + (k - prev), slab)
        prev = cum
    tile, kk = torch.nonzero(k < total[:, None], as_tuple=True)
    return tile, slab[tile, kk]


def merge_tiles_plain(qtab, runs, ptab, r2: float, vc_weight: float, *,
                      max_path_length: int, min_path_length: int, ppm: bool,
                      chunk: int = 64):
    """Plain PyTorch version of csrc/merge_tiles.cu -> [3, query_cap].

    Evaluates ``chunk`` (tile, slab) blocks of [QTILE, SLAB] pairs at a
    time; per-query sums differ from the kernel's only by summation order.
    """
    n_tiles = runs.shape[0]
    n_slabs = ptab.shape[1] // SLAB
    out = torch.zeros((3, n_tiles, QTILE), dtype=torch.float32,
                      device=qtab.device)
    q3 = qtab.reshape(QF, n_tiles, QTILE)
    p3 = ptab.reshape(PF, n_slabs, SLAB)
    tiles, slabs = _work_list(runs)
    for s in range(0, tiles.shape[0], chunk):
        tc, sc = tiles[s:s + chunk], slabs[s:s + chunk]
        q = q3[:, tc, :, None]      # [QF, W, QTILE, 1]
        p = p3[:, sc, None, :]      # [PF, W, 1, SLAB]
        blocks = _dense_block(
            r2, vc_weight, lambda j: q[j], lambda j: p[j],
            max_path_length=max_path_length,
            min_path_length=min_path_length, ppm=ppm,
        )
        sums = torch.stack([blk.sum(dim=-1) for blk in blocks])  # [3, W, Q]
        out.index_add_(1, tc, sums)
    return out.reshape(3, n_tiles * QTILE)


def merge_tiles_kernel(qtab, runs, ptab, r2: float, vc_weight: float, *,
                       max_path_length: int, min_path_length: int,
                       ppm: bool):
    """Launch csrc/merge_tiles.cu -> [3, query_cap] per-query RGB sums."""
    req = _cuda.require
    dev = qtab.device
    req(dev.type == "cuda", "merge_tiles_kernel needs CUDA tensors")
    n_tiles = runs.shape[0]
    query_cap = n_tiles * QTILE
    photon_cap = ptab.shape[1]
    req(qtab.shape == (QF, query_cap), "merge_tiles_kernel: qtab [QF, cap]")
    req(runs.shape == (n_tiles, RUNCOLS), "merge_tiles_kernel: bad runs")
    req(ptab.shape[0] == PF and photon_cap % SLAB == 0 and photon_cap > 0,
        "merge_tiles_kernel: ptab [PF, k*SLAB]")
    for t, dt in ((qtab, torch.float32), (runs, torch.int32),
                  (ptab, torch.float32)):
        req(t.device == dev, "merge_tiles_kernel: one device")
        req(t.dtype == dt, f"merge_tiles_kernel: expected {dt}")
        req(t.is_contiguous(), "merge_tiles_kernel: contiguous tables only")
        req(not t.requires_grad, "merge_tiles_kernel is forward-only")
    req(query_cap < 2 ** 31 and PF * photon_cap < 2 ** 31,
        "merge_tiles_kernel: tables too large for int32 offsets")

    out = torch.empty((3, query_cap), dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return out
    lib = _cuda.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.svcm_merge_tiles(
        qtab.data_ptr(), runs.data_ptr(), ptab.data_ptr(), out.data_ptr(),
        n_tiles, query_cap, photon_cap, float(r2), float(vc_weight),
        int(max_path_length), int(min_path_length), int(bool(ppm)), stream,
    )
    _cuda.check(status, "svcm_merge_tiles")
    merge_tiles_kernel.launches += 1
    return out


merge_tiles_kernel.launches = 0


def merge_tiles(qtab, runs, ptab, r2: float, vc_weight: float, **kw):
    """Per-query merge sums: the plain version on CPU, the kernel on CUDA."""
    if qtab.device.type == "cpu":
        return merge_tiles_plain(qtab, runs, ptab, r2, vc_weight, **kw)
    return merge_tiles_kernel(qtab, runs, ptab, r2, vc_weight, **kw)


# ---------------------------------------------------------------------------
# Post + the whole stage
# ---------------------------------------------------------------------------


def merge_post(out, qtab, q_path, n_q: int, vm_normalization: float,
               n_paths: int) -> V3:
    """Scale per-query sums by camera throughput x vm normalization and sum
    them into the owning path -> color_add V3 [n_paths].

    Dead query slots (index >= n_q) are dropped; the sum is deterministic
    (framebuffer.deterministic_index_add)."""
    query_cap = out.shape[1]
    qlive = torch.arange(query_cap, device=out.device) < n_q
    pdst = torch.where(qlive, q_path, n_paths)
    scaled = out[:3] * qtab[29:32] * vm_normalization
    z = deterministic_index_add(n_paths, pdst, scaled.transpose(0, 1))
    return V3(z[:, 0], z[:, 1], z[:, 2])


def merge_stage(scene, misc, queries, light_verts, ppm: bool,
                max_path_length: int, min_path_length: int,
                n_paths: int) -> V3:
    """Vertex merging over all recorded camera queries -> color_add V3."""
    prep = merge_prep(scene, misc, queries, light_verts, n_paths)
    if prep is None:
        z = torch.zeros((n_paths,), dtype=torch.float32,
                        device=queries.valid.device)
        return V3(z, z, z)
    qtab, runs, ptab, q_path, n_q = prep
    out = merge_tiles(
        qtab, runs, ptab, misc.radius_sqr, misc.mis_vc_weight,
        max_path_length=max_path_length, min_path_length=min_path_length,
        ppm=ppm,
    )
    return merge_post(out, qtab, q_path, n_q, misc.vm_normalization, n_paths)
