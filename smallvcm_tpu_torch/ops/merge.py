"""Photon merge (vertex merging): table prep, the Hopper cell walk, post.

Port of ``smallvcm_tpu/ops/pallas_merge.py``, the single-device merge of
VCM's main path (RangeQuery::Process, vertexcm.hxx:130-169):

* :func:`merge_prep` compacts photons and camera queries into tables of
  static widths ``photon_cap`` and ``query_cap``, sorts both by the full
  cell key ``(cz * GRID_XY + cy) * GRID_XY + cx`` over the photon-bbox
  grid (cell = 2r, hashgrid.hxx:40-107; dead rows sort last under
  ``_KEY_SENT``), bakes a query table ``qtab [query_cap, QF]`` and a photon
  table ``ptab [photon_cap, PF]`` (the Pallas prep's fields, one row per
  query or photon), and gives every live query the <= ``ROWS`` sorted-photon
  ranges that hold its 2x2x2 probe neighbourhood (hashgrid.hxx:124-138):
  one range per probed (y, z) row, over the row's one or two probed x
  cells. CPU tensors take :func:`merge_prep_plain` (ATen ops, int64 keys
  sorted with ``hashgrid.sort_compact_planes``); CUDA tensors outside
  autograd take :func:`merge_prep_kernel`: ``csrc/merge_prep.cu``'s bbox,
  live counts and int32 keys, a stable radix sort of the live slots alone
  and the bake of both tables and the ranges, the same bits in 17
  launches.
* :func:`merge_cells` walks each live query's ranges: exact r^2 test,
  path-length window (vertexcm.hxx:132-135), camera BSDF (diffuse + Phong)
  toward -photon.in_dir, MIS weight 1/(w_light + 1 + w_camera) [tech. rep.
  (38)-(39)] (1 for ppm) times the photon throughput, summed per query ->
  ``[3, query_cap]``. CPU tensors take :func:`merge_cells_plain`; CUDA
  tensors launch ``csrc/merge_cells.cu``.
* :func:`merge_post` scales by the camera throughput and vm normalization
  and sums each query into its path, deterministically.

The Pallas kernel's design (dense 256-query tiles against whole photon
rows, ``_tile_kernel``) fits the TPU's vector unit; this one visits only
each query's own cells, as the reference does. Cell = 2r and the
side-of-centre probe cover [p - r, p + r] on each axis, so every photon
within r of a query is visited exactly once and the sums equal the Pallas
merge's up to summation order.

Sizes: as in the JAX package, the tables have static widths (the caps) and
the live counts, the overflow flag ``(n_p > photon_cap) + (n_q >
query_cap)`` and the stats stay on the device, so the merge makes no host
read and runs inside the whole-iteration CUDA graph (graphs.py). The
caller re-renders with grown caps on overflow (render.py). Caps left at
None are the tables' slot counts, which nothing can overflow. The
per-iteration scalars (radius, r^2, vm normalization, MIS weight) may be
0-dim float32 device tensors or Python floats: they round alike.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import trace
from ..core.vec3 import V3
from ..core.vecmath import EPS_COSINE, EPS_PHONG, INV_PI_F
from ..io.framebuffer import deterministic_index_add
from . import _cuda
from . import bsdf as bsdf_ops
from ._cuda import leaves as _leaves, on_card as _on_card
from .hashgrid import (expand_pairs, inv_cell_size, query_chunks,
                       sort_compact_planes)

GRID_XY = 1024            # cells along x and y (clamped)
GRID_Z = 512              # cells along z
_KEY_SENT = GRID_Z * GRID_XY * GRID_XY   # > any live cell key: dead last
QF = 32                   # f32 fields per baked query
PF = 16                   # f32 fields per baked photon
ROWS = 4                  # probed (y, z) rows per query: ranges [2*ROWS, n_q]
_QSENT = 3e18             # out-of-world position of out-of-bbox queries


# ---------------------------------------------------------------------------
# Pair math (the kernel's body; ops/pallas_merge.py::_dense_block)
# ---------------------------------------------------------------------------


def _dense_block(r2, vc_w, qc, pc, *, max_path_length: int,
                 min_path_length: int, ppm: bool):
    """Evaluate broadcast (query, photon) pairs -> 3 RGB blocks.

    ``qc(j)`` is query field j and ``pc(j)`` photon field j, shaped to
    broadcast against each other (e.g. both [n_pairs]). Field layouts: see
    merge_prep.
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


def _cell_key(cx, cy, cz):
    return (cz * GRID_XY + cy) * GRID_XY + cx


def _probe_span(c, side, n_cells: int):
    """The one or two probed cells along one axis, [first, last]: the
    query's cell and its neighbour on the side of the point, clamped to
    the grid (a neighbour clamped onto the query's own cell is dropped, so
    no photon is visited twice at the grid's edge)."""
    return ((c + side.clamp(max=0)).clamp_min(0),
            (c + side.clamp(min=0)).clamp_max(n_cells - 1))


class MergeTables(NamedTuple):
    """The cell walk's inputs, built by :func:`merge_prep` (rows in cell
    order, live rows first). The walk tests each candidate with
    ``qpos``/``ppos`` (16 contiguous bytes a query or photon); a pair that
    passes reads the rest of its query's and photon's row. Rows at or past
    the live counts are dead: empty ranges, a dropped path."""
    qpos: torch.Tensor     # [query_cap, 4] f32: position, path length
    qtab: torch.Tensor     # [query_cap, QF] f32
    ranges: torch.Tensor   # [2*ROWS, query_cap] int32
    ppos: torch.Tensor     # [photon_cap, 4] f32: position, path length
    ptab: torch.Tensor     # [photon_cap, PF] f32
    q_path: torch.Tensor   # [query_cap] int64: the owning path; dead: n_paths
    n_p: torch.Tensor      # 0-dim int64: live photons
    n_q: torch.Tensor      # 0-dim int64: live queries


def _dev_scalar(x, dev) -> torch.Tensor:
    """A per-iteration scalar as a 0-dim float32 tensor on ``dev``: a
    device tensor as it is (a graph's input), a Python float filled in."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x, dtype=torch.float32, device=dev)


def merge_prep(scene, misc, queries, light_verts, n_paths: int,
               photon_cap: int | None = None,
               query_cap: int | None = None) -> MergeTables:
    """Compaction into static caps, cell sort, table bake and per-query
    photon ranges -> :class:`MergeTables`, with no host read.

    ``photon_cap`` / ``query_cap`` default to the slot counts of the vertex
    tables (nothing can overflow). Live rows come first in cell order; a
    cap below the live count keeps the first cap rows (overflow, which
    :func:`merge_stage` reports). ``misc.radius`` may be a 0-dim device
    tensor: the cell size is formed on the device, rounded as
    ``hashgrid.inv_cell_size`` rounds it.

    On CUDA operands outside autograd this is :func:`merge_prep_kernel`
    (``csrc/merge_prep.cu``), bit for bit :func:`merge_prep_plain`, which
    runs everywhere else.

    qtab fields: 0-2 pos | 3-11 frame x/y/z | 12 local_dir_fix.z |
    13-15 reflected fix dir | 16 prob_diff | 17 prob_phong | 18 cont |
    19 d_vcm | 20 d_vm | 21-23 diffuse/pi | 24-26 phong rho | 27 exponent |
    28 path length | 29-31 throughput.
    ptab fields: 0-2 pos | 3-5 in_dir | 6-8 throughput | 9 d_vcm |
    10 d_vm | 11 continuation prob | 12 path length | 13-15 pad.
    ranges: rows 0..ROWS-1 hold each query's first sorted photon of a
    probed row, rows ROWS..2*ROWS-1 one past its last (empty: lo == hi),
    in ascending photon order.
    """
    flat = [*_leaves(scene.materials, queries, light_verts)]
    if _on_card(flat) and not (torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in flat)):
        fn = merge_prep_kernel
    else:
        fn = merge_prep_plain
    return fn(scene, misc, queries, light_verts, n_paths, photon_cap,
              query_cap)


def merge_prep_plain(scene, misc, queries, light_verts, n_paths: int,
                     photon_cap: int | None = None,
                     query_cap: int | None = None) -> MergeTables:
    """:func:`merge_prep` as a chain of ATen ops: the CPU path and the
    kernel's reference."""
    # Query columns are this process's paths; photon columns may be every
    # rank's (the sharded all-gather), so each side keeps its own count.
    n = queries.valid.shape[1]
    n_ph = light_verts.valid.shape[1]
    dev = queries.valid.device
    mats = scene.materials

    psrc = _source_planes(light_verts)
    qsrc = _source_planes(queries)
    merge_prep.photon_rows = psrc.shape[1]
    photon_cap = psrc.shape[1] if photon_cap is None else photon_cap
    query_cap = qsrc.shape[1] if query_cap is None else query_cap
    pv = psrc[15] > 0.0
    qv = qsrc[15] > 0.0
    n_p, n_q = pv.sum(), qv.sum()
    radius = _dev_scalar(misc.radius, dev)

    # ---- Photons: bbox, keys, compact + sort, bake. -----------------------
    big = 1e36
    mins = [torch.where(pv, psrc[c], big).min() for c in range(3)]
    maxs = [torch.where(pv, psrc[c], -big).max() for c in range(3)]
    # 1 / (2 r) in f32: the doubling is exact and the reciprocal correctly
    # rounded, as hashgrid.inv_cell_size computes it on the host.
    inv_cell = torch.reciprocal(radius * 2.0)

    pcells, _ = _cells_of(psrc[0], psrc[1], psrc[2], mins, inv_cell, pv)
    pkey = torch.where(pv, _cell_key(*pcells), _KEY_SENT)
    prows, psrc_idx = sort_compact_planes(pkey, psrc, photon_cap)
    p_live = torch.arange(photon_cap, device=dev) < n_p
    # Ascending cell keys; a dead row (or the padding of a cap above the
    # slot count) keeps the sentinel, so no range reaches it.
    skey = torch.where(p_live, pkey[psrc_idx], _KEY_SENT).contiguous()

    all_p = torch.ones((photon_cap,), dtype=torch.bool, device=dev)
    p_in = V3(prows[3], prows[4], prows[5])
    p_nrm = V3(prows[6], prows[7], prows[8])
    p_mat = prows[14].contiguous().view(torch.int32)
    p_cont = bsdf_ops.setup(mats, p_in, p_nrm, p_mat, all_p).cont_prob
    p_len = (torch.div(psrc_idx, n_ph, rounding_mode="floor") + 1).to(
        torch.float32)
    zp = torch.zeros((photon_cap,), dtype=torch.float32, device=dev)
    ptab = torch.stack([
        prows[0], prows[1], prows[2], prows[3], prows[4], prows[5],
        prows[9], prows[10], prows[11], prows[12], prows[13],
        p_cont, p_len, zp, zp, zp,
    ], dim=1)

    # ---- Queries: keys, compact + sort (neighbours share cells), bake. ---
    qcells, qsides = _cells_of(qsrc[0], qsrc[1], qsrc[2], mins, inv_cell, qv)
    qkey = torch.where(qv, _cell_key(*qcells), _KEY_SENT)
    qrows, qsrc_idx = sort_compact_planes(qkey, qsrc, query_cap)
    (qcx, qcy, qcz), (qsx, qsy, qsz) = (
        [c[qsrc_idx] for c in t] for t in (qcells, qsides))
    q_live = torch.arange(query_cap, device=dev) < n_q

    qx, qy, qz = qrows[0], qrows[1], qrows[2]
    # Bbox rejection (hashgrid.hxx:116-122) padded by the merge radius:
    # same-plane camera hits can sit f32 ulps outside the tight photon bbox.
    # Dead rows are outside too.
    in_bbox = (
        q_live
        & (qx >= mins[0] - radius) & (qx <= maxs[0] + radius)
        & (qy >= mins[1] - radius) & (qy <= maxs[1] + radius)
        & (qz >= mins[2] - radius) & (qz <= maxs[2] + radius)
    )

    all_q = torch.ones((query_cap,), dtype=torch.bool, device=dev)
    q_in = V3(qrows[3], qrows[4], qrows[5])
    q_nrm = V3(qrows[6], qrows[7], qrows[8])
    q_mat = qrows[14].contiguous().view(torch.int32)
    b = bsdf_ops.setup(mats, q_in, q_nrm, q_mat, all_q)
    diffuse = mats.diffuse[b.mat_id]
    phong = mats.phong[b.mat_id]
    expo = mats.exponent[b.mat_id]
    rho_s = (expo + 2.0) * (0.5 * INV_PI_F)
    q_len = (torch.div(qsrc_idx, n, rounding_mode="floor") + 1).to(
        torch.float32)
    q_path = torch.where(q_live, torch.remainder(qsrc_idx, n), n_paths)

    # Out-of-bbox and dead queries keep the Pallas prep's position sentinel
    # (and get empty ranges below).
    qtab = torch.stack([
        torch.where(in_bbox, qx, _QSENT),
        torch.where(in_bbox, qy, _QSENT),
        torch.where(in_bbox, qz, _QSENT),
        b.frame_x.x, b.frame_x.y, b.frame_x.z,
        b.frame_y.x, b.frame_y.y, b.frame_y.z,
        b.frame_z.x, b.frame_z.y, b.frame_z.z,
        b.local_dir_fix.z,
        -b.local_dir_fix.x, -b.local_dir_fix.y,
        b.local_dir_fix.z,
        # evaluate() gates every lobe on state.valid; zeroed probabilities
        # reproduce that gate exactly.
        torch.where(b.valid, b.prob_diff, 0.0),
        torch.where(b.valid, b.prob_phong, 0.0),
        b.cont_prob,
        qrows[12], qrows[13],
        diffuse.x * INV_PI_F, diffuse.y * INV_PI_F, diffuse.z * INV_PI_F,
        phong.x * rho_s, phong.y * rho_s, phong.z * rho_s,
        expo, q_len,
        qrows[9], qrows[10], qrows[11],
    ], dim=1)

    # ---- Per-query photon ranges: one per probed (y, z) row. -------------
    # Photons are sorted by (row, cx), so the row's probed x cells
    # [x0, x1] are one contiguous range of sorted photons.
    x0, x1 = _probe_span(qcx, qsx, GRID_XY)
    y0, y1 = _probe_span(qcy, qsy, GRID_XY)
    z0, z1 = _probe_span(qcz, qsz, GRID_Z)
    lo_keys, hi_keys = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            on = in_bbox & (z0 + dz <= z1) & (y0 + dy <= y1)
            row = ((z0 + dz) * GRID_XY + (y0 + dy)) * GRID_XY
            lo_keys.append(torch.where(on, row + x0, 0))
            hi_keys.append(torch.where(on, row + x1 + 1, 0))
    ranges = torch.searchsorted(skey, torch.stack(lo_keys + hi_keys))
    return MergeTables(
        qpos=torch.stack([qtab[:, 0], qtab[:, 1], qtab[:, 2], q_len], dim=1),
        qtab=qtab, ranges=ranges.to(torch.int32),
        ppos=torch.stack([prows[0], prows[1], prows[2], p_len], dim=1),
        ptab=ptab, q_path=q_path, n_p=n_p, n_q=n_q)


def _side_planes(name: str, verts) -> list:
    """A vertex table's planes as ``csrc/merge_prep.cu`` takes them:
    position, in_dir, normal, throughput (3 each), d_vcm, d_vm (float32),
    mat_id (int64), valid (bool), one [L, N] shape, contiguous."""
    planes = [*verts.position, *verts.in_dir, *verts.normal,
              *verts.throughput, verts.d_vcm, verts.d_vm, verts.mat_id,
              verts.valid]
    req = _cuda.require
    req(all(isinstance(t, torch.Tensor) for t in planes),
        f"merge_prep_kernel: {name} planes are tensors")
    shape = verts.valid.shape
    for k, t in enumerate(planes):
        dt = (torch.int64 if k == 14 else torch.bool if k == 15
              else torch.float32)
        req(t.dtype == dt, f"merge_prep_kernel: {name} plane {k} is "
            f"{t.dtype}, not {dt}")
        req(t.dim() == 2 and t.shape == shape,
            f"merge_prep_kernel: {name} planes of one [L, N] shape")
        req(t.is_contiguous(), "merge_prep_kernel: contiguous planes only")
        req(not t.requires_grad, "merge_prep_kernel is forward-only")
    req(0 < shape.numel() < 2 ** 31,
        f"merge_prep_kernel: {name} slots must be 1 to 2**31 - 1 for "
        "int32 indices")
    return planes


def merge_prep_kernel(scene, misc, queries, light_verts, n_paths: int,
                      photon_cap: int | None = None,
                      query_cap: int | None = None) -> MergeTables:
    """:func:`merge_prep` on the card: ``csrc/merge_prep.cu``'s slot passes
    (bbox, live counts, int32 cell keys), its stable radix sort of each
    side's live slots by key, then its bake of the photon and query tables
    and the ranges, bit for bit :func:`merge_prep_plain`, with no host
    read. The vertex planes are read where they lie (no stacked copy); the
    radius is read from device memory (a Python float is filled in first,
    outside a capture only). Counts its launches in ``.launches``."""
    req = _cuda.require
    n = queries.valid.shape[-1]
    n_ph = light_verts.valid.shape[-1]
    pplanes = _side_planes("photon", light_verts)
    qplanes = _side_planes("query", queries)
    mp, mq = pplanes[0].numel(), qplanes[0].numel()
    photon_cap = mp if photon_cap is None else photon_cap
    query_cap = mq if query_cap is None else query_cap
    req(0 <= photon_cap and photon_cap * PF < 2 ** 31
        and 0 <= query_cap and query_cap * QF < 2 ** 31,
        "merge_prep_kernel: caps too large for int32 indices")
    mats = list(_leaves(scene.materials))
    m = mats[0].shape[0] if mats and mats[0].dim() == 1 else 0
    req(len(mats) == 11 and all(
        isinstance(t, torch.Tensor) and t.dtype == torch.float32
        and t.shape == (m,) for t in mats)
        and 1 <= m <= bsdf_ops.MAX_MATERIALS,
        "merge_prep_kernel: materials are 11 float32 planes of 1 to "
        f"{bsdf_ops.MAX_MATERIALS} rows")
    dev = queries.valid.device
    req(dev.type == "cuda", "merge_prep_kernel needs CUDA tensors")
    radius = _dev_scalar(misc.radius, dev)
    req(all(t.device == dev for t in pplanes + qplanes + mats + [radius]),
        "merge_prep_kernel: every operand on one CUDA device")
    req(radius.dtype == torch.float32 and radius.numel() == 1,
        "merge_prep_kernel: the radius is one float32 value")
    merge_prep.photon_rows = mp

    lib = _cuda.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = lambda ts: (ctypes.c_longlong * len(ts))(
        *(t.data_ptr() for t in ts))
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    empty = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype,
                                                  device=dev)
    tiles = -(-mp // _PREP_TILE) - (-mq // _PREP_TILE)
    parts, live_base = empty(tiles, 8), empty(tiles, dtype=i32)
    # Each side's sort buffers: keys and slots, twice.
    sort = [empty(m_side, dtype=i32) for m_side in (mp, mq) for _ in range(4)]
    counts, totals = empty(256, tiles, dtype=i32), empty(2, 256, dtype=i32)
    ppack, qpack = empty(mp, 16), empty(mq, 16)
    prm, n_p, n_q = empty(16), empty(dtype=i64), empty(dtype=i64)
    _cuda.check(lib.svcm_merge_sort(
        ptrs(pplanes), mp, ptrs(qplanes), mq, radius.data_ptr(),
        parts.data_ptr(), live_base.data_ptr(), ptrs(sort),
        counts.data_ptr(), totals.data_ptr(), ppack.data_ptr(),
        qpack.data_ptr(), prm.data_ptr(), n_p.data_ptr(), n_q.data_ptr(),
        stream), "svcm_merge_sort")
    merge_prep_kernel.launches += 3 + 3 * _PREP_PASSES
    pkey, pidx, qidx = sort[0], sort[1], sort[5]

    qpos, qtab = empty(query_cap, 4), empty(query_cap, QF)
    ranges = empty(2 * ROWS, query_cap, dtype=i32)
    q_path = empty(query_cap, dtype=i64)
    ppos, ptab = empty(photon_cap, 4), empty(photon_cap, PF)
    _cuda.check(lib.svcm_merge_bake(
        ptrs(pplanes), mp, n_ph, ppack.data_ptr(), pidx.data_ptr(),
        pkey.data_ptr(), photon_cap, ppos.data_ptr(), ptab.data_ptr(),
        ptrs(qplanes), mq, n, qpack.data_ptr(), qidx.data_ptr(), query_cap,
        qpos.data_ptr(),
        qtab.data_ptr(), ranges.data_ptr(), q_path.data_ptr(), n_paths,
        (ctypes.c_longlong * 22)(
            *(v for t in mats for v in (t.data_ptr(), t.stride(0)))),
        m, prm.data_ptr(), n_p.data_ptr(), n_q.data_ptr(), stream),
        "svcm_merge_bake")
    merge_prep_kernel.launches += (photon_cap > 0) + (query_cap > 0)
    return MergeTables(qpos=qpos, qtab=qtab, ranges=ranges, ppos=ppos,
                       ptab=ptab, q_path=q_path, n_p=n_p, n_q=n_q)


# csrc/merge_prep.cu's kTile (the slots a block of its slot and sort
# passes takes) and kPasses (the sort's passes, of three launches each).
_PREP_TILE = 2048
_PREP_PASSES = 4

# Launches on the device, as ops/sweep.py's counters (graphs.py adds a
# capture's launches at each replay; counter ``merge.prep_launches``): 17
# a preparation.
merge_prep_kernel.launches = 0

# The photon rows the last preparation sorted: the slots of its photon
# tables (every rank's, after the sharded all-gather), a static size,
# counted at capture on a card; reported as the counter
# ``merge.photon_rows``.
merge_prep.photon_rows = 0
trace.report_counters("merge", lambda: {
    "merge.photon_rows": merge_prep.photon_rows})


# ---------------------------------------------------------------------------
# The cell walk: plain version and Hopper kernel
# ---------------------------------------------------------------------------


def candidate_pairs(ranges):
    """Yield ``(query [k], photon [k])`` int64 index chunks of every
    (query, photon) pair the ranges list, in walk order (query, then
    range, then photon), at most ``hashgrid.MAX_PAIRS`` per chunk unless
    one query has more."""
    lo = ranges[:ROWS].T.long()
    counts = ranges[ROWS:].T.long() - lo
    for q0, q1, c0, c1 in query_chunks(counts.sum(1)):
        qr, photon, _, _, _ = expand_pairs(lo[q0:q1], counts[q0:q1], c1 - c0)
        yield torch.div(qr, ROWS, rounding_mode="floor") + q0, photon


def merge_cells_plain(qpos, qtab, ranges, ppos, ptab, r2, vc_weight, *,
                      max_path_length: int, min_path_length: int, ppm: bool,
                      n_live=None):
    """Plain PyTorch version of csrc/merge_cells.cu -> [3, rows].

    Rows at or past ``n_live`` (default: every row) are dead and give 0,
    as the kernel's. Expands the live rows' ranges into (query, photon)
    pairs, tests them with the position tables as the kernel's walk does,
    evaluates the pairs that pass and sums per query deterministically (on
    the CPU in the kernel's walk order)."""
    n_q = qtab.shape[0]
    dev = qtab.device
    if n_live is not None:
        live = torch.arange(n_q, device=dev) < n_live
        ranges = torch.where(live, ranges, 0)
    r2 = _dev_scalar(r2, dev)
    vc_weight = _dev_scalar(vc_weight, dev)
    out = torch.zeros((n_q, 3), dtype=torch.float32, device=dev)
    for qs, ps in candidate_pairs(ranges):
        d = qpos[qs] - ppos[ps]
        tlen = qpos[qs, 3] + ppos[ps, 3]
        keep = torch.nonzero(
            (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] <= r2)
            & (tlen <= max_path_length) & (tlen >= min_path_length)
        ).flatten()
        qs, ps = qs[keep], ps[keep]
        q, p = qtab[qs], ptab[ps]
        blocks = _dense_block(
            r2, vc_weight, lambda j: q[:, j], lambda j: p[:, j],
            max_path_length=max_path_length,
            min_path_length=min_path_length, ppm=ppm,
        )
        out += deterministic_index_add(n_q, qs, torch.stack(blocks, dim=1))
    return out.T.contiguous()


def merge_cells_kernel(qpos, qtab, ranges, ppos, ptab, r2, vc_weight, *,
                       max_path_length: int, min_path_length: int, ppm: bool,
                       n_live=None):
    """Launch csrc/merge_cells.cu -> [3, rows] per-query RGB sums.

    The grid covers every row of the tables (the static query cap); the
    kernel reads the live query count ``n_live`` (default: every row), r^2
    and the MIS weight from device memory, so a CUDA graph's replay takes
    each iteration's values without new launch arguments. Python numbers
    are filled into device scalars first (outside a capture only: a
    capture would freeze them)."""
    req = _cuda.require
    dev = qtab.device
    n_q, n_p = qtab.shape[0], ptab.shape[0]
    req(qpos.shape == (n_q, 4) and qtab.shape == (n_q, QF),
        "merge_cells_kernel: qpos [n_q, 4], qtab [n_q, QF]")
    req(ranges.shape == (2 * ROWS, n_q),
        "merge_cells_kernel: ranges [2*ROWS, n_q]")
    req(ppos.shape == (n_p, 4) and ptab.shape == (n_p, PF),
        "merge_cells_kernel: ppos [n_p, 4], ptab [n_p, PF]")
    tables = (qpos, qtab, ranges, ppos, ptab)
    for t in tables:
        dt = torch.int32 if t is ranges else torch.float32
        req(t.device == dev, "merge_cells_kernel: one device")
        req(t.dtype == dt, f"merge_cells_kernel: expected {dt}")
        req(t.is_contiguous(), "merge_cells_kernel: contiguous tables only")
        req(t.data_ptr() % 16 == 0,
            "merge_cells_kernel: tables must be 16-byte aligned (float4)")
        req(not t.requires_grad, "merge_cells_kernel is forward-only")
    req(2 * ROWS * n_q < 2 ** 31 and n_p < 2 ** 31,
        "merge_cells_kernel: tables too large for int32 indices")
    req(dev.type == "cuda", "merge_cells_kernel needs CUDA tensors")
    live = (torch.full((), n_q, dtype=torch.int32, device=dev)
            if n_live is None else n_live.to(torch.int32))
    scalars = (live, _dev_scalar(r2, dev).to(torch.float32),
               _dev_scalar(vc_weight, dev).to(torch.float32))
    for t in scalars:
        req(t.device == dev and t.numel() == 1,
            "merge_cells_kernel: n_live, r2 and vc_weight are one value "
            "each on the tables' device")

    out = torch.empty((3, n_q), dtype=torch.float32, device=dev)
    if n_q == 0:
        return out
    lib = _cuda.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.svcm_merge_cells(
        *(t.data_ptr() for t in tables), out.data_ptr(), n_q,
        *(t.data_ptr() for t in scalars), int(max_path_length),
        int(min_path_length), int(bool(ppm)), stream,
    )
    _cuda.check(status, "svcm_merge_cells")
    merge_cells_kernel.launches += 1
    return out


# Launches on the device, as ops/sweep.py's counters (graphs.py adds a
# capture's launches at each replay of the whole-iteration graph).
merge_cells_kernel.launches = 0


def merge_cells(qpos, qtab, ranges, ppos, ptab, r2, vc_weight, **kw):
    """Per-query merge sums: the plain version on CPU, the kernel on CUDA."""
    fn = merge_cells_plain if qtab.device.type == "cpu" else \
        merge_cells_kernel
    return fn(qpos, qtab, ranges, ppos, ptab, r2, vc_weight, **kw)


# ---------------------------------------------------------------------------
# Post + the whole stage
# ---------------------------------------------------------------------------


def merge_post(out, qtab, q_path, vm_normalization, n_paths: int) -> V3:
    """Scale per-query sums by camera throughput x vm normalization and sum
    them into the owning path -> color_add V3 [n_paths], deterministically
    (framebuffer.deterministic_index_add; dead rows carry the sentinel
    path ``n_paths`` and add nothing)."""
    scaled = out * qtab[:, 29:32].T * vm_normalization
    z = deterministic_index_add(n_paths, q_path, scaled.T)
    return V3(z[:, 0], z[:, 1], z[:, 2])


def merge_stage(scene, misc, queries, light_verts, ppm: bool,
                max_path_length: int, min_path_length: int,
                n_paths: int, photon_cap: int | None = None,
                query_cap: int | None = None, with_stats: bool = False):
    """Vertex merging over all recorded camera queries -> color_add V3
    [n_paths]; with ``with_stats``, ``(color_add, overflow, stats)``:
    overflow = int64 (live photons > photon_cap) + (live queries >
    query_cap), stats = int64 [candidate pairs, live photons, live
    queries], all on the device (no host read: the stage runs inside a
    CUDA graph). Caps as :func:`merge_prep`; on overflow the sums are
    those of the first cap rows and the caller re-renders. ``n_paths`` is
    the query tables' column count; the photon table may have more columns
    (the sharded all-gather: merge_prep derives each side's path lengths
    and owners from its own column count). Stamps the stage clocks'
    ``merge_prep`` after the tables, with the live photons, and
    ``merge_kernel`` after the sums, with the candidate pairs: the sum of
    the live queries' range lengths, which the walk visits (trace.py)."""
    t = merge_prep(scene, misc, queries, light_verts, n_paths, photon_cap,
                   query_cap)
    trace.stamp("merge_prep", count=t.n_p)
    out = merge_cells(
        *t[:5], misc.radius_sqr, misc.mis_vc_weight, n_live=t.n_q,
        max_path_length=max_path_length, min_path_length=min_path_length,
        ppm=ppm,
    )
    z = merge_post(out, t.qtab, t.q_path, misc.vm_normalization, n_paths)
    # Dead and out-of-bbox queries have empty ranges.
    pairs = (t.ranges[ROWS:] - t.ranges[:ROWS]).sum().to(torch.int64)
    if with_stats:
        overflow = ((t.n_p > t.ptab.shape[0]).to(torch.int64)
                    + (t.n_q > t.qtab.shape[0]).to(torch.int64))
        z = z, overflow, torch.stack([pairs, t.n_p, t.n_q])
    trace.stamp("merge_kernel", count=pairs)
    return z
