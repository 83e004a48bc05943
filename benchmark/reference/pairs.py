"""The plain pair merge: VCM's vertex merging through SmallVCM's hash grid,
the answer the benchmark judges the port's pair merge by (``merge_backend
"xla"``, ``algorithms/vcm.py::merge_stage`` in the port).

One iteration is the frozen copy's light and camera stages
(``svcm.algorithms.vcm``), then :func:`merge`, written from SmallVCM's
``HashGrid`` (hashgrid.hxx:32-214) and ``RangeQuery::Process``
(vertexcm.hxx:130-169):

* the photon bbox over the live light vertices; cells of 2r, the inverse
  cell size ``1 / (2 r)`` rounded in float32;
* each cell's integer coordinates hashed, as uint32 arithmetic (in int64
  with masks), into ``8 * n_paths`` buckets, and the photons counting-sorted
  into them, stably (hashgrid.hxx:56-107);
* each query probes its own cell and its neighbours on the side of the
  cell centre, 2x2x2 cells (hashgrid.hxx:124-138), and visits every photon
  of each probed bucket: two probe cells that share a bucket visit its
  photons twice, as SmallVCM's grid does, and a bucket's photons of
  another cell fail the distance test;
* a visited photon within r (distance squared at most r^2) whose full
  path length lies in [min, max] contributes the camera BSDF toward
  ``-photon.in_dir`` times the MIS weight 1 / (w_light + 1 + w_camera)
  [tech. rep. (37)-(39)] (1 for ppm) times the photon's throughput, the
  pdfs times the camera's and the photon's continuation probabilities;
* per query the sum times the camera throughput and the vm normalization,
  added to the query's path.

There are no caps, no truncation and no graphs; the pairs are expanded in
query chunks of at most ``hashgrid.MAX_PAIRS`` (the copy's
``query_chunks`` / ``expand_pairs``), and the sums are deterministic
(``deterministic_index_add``). It imports nothing of the port.

Departures from the published description, each also the port's:

* the bbox test is padded by r (SmallVCM rejects a query just outside the
  tight bbox; same-plane hits in float32 sit ulps outside it);
* the light vertices are the copy's slot tables, ``[bounce, path]`` in
  that order, so a bucket's photons come in slot order, not SmallVCM's
  path-major list, and a query's 8 cells are taken with x as the lowest
  bit of the probe index (SmallVCM's loop takes z): only the summation
  order differs;
* the bucket count is ``8 * n_paths`` (SmallVCM reserves the grid from its
  path count).
"""

from __future__ import annotations

import torch

from . import compute
from .svcm.algorithms import vcm
from .svcm.core.vec3 import V3, max_gt_zero
from .svcm.io.framebuffer import (add_color_at_pix, deterministic_index_add,
                                  new_fb_planes)
from .svcm.ops import bsdf as bsdf_ops
from .svcm.ops.hashgrid import expand_pairs, query_chunks
from .svcm.render import _VCM_FLAGS

_MASK = 0xFFFFFFFF
# hashgrid.hxx's GetCellIndex: the primes of the x, y and z coordinates.
_PRIMES = (73856093, 19349663, 83492791)


def _hash(coords, num_cells: int):
    """The bucket of integer cell coordinates (int64, maybe negative):
    ``(x * p0 ^ y * p1 ^ z * p2) % num_cells`` on their uint32 images."""
    h = None
    for c, p in zip(coords, _PRIMES):
        u = ((c & _MASK) * p) & _MASK
        h = u if h is None else h ^ u
    return h % num_cells


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def merge(scene, misc, queries, light_verts, ppm: bool,
          max_path_length: int, min_path_length: int, n_paths: int,
          num_cells: int | None = None) -> V3:
    """Vertex merging of every live query against every live photon ->
    color_add V3 [n_paths] (see the module's docstring). ``queries`` and
    ``light_verts`` are vertex tables [slots, paths] (the copy's
    ``StoredVertices`` or any tuple with its fields); ``misc`` holds the
    iteration's radius, r^2, vm normalization and MIS weight;
    ``num_cells`` the buckets (default ``8 * n_paths``)."""
    dev = queries.valid.device
    n_q_cols = queries.valid.shape[1]
    n_ph_cols = light_verts.valid.shape[1]
    flat = lambda a: a.reshape(-1)
    gather = lambda v, idx: V3(*(flat(c)[idx] for c in v))
    zero = torch.zeros((n_paths,), dtype=torch.float32, device=dev)
    out = V3(zero, zero, zero)

    p_slot = torch.nonzero(flat(light_verts.valid)).flatten()
    q_slot = torch.nonzero(flat(queries.valid)).flatten()
    if p_slot.numel() == 0 or q_slot.numel() == 0:
        return out
    radius = _f32(misc.radius, dev)
    radius_sqr = _f32(misc.radius_sqr, dev)
    num_cells = 8 * n_paths if num_cells is None else num_cells

    # The grid: bbox, cells of 2r, buckets, a stable counting sort.
    ppos = [flat(c)[p_slot] for c in light_verts.position]
    mins = [a.min() for a in ppos]
    maxs = [a.max() for a in ppos]
    inv_cell = torch.reciprocal(radius * 2.0)
    bucket = _hash([torch.floor((a - mn) * inv_cell).long()
                    for a, mn in zip(ppos, mins)], num_cells)
    order = torch.sort(bucket, stable=True).indices
    count = torch.bincount(bucket, minlength=num_cells)
    start = torch.cumsum(count, 0) - count

    # The queries' 8 probed buckets and their photon ranges.
    qpos = [flat(c)[q_slot] for c in queries.position]
    inside = torch.ones_like(q_slot, dtype=torch.bool)
    for a, mn, mx in zip(qpos, mins, maxs):
        inside = inside & (a >= mn - radius) & (a <= mx + radius)
    rel = [(a - mn) * inv_cell for a, mn in zip(qpos, mins)]
    cell = [torch.floor(r).long() for r in rel]
    side = [torch.where(r - torch.floor(r) < 0.5, -1, 1) for r in rel]
    probed = torch.stack([
        _hash([c + (s if j >> k & 1 else 0)
               for k, (c, s) in enumerate(zip(cell, side))], num_cells)
        for j in range(8)], dim=1)                        # [Q, 8]
    counts = torch.where(inside[:, None], count[probed], 0)
    starts = start[probed]

    n_live_q = q_slot.shape[0]
    q_len = torch.div(q_slot, n_q_cols, rounding_mode="floor") + 1
    p_len_all = torch.div(p_slot, n_ph_cols, rounding_mode="floor") + 1
    mats = scene.materials
    sums = torch.zeros((n_live_q, 3), dtype=torch.float32, device=dev)
    for q0, q1, c0, c1 in query_chunks(counts.sum(1)):
        qc, sorted_pos, _, _, _ = expand_pairs(starts[q0:q1], counts[q0:q1],
                                               c1 - c0)
        qi = torch.div(qc, 8, rounding_mode="floor") + q0
        pi = order[sorted_pos]
        d = [ppos[k][pi] - qpos[k][qi] for k in range(3)]
        tlen = p_len_all[pi] + q_len[qi]
        ok = ((d[0] * d[0] + d[1] * d[1] + d[2] * d[2] <= radius_sqr)
              & (tlen <= max_path_length) & (tlen >= min_path_length))
        keep = torch.nonzero(ok).flatten()
        qi, pi = qi[keep], pi[keep]
        qs, ps = q_slot[qi], p_slot[pi]

        all_on = torch.ones_like(qs, dtype=torch.bool)
        cam_b = bsdf_ops.setup(mats, gather(queries.in_dir, qs),
                               gather(queries.normal, qs),
                               flat(queries.mat_id)[qs], all_on)
        ph_in = gather(light_verts.in_dir, ps)
        ph_b = bsdf_ops.setup(mats, ph_in, gather(light_verts.normal, ps),
                              flat(light_verts.mat_id)[ps], all_on)
        factor, _, dir_pdf, rev_pdf = bsdf_ops.evaluate(mats, cam_b, -ph_in)
        dir_pdf = dir_pdf * cam_b.cont_prob
        rev_pdf = rev_pdf * ph_b.cont_prob
        if ppm:
            mis = torch.ones_like(dir_pdf)
        else:
            w_light = (flat(light_verts.d_vcm)[ps] * misc.mis_vc_weight
                       + flat(light_verts.d_vm)[ps] * dir_pdf)
            w_camera = (flat(queries.d_vcm)[qs] * misc.mis_vc_weight
                        + flat(queries.d_vm)[qs] * rev_pdf)
            mis = 1.0 / (w_light + 1.0 + w_camera)
        contrib = (factor * mis) * gather(light_verts.throughput, ps)
        live = max_gt_zero(factor)
        sums += deterministic_index_add(
            n_live_q, torch.where(live, qi, n_live_q), contrib.to_array())

    scaled = (gather(queries.throughput, q_slot).to_array()
              * misc.vm_normalization) * sums
    z = deterministic_index_add(
        n_paths, torch.remainder(q_slot, n_q_cols), scaled)
    return V3(z[:, 0], z[:, 1], z[:, 2])


def iteration_image(scene, config: dict, base_seed: int, iteration: int):
    """One iteration's image [resY, resX, 3] float32: the copy's light and
    camera stages, then :func:`merge`; an algorithm that does not merge is
    ``compute.iteration_image``'s."""
    alg = config["algorithm"]
    if alg not in _VCM_FLAGS or not _VCM_FLAGS[alg][1]:
        return compute.iteration_image(scene, config, base_seed, iteration)
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    res_x, res_y = config["resolution"]
    n = res_x * res_y
    dev = scene.device
    max_len, min_len = config["max_path_length"], config["min_path_length"]
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    misc = vcm.compute_misc(scene, iteration, n, config["radius_factor"],
                            config["radius_alpha"], use_vc, use_vm)
    verts, fb, _ = vcm.trace_light_paths(
        scene, misc, pix, iteration, new_fb_planes(res_x, res_y, dev),
        base_seed, max_len, min_len, use_vc, use_vm, lt_only, config["rng"])
    color, queries, _ = vcm._camera_stage(
        scene, misc, verts, pix, iteration, res_x, base_seed, max_len,
        min_len, use_vc, use_vm, ppm, config["rng"])
    color = color + merge(scene, misc, queries, verts, ppm, max_len, min_len,
                          n)
    return add_color_at_pix(fb, pix, color).to_array()


@torch.no_grad()
def block_sum(config: dict, base_seed: int, start: int, k: int, device,
              dtype=torch.float32, scene=None):
    """The sum of iterations ``start`` .. ``start + k - 1`` through the
    pair merge, added one by one from zeros in ``dtype`` -> float32
    [resY, resX, 3]: ``compute.block_sum``'s meaning (bfloat16 is the
    control)."""
    compute._no_tf32()
    scene = compute.build_scene(config, device) if scene is None else scene
    res_x, res_y = config["resolution"]
    acc = torch.zeros((res_y, res_x, 3), dtype=dtype, device=device)
    for it in range(start, start + k):
        acc = acc + iteration_image(scene, config, base_seed, it).to(dtype)
    return acc.float()
