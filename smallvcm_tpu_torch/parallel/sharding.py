"""Multi-process execution: paths sharded over a torch.distributed group.

Port of ``smallvcm_tpu/parallel/sharding.py``. The JAX package shards the
path/pixel batch over a 1-D ``paths`` mesh axis with ``shard_map``; here
the "mesh" is a ``torch.distributed`` process group whose ranks each own a
contiguous path shard: rank r renders global path ids
``[r * n / W, (r + 1) * n / W)`` on its own device.

- camera path i and light path i share a rank (the only pairing vertex
  connection needs, vertexcm.hxx:498-526), so connections stay local;
- for merging, light vertices are all-gathered or passed around a ring
  (algorithms/vcm.py::_merge, parallel/comm.py);
- each rank splats light-tracing contributions into its own full-frame
  image, and the images are summed over ranks (comm.framebuffer_sum);
- the counter-based RNG keys off global path ids, so the paths are the
  single-process paths for any rank count.

Unlike the JAX package, which swaps both Pallas kernels for XLA under a
mesh, every rank runs the port's kernels on its own card: the cell merge,
the closest-hit sweep and the any-hit sweep.

An iteration on a rank is one function, run through ``graphs.stage``:
``vcm.sharded_iteration_stage`` for the VCM family (light walk, splat
flush, camera stage, the photon exchange, the merge at static caps, the
own-pixel add, the sums over ranks), replayed by
``vcm.render_block_with_stats(group=...)``, and :func:`simple_stage` for
el and pt (the pass and its sums). On an NCCL group's card it is ONE CUDA
graph, collectives included, the counterpart of the JAX package's one
``shard_map`` program an iteration (``_vcm_program``). A gloo group's
collectives stage CUDA tensors through host memory, so there (and on CPU
ranks, and under autograd) ``graphs.why_eager`` runs the same function
eagerly. The merges run at static caps over the factors' share of the
paths, and their overflow and stats are summed over the ranks, so every
rank grows to the same caps (render.py).

The JAX package's ``training_step_spec`` has no counterpart: every rank
holds the whole scene, so parameters are replicated by construction, and
diff.sharded_loss_and_grad sums the ranks' parameter gradients.
"""

from __future__ import annotations

import torch

from .. import graphs, trace
from ..algorithms import eyelight, pathtracer, vcm
from . import comm


def sharded_render_iteration_with_stats(
    group,
    scene,
    iteration: int,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    radius_factor: float = 0.003,
    radius_alpha: float = 0.75,
    use_vc: bool = True,
    use_vm: bool = True,
    light_trace_only: bool = False,
    ppm: bool = False,
    vm_exchange: str = "allgather",
    rng_kind: str = "threefry",
    merge_backend: str = "auto",
    pair_factor: float = 24.0,
    photon_factor: float | None = None,
    query_factor: float | None = None,
    merge_chunks: int = 1,
):
    """One VCM-family iteration with paths sharded over ``group``
    (``vcm.sharded_iteration_stage`` through graphs.stage) -> (image
    [resY, resX, 3] summed over ranks, ray_count, merge overflow int64,
    merge stats int64 [candidate pairs, live photons, live queries]), all
    replicated on every rank: the counts, the overflow and the stats are
    summed over ranks, as the JAX package psums them (vcm.py:1387-1391),
    so every rank reads the same numbers and grows its caps alike.

    ``vm_exchange`` picks the photon exchange for merging: "allgather"
    gives every rank the whole photon table (one collective, the
    single-process table element for element); "ring" keeps photons
    resident and passes them around the ranks, merging one visiting table
    at a time. Both are exact (merging is additive over photons). Both
    merges run at the caps of ``photon_factor`` and ``query_factor`` over
    this rank's paths (photons over all of them under the all-gather), the
    pair merge also at ``pair_factor`` in ``merge_chunks`` query chunks
    (algorithms/vcm.py::_merge); with the factors None the pair merge
    takes the JAX defaults (3.0) and the cell merge its tables' slot
    counts. Differentiable in the scene's parameters. On a card the
    outputs are a graph's, which the next iteration overwrites: clone
    what you keep."""
    static = vcm.sharded_static(vcm.iteration_static(
        res_x, res_y, base_seed, max_path_length, min_path_length, use_vc,
        use_vm, light_trace_only, ppm, rng_kind, photon_factor, query_factor,
        merge_backend, pair_factor, merge_chunks), vm_exchange, group)
    return graphs.stage(
        vcm.sharded_iteration_stage, scene, (),
        vcm.iteration_scalars(scene, iteration, res_x * res_y, radius_factor,
                              radius_alpha, use_vc, use_vm), static)


def sharded_render_iteration(group, scene, iteration: int, res_x: int,
                             res_y: int, **kw) -> torch.Tensor:
    """The image of :func:`sharded_render_iteration_with_stats` (same
    keywords), replicated on every rank."""
    return sharded_render_iteration_with_stats(
        group, scene, iteration, res_x, res_y, **kw)[0]


def simple_stage(scene, iteration, algorithm: str, res_x: int, res_y: int,
                 base_seed: int, max_path_length: int, min_path_length: int,
                 rng_kind: str, world: int, rank: int, group):
    """One el or pt pass over this rank's pixels with its sums over the
    group -> (image, ray_count), replicated, with the iteration a 0-dim
    int64 device tensor and no host read: on an NCCL group's card ONE CUDA
    graph (graphs.stage), the JAX package's ``_SIMPLE_PROGRAMS``
    (sharding.py:194-250)."""
    pix = comm.shard_ids(res_x * res_y, world, rank, scene.device)
    with trace.paused("finish"):    # stamped after the sums over ranks
        if algorithm == "el":
            img, rays = eyelight.render_pass(scene, pix, iteration, res_x,
                                             res_y, base_seed, rng_kind)
        else:
            img, rays = pathtracer.render_pass(
                scene, pix, iteration, res_x, res_y, base_seed,
                max_path_length, min_path_length, rng_kind)
    out = comm.framebuffer_sum(img, group), comm.all_reduce_sum(rays, group)
    trace.stamp("finish")
    return out


def sharded_simple_iteration(
    group,
    algorithm: str,
    scene,
    iteration: int,
    res_x: int,
    res_y: int,
    base_seed: int = 1234,
    max_path_length: int = 10,
    min_path_length: int = 0,
    rng_kind: str = "threefry",
):
    """One eye-light ("el") or path-tracer ("pt") iteration with pixels
    sharded over ``group`` -> (image, ray_count), replicated. Each rank
    renders its pixels into a full-frame image; every pixel has one owner,
    so the sum adds exact zeros and the image equals the single-process
    image bit for bit. The pass and its sums are :func:`simple_stage`
    through graphs.stage. On a card the outputs are a graph's, which the
    next iteration overwrites: clone what you keep."""
    if algorithm not in ("el", "pt"):
        raise ValueError(f"algorithm must be 'el' or 'pt', not {algorithm!r}")
    return graphs.stage(
        simple_stage, scene, (), (iteration,),
        (algorithm, res_x, res_y, base_seed, max_path_length,
         min_path_length, rng_kind, comm.world_size(group), comm.rank(group),
         group))
