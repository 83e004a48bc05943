"""Rendering: algorithm registry, the block loop, merge caps, time budget.

Port of ``smallvcm_tpu/render.py`` (the reference's ``CreateRenderer``
factory, config.hxx:112-143, and ``render()`` loop, smallvcm.cxx:52-151)
for all seven algorithms, with the JAX package's block runner:

* Blocks: ``render()`` runs ``block`` iterations (``--block``;
  :func:`auto_block_size`: 8 for the VCM family, 64 for el and pt at
  512x512) per call of the runner, with one host read at the block's end
  (overflow, merge stats, rays, luminance). On a card each iteration of
  the VCM family is ONE CUDA graph (``vcm.iteration_stage``, graphs.py)
  and each pass of el and pt another, replayed back to back.
* Static merge caps: the merges' photon and query tables have static
  widths (``photon_factor`` / ``query_factor`` times the paths) and the
  pair merge (``merge_backend="xla"``) static pair rows (``pair_factor``
  times the paths, in query chunks of ~16M pair rows:
  ``vcm.merge_chunks_for``), sized from the exact demand of iteration 0
  (``vcm.merge_measure_iteration``: photons and queries x1.03, pairs
  x1.15, bucketed) and kept in the port's own cache,
  ``~/.cache/smallvcm_tpu_torch/caps.json`` (``SMALLVCM_TPU_TORCH_CACHE``
  names another directory). On overflow the runner grows the caps by the
  JAX package's rule (photons and queries to the need x1.1, pairs to the
  need x1.1 or the old cap x1.26, bucketed, never shrinking), saves them,
  and renders the SAME block again: the counter-based RNG makes that
  exact.
* Schedule: a pure function of the iterations done under ``-i`` (full
  blocks, then single iterations), so a resumed run reproduces the
  partition; under ``-t`` two single iterations, then blocks of 1 or the
  auto block as the time left allows. The runner adds each iteration to
  the running accumulator in turn, so the image's bits do not depend on
  the partition either (``--block 1`` and ``--block 8`` agree bit for
  bit).

With ``RenderConfig.group`` (the JAX package's ``mesh``), every rank of the
group runs :func:`render` with the same configuration: each renders its
path shard (parallel/sharding.py) and holds the summed image, with one
host read a block (under ``-t``, blocks of one). On an NCCL group each
iteration is ONE CUDA graph with the photon exchange, the merge and the
sums over ranks inside it (``vcm.sharded_iteration_stage``; el and pt:
``sharding.simple_stage``), the counterpart of the JAX package's one
program an iteration. On a gloo group, whose collectives stage through
host memory and cannot be captured, an iteration runs stage by stage (the
photon exchange sits between the graphs of the light and camera stages).
The choice is static, by the group's backend (``comm.capturable``). Both
merges run there at the caps above, from the configured factors (sharded
runs measure nothing and write no cache); the overflow and stats are
summed over the ranks, so every rank grows to the same caps over its
share of the paths. Under a time budget rank 0 decides each step and
broadcasts it, so every rank runs the same number of iterations; only
rank 0 prints.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from . import graphs, trace
from .algorithms import eyelight, pathtracer, vcm
from .io.framebuffer import total_luminance
from .parallel import comm, sharding
from .parallel.multihost import is_coordinator
from .scene.scene import SceneData

ALGORITHMS = ("el", "pt", "lt", "ppm", "bpm", "bpt", "vcm")

ALGORITHM_NAMES = {
    "el": "eye light",
    "pt": "path tracing",
    "lt": "light tracing",
    "ppm": "progressive photon mapping",
    "bpm": "bidirectional photon mapping",
    "bpt": "bidirectional path tracing",
    "vcm": "vertex connection and merging",
}

# VertexCM family flags: (use_vc, use_vm, light_trace_only, ppm)
# (vertexcm.hxx:222-244).
_VCM_FLAGS = {
    "lt": (False, False, True, False),
    "ppm": (False, True, False, True),
    "bpm": (False, True, False, False),
    "bpt": (True, False, False, False),
    "vcm": (True, True, False, False),
}

TRACE_BACKENDS = ("auto", "pallas", "xla")

DEFAULT_BLOCK = 8
# el/pt carry no merge caps or overflow: a bigger block costs only
# checkpoint granularity.
DEFAULT_BLOCK_SIMPLE = 64
# Grow-and-retry rounds of one block before the runner gives up.
MAX_GROWS = 8


@dataclass
class RenderConfig:
    """Mirror of the reference Config (config.hxx:52-109) plus the JAX
    package's backend knobs, with the same names and defaults."""

    algorithm: str = "vcm"
    iterations: int = 1
    max_time: float = -1.0
    radius_factor: float = 0.003
    radius_alpha: float = 0.75
    base_seed: int = 1234
    max_path_length: int = 10
    min_path_length: int = 0
    resolution: tuple = (512, 512)
    rng_kind: str = "threefry"  # or "tea" (the reference's old_rng flavor)
    # Static caps of the merges' photon and query tables and of the pair
    # merge's pair rows, as shares of the paths (vcm.merge_caps, vcm._merge).
    pair_factor: float = 24.0
    photon_factor: float = 3.0
    query_factor: float = 3.0
    # Photon merge: "auto"/"pallas" = the cell merge (the Hopper kernel on
    # CUDA, its plain version on the CPU); "xla" = the differentiable
    # pair merge at static caps (algorithms/vcm.py::merge_stage).
    merge_backend: str = "auto"
    # Closest-hit sweep: "auto"/"pallas" = the Hopper kernel on CUDA, the
    # dense plain sweep on the CPU; "xla" names the dense sweep, which is
    # the kernel's test reference and is never substituted for it on a
    # card: on CUDA it raises.
    trace_backend: str = "auto"
    # Caps frozen = sized by measurement or the cache (or by the caller);
    # the block loop still grows them, and renders the block again, on the
    # rare overflow.
    merge_caps_frozen: bool = False
    # Iterations per block, one host read each (0 = auto_block_size). Any
    # partition gives the same image, bit for bit.
    block_size: int = 0
    # Photon exchange between ranks for merging: "allgather" or "ring"
    # (parallel/sharding.py); unused by a single process.
    vm_exchange: str = "allgather"
    # torch.distributed process group whose ranks share the paths
    # (parallel/multihost.py); None renders every path in this process.
    group: object = None


def ppm_downgrade_needed(scene: SceneData) -> bool:
    """PPM cannot handle mixed specular+non-specular materials; the reference
    self-downgrades to BPM after scanning the scene (vertexcm.hxx:246-278)."""
    mats = scene.materials
    host = lambda a: a.detach().cpu().numpy()
    diffuse = host(mats.diffuse.max_component())
    phong = host(mats.phong.max_component())
    mirror = host(mats.mirror.max_component())
    ior = host(mats.ior)
    has_non_specular = (diffuse > 0) | (phong > 0)
    has_specular = (mirror > 0) | (ior > 0)
    return bool(np.any(has_non_specular & has_specular))


def resolve_algorithm(scene: SceneData, algorithm: str) -> str:
    if algorithm == "ppm" and ppm_downgrade_needed(scene):
        return "bpm"
    return algorithm


def check_backends(scene: SceneData, cfg: RenderConfig) -> None:
    """Reject backends the port does not know, and the dense sweep on a
    card: it is the sweep kernel's reference, not a fallback."""
    if cfg.merge_backend not in vcm.MERGE_BACKENDS:
        raise ValueError(f"merge_backend must be one of "
                         f"{vcm.MERGE_BACKENDS}, not {cfg.merge_backend!r}")
    if cfg.trace_backend not in TRACE_BACKENDS:
        raise ValueError(f"trace_backend must be one of {TRACE_BACKENDS}, "
                         f"not {cfg.trace_backend!r}")
    if cfg.trace_backend == "xla" and scene.device.type == "cuda":
        raise ValueError(
            "trace_backend 'xla' (the dense plain sweep) does not run on a "
            "CUDA device: the sweep kernel traces every ray there; use "
            "'auto' or 'pallas'")


def merge_chunks(cfg: RenderConfig) -> int:
    """Query chunks of the pair merge at ``cfg``'s pair cap (the JAX
    package's rule, vcm.merge_chunks_for); 1 for the cell merge, which
    never chunks."""
    if cfg.merge_backend != "xla":
        return 1
    return vcm.merge_chunks_for(cfg.pair_factor,
                                cfg.resolution[0] * cfg.resolution[1])


def _caps_kw(cfg: RenderConfig) -> dict:
    """The merge caps of ``cfg`` as keywords of the VCM iteration
    functions: the pair merge's, and the cell merge's under a group; none
    for the single process's stage-by-stage cell merge, whose tables are
    the slot counts."""
    if cfg.merge_backend != "xla":
        return ({} if cfg.group is None else
                dict(photon_factor=cfg.photon_factor,
                     query_factor=cfg.query_factor))
    return dict(pair_factor=cfg.pair_factor,
                photon_factor=cfg.photon_factor,
                query_factor=cfg.query_factor, merge_chunks=merge_chunks(cfg))


def _sharded_vcm_iteration(scene: SceneData, cfg: RenderConfig, alg: str,
                           iteration: int):
    """This rank's share of one sharded VCM-family iteration, stage by
    stage -> (image, rays, overflow, stats), summed over the group's
    ranks."""
    res_x, res_y = cfg.resolution
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    return sharding.sharded_render_iteration_with_stats(
        cfg.group, scene, iteration, res_x, res_y, cfg.base_seed,
        cfg.max_path_length, cfg.min_path_length, cfg.radius_factor,
        cfg.radius_alpha, use_vc, use_vm, lt_only, ppm, cfg.vm_exchange,
        cfg.rng_kind, cfg.merge_backend, **_caps_kw(cfg))


def render_iteration(scene: SceneData, cfg: RenderConfig, alg: str,
                     iteration: int):
    """One iteration of the resolved algorithm, stage by stage -> (image,
    ray_count); with ``cfg.group``, this rank's shard, summed over the
    group's ranks. The pair merge, and under a group the cell merge too,
    runs at ``cfg``'s caps and a truncation is not retried here (the
    block runner retries). On a card el's and
    pt's image and count are their graph's outputs, which the next
    iteration overwrites: clone what you keep."""
    res_x, res_y = cfg.resolution
    if cfg.group is not None:
        if alg in ("el", "pt"):
            return sharding.sharded_simple_iteration(
                cfg.group, alg, scene, iteration, res_x, res_y,
                cfg.base_seed, cfg.max_path_length, cfg.min_path_length,
                cfg.rng_kind)
        return _sharded_vcm_iteration(scene, cfg, alg, iteration)[:2]
    if alg == "el":
        return eyelight.render_iteration(
            scene, iteration, res_x, res_y, cfg.base_seed, cfg.rng_kind)
    if alg == "pt":
        return pathtracer.render_iteration(
            scene, iteration, res_x, res_y, cfg.base_seed,
            cfg.max_path_length, cfg.min_path_length, cfg.rng_kind)
    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    return vcm.render_iteration(
        scene, iteration, res_x, res_y, cfg.base_seed, cfg.max_path_length,
        cfg.min_path_length, cfg.radius_factor, cfg.radius_alpha,
        use_vc=use_vc, use_vm=use_vm, light_trace_only=lt_only, ppm=ppm,
        rng_kind=cfg.rng_kind, merge_backend=cfg.merge_backend,
        **_caps_kw(cfg))


def _maybe_inject_test_fault(done: int) -> None:
    """Test hook for the isolate.py supervisor (tests/test_torch_isolate.py).

    With SMALLVCM_TEST_FAULT_AT=k set, raises a CUDA-fault-shaped error
    once ``done`` reaches k, at most SMALLVCM_TEST_FAULT_TIMES times across
    processes, counted in the SMALLVCM_TEST_FAULT_COUNTER file, so a
    supervised run faults, respawns from its checkpoint, and must still
    produce the byte-identical image (the JAX package's hook,
    smallvcm_tpu/render.py:496-519).
    """
    at = os.environ.get("SMALLVCM_TEST_FAULT_AT")
    if not at or done < int(at):
        return
    times = int(os.environ.get("SMALLVCM_TEST_FAULT_TIMES", "1"))
    path = os.environ.get("SMALLVCM_TEST_FAULT_COUNTER")
    count = 0
    if path and os.path.exists(path):
        count = int(Path(path).read_text() or 0)
    if count >= times:
        return
    if path:
        Path(path).write_text(str(count + 1))
    raise RuntimeError("CUDA error: injected test fault "
                       "(SMALLVCM_TEST_FAULT_AT)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Merge caps: measure once, persist, reuse, grow on overflow.
# ---------------------------------------------------------------------------


def _bucket(needed: float, n: int) -> float:
    """Smallest m*2^e >= needed with mantissa m in {4,5,6,7}, as a factor
    of n (so the caps in the graph keys repeat exactly). The ~1.25x ladder
    keeps padding waste under ~25% (every op downstream of compaction runs
    at cap width, not live width). The JAX package's, verbatim."""
    needed = max(needed, 1024)
    e = max(0, int(needed).bit_length() - 3)
    for m in (4, 5, 6, 7, 8):
        if m << e >= needed:
            return float(m << e) / n
    return float(8 << e) / n


def _grow(factor: float, need: int, n: int) -> float:
    """A cap factor grown to the measured ``need`` (x1.1, bucketed); never
    smaller than ``factor`` (the JAX package's rule, render.py:474-477)."""
    return max(factor, _bucket(need * 1.1, n))


def _grow_pairs(factor: float, pairs: int, n: int) -> float:
    """The pair factor after an overflow: the measured pairs x1.1 or the
    old cap x1.26, bucketed, whichever is larger (render.py:474-476 of the
    JAX package). The old cap's term grows it even when the pairs were
    hidden by a photon or query overflow, or only a chunk overflowed."""
    return max(_bucket(pairs * 1.1, n), _bucket(factor * n * 1.26, n))


def _caps_cache_file() -> Path:
    root = os.environ.get("SMALLVCM_TPU_TORCH_CACHE",
                          os.path.expanduser("~/.cache/smallvcm_tpu_torch"))
    return Path(root) / "caps.json"


def _merge_backend_key(cfg: RenderConfig) -> str:
    """The JAX package's resolved backend name for the key: the cell merge
    is the counterpart of its Pallas merge."""
    return "xla" if cfg.merge_backend == "xla" else "pallas"


def _caps_key(scene: SceneData, cfg: RenderConfig, alg: str,
              backend: str) -> str:
    """The JAX package's key format (render.py:208-222): caps are measured
    at iteration 0 under one seed and generator."""
    res_x, res_y = cfg.resolution
    n_tri = int(scene.tri_mat.shape[0])
    n_sph = int(scene.sph_mat.shape[0])
    n_lights = int(scene.lights.kind.shape[0])
    return (
        f"{alg}|{backend}|{res_x}x{res_y}|tri{n_tri}sph{n_sph}"
        f"l{n_lights}|pl{cfg.max_path_length}-{cfg.min_path_length}"
        f"|r{cfg.radius_factor}a{cfg.radius_alpha}"
        f"|s{cfg.base_seed}|{cfg.rng_kind}"
    )


CAPS_FIELDS = ("pair_factor", "photon_factor", "query_factor")


def _load_cached_caps(key: str):
    """The cached caps of ``key``, or None: a missing or unreadable file,
    or an entry without every field of CAPS_FIELDS (one written before
    the pair merge had caps) is a miss."""
    try:
        caps = json.loads(_caps_cache_file().read_text()).get(key)
    except (OSError, ValueError):
        return None
    if not isinstance(caps, dict) or any(f not in caps for f in CAPS_FIELDS):
        return None
    return caps


def _save_cached_caps(key: str, caps: dict) -> None:
    """Merge ``caps`` into the cache file, written whole to a temporary
    file and renamed over it, so a process that reads it meanwhile sees
    the old or the new file, never half of one."""
    path = _caps_cache_file()
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        data = {}
    data[key] = caps
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(data, indent=1, sort_keys=True))
        os.replace(tmp, path)
    except OSError:
        pass


def _caps_of(cfg: RenderConfig) -> dict:
    return {f: getattr(cfg, f) for f in CAPS_FIELDS}


def _ensure_merge_caps(scene: SceneData, cfg: RenderConfig, alg: str) -> str:
    """Freeze the merge caps of ``cfg`` before the first block -> "frozen"
    (set by the caller or earlier), "cached" or "measured".

    Sizes from the cache when the key is there, else measures the exact
    demand of iteration 0 (its merge radius is the largest,
    vertexcm.hxx:294-299; vertex counts vary across iterations only by
    Monte Carlo noise): photons and queries x1.03, the pair merge's pairs
    x1.15, bucketed (the JAX package's render.py:246-324). The cell key
    sizes ``pair_factor`` too, never below the configured one, so a later
    pair-merge run of the configuration starts from a fitted pair cap.
    Correctness never depends on this: the block loop grows the caps and
    renders the block again on overflow. Unless frozen, the span
    ``render.caps_measure`` (trace.py) holds it, its ``how`` what it
    returns."""
    if cfg.merge_caps_frozen:
        return "frozen"
    with trace.span("render.caps_measure") as s:
        s.attrs["how"] = how = _size_merge_caps(scene, cfg, alg)
    return how


def _size_merge_caps(scene: SceneData, cfg: RenderConfig, alg: str) -> str:
    key = _caps_key(scene, cfg, alg, _merge_backend_key(cfg))
    cached = _load_cached_caps(key)
    if cached:
        for f in CAPS_FIELDS:
            setattr(cfg, f, cached[f])
        cfg.merge_caps_frozen = True
        return "cached"
    use_vc, _, _, ppm = _VCM_FLAGS[alg]
    res_x, res_y = cfg.resolution
    n = res_x * res_y
    pairs, n_p, n_q = vcm.merge_measure_iteration(
        scene, 0, res_x, res_y, cfg.base_seed, cfg.max_path_length,
        cfg.min_path_length, cfg.radius_factor, cfg.radius_alpha, use_vc,
        ppm, cfg.rng_kind)
    pair_factor = _bucket(pairs * 1.15, n)
    cfg.pair_factor = (pair_factor if cfg.merge_backend == "xla"
                       else max(cfg.pair_factor, pair_factor))
    cfg.photon_factor = _bucket(n_p * 1.03, n)
    cfg.query_factor = _bucket(n_q * 1.03, n)
    cfg.merge_caps_frozen = True
    _save_cached_caps(key, _caps_of(cfg))
    return "measured"


# ---------------------------------------------------------------------------
# Block runners: run(start, k, accum) -> Block, one host read a block.
# ---------------------------------------------------------------------------


class Block(NamedTuple):
    """One block's result: the running accumulator with the block's
    iterations added (a device tensor) and, from the block's one host
    read, its rays, merge stats (max over its iterations: [candidate
    pairs, live photons, live queries]) and the accumulator's total
    luminance and mean."""
    accum: torch.Tensor
    rays: int
    stats: tuple
    luminance: float
    mean: float


def _read_block(acc, rays, overflow, stats, clock=None):
    """The block's one host read (the span ``render.host_read``) ->
    (overflow, Block). With the block's stage clock (``trace.block``), its
    rows join the read and are kept when nothing overflowed."""
    one = lambda t: t.reshape(1).to(torch.float64)
    parts = [one(overflow), stats.to(torch.float64), one(rays),
             one(total_luminance(acc)), one(acc.mean())]
    if clock is not None:
        parts.append(clock.rows())
    with trace.span("render.host_read"):
        values = torch.cat(parts).cpu()
    ovf, pairs, n_p, n_q, r, lum, mean = values[:7].tolist()
    if clock is not None and ovf == 0:
        clock.record(values[7:].numpy())
    return int(ovf), Block(acc, int(r), (int(pairs), int(n_p), int(n_q)),
                           lum, mean)


def _make_block_runner(scene: SceneData, cfg: RenderConfig, alg: str):
    """Build run(start, k, accum) -> Block for the resolved algorithm.

    Merging algorithms in a single process size their caps here
    (:func:`_ensure_merge_caps`). The runner grows the caps and renders
    the same block again on overflow (at most MAX_GROWS times, then
    raises; each time counted in ``render.rerendered_blocks``), and reads
    the host once a block (twice when a block overflows). Each block arms the
    device's stage clocks (``trace.block``). A VCM-family iteration is one
    graph replay in a single process and on an NCCL group's rank, and runs
    stage by stage on a gloo group's rank."""
    res_x, res_y = cfg.resolution
    n = res_x * res_y
    dev = scene.device
    zero = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=dev)

    if alg in ("el", "pt"):
        def run_iterations(start, k, accum):
            with trace.block(dev, start, k) as clock:
                acc, rays = accum, zero()
                for j in range(k):
                    img, r = render_iteration(scene, cfg, alg, start + j)
                    acc = acc + img
                    rays = rays + r
                return _read_block(acc, rays, zero(), zero(3), clock)[1]

        return run_iterations

    use_vc, use_vm, lt_only, ppm = _VCM_FLAGS[alg]
    group = cfg.group
    if use_vm and group is None:
        _ensure_merge_caps(scene, cfg, alg)
    caps_key = _caps_key(scene, cfg, alg, _merge_backend_key(cfg))
    # Caps grow over this process's share of the paths (the JAX package's
    # n_shard). A sharded iteration's overflow and stats are summed over
    # the group's ranks, so every rank grows to the same caps from the
    # same numbers: no broadcast is needed.
    n_shard = n if group is None else n // comm.world_size(group)
    # One graph an iteration, or (a gloo group) stage by stage: static.
    one_graph = group is None or comm.capturable(group)

    def stage_key():
        """The iteration graph's function and static key at the caps."""
        static = vcm.iteration_static(
            res_x, res_y, cfg.base_seed, cfg.max_path_length,
            cfg.min_path_length, use_vc, use_vm, lt_only, ppm, cfg.rng_kind,
            cfg.photon_factor, cfg.query_factor, cfg.merge_backend,
            cfg.pair_factor, merge_chunks(cfg))
        if group is None:
            return vcm.iteration_stage, static
        return vcm.sharded_iteration_stage, vcm.sharded_static(
            static, cfg.vm_exchange, group)

    def render_block(start, k, accum):
        if one_graph:
            return vcm.render_block_with_stats(
                scene, start, res_x, res_y, k, cfg.base_seed,
                cfg.max_path_length, cfg.min_path_length,
                cfg.radius_factor, cfg.radius_alpha, use_vc=use_vc,
                use_vm=use_vm, light_trace_only=lt_only, ppm=ppm,
                photon_factor=cfg.photon_factor,
                query_factor=cfg.query_factor, rng_kind=cfg.rng_kind,
                accum=accum, pair_factor=cfg.pair_factor,
                merge_chunks=merge_chunks(cfg),
                merge_backend=cfg.merge_backend, group=group,
                vm_exchange=cfg.vm_exchange)[:4]
        # A gloo group: stage by stage, summed on the device, as the JAX
        # package's sharded runner (render.py:425-449).
        acc, rays, overflow, stats = accum, zero(), zero(), zero(3)
        for j in range(k):
            img, r, o, st = _sharded_vcm_iteration(scene, cfg, alg,
                                                   start + j)
            acc = acc + img
            rays = rays + r
            overflow = overflow + o
            stats = torch.maximum(stats, st)
        return acc, rays, overflow, stats

    def read_block(start, k, accum):
        with trace.block(dev, start, k) as clock:
            return _read_block(*render_block(start, k, accum), clock)

    def run_block(start, k, accum):
        for grows in range(MAX_GROWS + 1):
            if grows:
                render.rerendered_blocks += 1
            overflow, block = read_block(start, k, accum)
            if overflow == 0:
                return block
            # Grow every cap by the JAX package's rule (render.py:470-481),
            # never shrinking, drop the old caps' graph and render the
            # SAME block again: exact, because the RNG is counter-based.
            pairs, n_p, n_q = block.stats
            old = stage_key()
            if cfg.merge_backend == "xla":
                cfg.pair_factor = _grow_pairs(cfg.pair_factor, pairs, n_shard)
            cfg.photon_factor = _grow(cfg.photon_factor, n_p, n_shard)
            cfg.query_factor = _grow(cfg.query_factor, n_q, n_shard)
            if one_graph:
                graphs.drop(*old)
            if group is None:
                _save_cached_caps(caps_key, _caps_of(cfg))
            if is_coordinator():
                print(f"[smallvcm_tpu_torch] merge cap overflow; "
                      f"re-rendering block at iteration {start} with "
                      f"pair_factor={cfg.pair_factor} "
                      f"photon_factor={cfg.photon_factor} "
                      f"query_factor={cfg.query_factor}", flush=True)
        raise RuntimeError(f"merge caps still overflow after {MAX_GROWS} "
                           f"grows at iteration {start}")

    return run_block


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def auto_block_size(cfg: RenderConfig, alg: str) -> int:
    """Iterations per block: ``cfg.block_size``, else the JAX package's
    rule (render.py:527-541): 8 for the VCM family and 64 for el and pt at
    512x512, inversely with the pixel count (a block's device time and its
    checkpoint granularity stay about the same), at least 1."""
    n_pix = cfg.resolution[0] * cfg.resolution[1]
    base_block = (DEFAULT_BLOCK_SIMPLE if alg in ("el", "pt")
                  else DEFAULT_BLOCK)
    return cfg.block_size or max(
        1, min(base_block, (base_block * 512 * 512) // max(n_pix, 1))
    )


def render_single_iteration(scene: SceneData, cfg: RenderConfig,
                            iteration: int):
    """The image of one iteration (not averaged) of ``cfg.algorithm``
    through the block runner with a block of 1, a tensor of its own."""
    check_backends(scene, cfg)
    alg = resolve_algorithm(scene, cfg.algorithm)
    res_x, res_y = cfg.resolution
    zeros = torch.zeros((res_y, res_x, 3), dtype=torch.float32,
                        device=scene.device)
    return _make_block_runner(scene, cfg, alg)(iteration, 1, zeros).accum


@trace.span("render.render")
def render(scene: SceneData, cfg: RenderConfig, verbose: bool = False,
           accum=None, start_iter: int = 0, block_cb=None):
    """Progressive render on the scene's device.

    Returns (image [resY, resX, 3], seconds, iterations, rays). Like
    smallvcm.cxx:52-151: -t (max_time) takes precedence over -i; the image
    is the average over completed iterations. ``accum`` / ``start_iter``
    resume a previous accumulation (checkpoint.py): iterations continue at
    ``start_iter`` and ``iterations`` counts them all, resumed prefix
    included. Iterations run in blocks (:func:`auto_block_size`, the
    schedule in the module docstring), one host read each;
    ``block_cb(accum, iterations_done)`` fires after every block (the
    checkpoint hook). ``rays`` is the traced ray count of this call. With
    ``verbose``, prints one line per block: its iterations, the mean
    luminance and image mean so far, its rays and its wall time (its
    ``render.block`` span), for a merging algorithm the block's merge stats
    (the most candidate pairs, live photons and live queries of an
    iteration) and caps, and on a card the device ms of each stage, the
    median over the block's iterations (``trace.block_stages``). With
    ``cfg.group``, every rank of the group must call this with the same
    ``cfg``. The call is the span ``render.render``, each block a
    ``render.block`` inside it (trace.py).
    """
    check_backends(scene, cfg)
    res_x, res_y = cfg.resolution
    alg = resolve_algorithm(scene, cfg.algorithm)
    dev = scene.device
    runner = _make_block_runner(scene, cfg, alg)
    merging = alg in _VCM_FLAGS and _VCM_FLAGS[alg][1]
    accum = (torch.zeros((res_y, res_x, 3), dtype=torch.float32, device=dev)
             if accum is None else accum.to(dev))
    rays = 0
    done = start_iter
    # Under -t sharded ranks step one iteration at a time: each rank's
    # clock would choose its own block sizes. Under -i the schedule is a
    # function of ``done`` alone, the same on every rank.
    auto_block = (1 if cfg.group is not None and cfg.max_time > 0
                  else auto_block_size(cfg, alg))
    verbose = verbose and is_coordinator()
    # Test-only fault injection (tests/test_torch_isolate.py), resolved once.
    fault_hook = (_maybe_inject_test_fault
                  if os.environ.get("SMALLVCM_TEST_FAULT_AT") else None)

    def step(k):
        nonlocal accum, rays, done
        with trace.span("render.block", start=done, k=k) as span:
            block = runner(done, k, accum)
        accum = block.accum
        rays += block.rays
        done += k
        if verbose:
            line = (f"  iter {done - k}..{done - 1}: "
                    f"luminance={block.luminance / done:.1f} "
                    f"mean={block.mean / done:.9g} rays={block.rays} "
                    f"dt={span.seconds:.4f}s")
            if merging:
                line += (" pairs={} photons={} queries={}".format(
                    *block.stats) + f" pair_factor={cfg.pair_factor}"
                    f" photon_factor={cfg.photon_factor}"
                    f" query_factor={cfg.query_factor}")
            stages = trace.block_stages(dev)
            if stages:
                line += " stage_ms: " + " ".join(
                    f"{name}={ms:.3f}" for name, ms in stages.items())
            print(line, flush=True)
        if block_cb is not None:
            block_cb(accum, done)
        if fault_hook is not None:
            fault_hook(done)

    def in_budget() -> bool:
        # Each rank's clock would give its own iteration count and hang
        # the collectives: rank 0's clock decides for the group.
        go = time.perf_counter() - start < cfg.max_time
        if cfg.group is None:
            return go
        return comm.broadcast_flag(go, cfg.group)

    _sync(dev)
    start = time.perf_counter()
    if cfg.max_time > 0:
        # Two single iterations first (they settle the caps and give a
        # time an iteration), then blocks of 1 or the auto block as the
        # budget left allows. The block's host read ends it, so the
        # budget is wall time of finished iterations.
        while in_budget():
            rendered = done - start_iter
            if rendered < 2:
                step(1)
                continue
            spent = time.perf_counter() - start
            left = cfg.max_time - spent
            step(auto_block if left >= spent / rendered * auto_block else 1)
    else:
        # Full blocks, then singles: a pure function of ``done``, so a
        # resumed run reproduces the partition.
        while done < cfg.iterations:
            step(auto_block if cfg.iterations - done >= auto_block else 1)
    _sync(dev)
    elapsed = time.perf_counter() - start

    img = accum / done if done > 0 else accum
    return img, elapsed, done, rays


# Blocks rendered again after a merge cap overflow, reported to the trace.
render.rerendered_blocks = 0
trace.report_counters("render", lambda: {
    "render.rerendered_blocks": render.rerendered_blocks})
