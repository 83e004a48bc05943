"""What the render drivers share: the port's progressive render driven a
block at a time through ``render.render``, its window, and the traced
measurements of its blocks."""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from ..harness import trace as T


def render_config(R, config: dict, base_seed: int, group=None):
    """The port's RenderConfig for the configuration's file."""
    res_x, res_y = config["resolution"]
    return R.RenderConfig(
        algorithm=config["algorithm"], resolution=(res_x, res_y),
        base_seed=base_seed, max_path_length=config["max_path_length"],
        min_path_length=config["min_path_length"],
        radius_factor=config["radius_factor"],
        radius_alpha=config["radius_alpha"], rng_kind=config["rng"],
        merge_backend=config["merge_backend"],
        block_size=config["block"],
        vm_exchange=config.get("vm_exchange", "allgather"), group=group)


class Progressive:
    """One progressive render: ``block(k)`` renders the next ``k``
    iterations through ``render()``, the accumulator carried from call to
    call, and returns the call's ray count. ``render()`` synchronises at
    both ends, so a block's end is a host time."""

    def __init__(self, R, scene, cfg):
        self.R, self.scene, self.cfg = R, scene, cfg
        self.accum, self.done = None, 0

    def _keep(self, accum, done):
        self.accum = accum

    def block(self, k: int) -> int:
        self.cfg.iterations = self.done + k
        _, _, done, rays = self.R.render(
            self.scene, self.cfg, accum=self.accum, start_iter=self.done,
            block_cb=self._keep)
        self.done = done
        return rays


def set_up(prog: Progressive, k: int, start_epoch: float,
           quiet: bool = False) -> float:
    """The render's set-up: iteration 0 (the kernels' build or load, the
    merge caps' measurement), iteration 1 (the iteration graph's
    capture), one warm block of ``k``; says on stderr how long each took
    -> the warm block's seconds."""
    t = [time.time()]
    for n in (1, 1, k):
        prog.block(n)
        t.append(time.time())
    if not quiet:
        print(f"[setup] to the scene {t[0] - start_epoch:.2f} s, iteration 0 "
              f"{t[1] - t[0]:.2f} s, iteration 1 {t[2] - t[1]:.2f} s, warm "
              f"block of {k} {t[3] - t[2]:.2f} s", file=sys.stderr,
              flush=True)
    return t[3] - t[2]


def say_window(what: str, ends: list) -> None:
    """One stderr line: how many blocks or steps the window held and the
    host milliseconds each took (first, median, slowest)."""
    ms = sorted(1e3 * (b - a) for a, b in zip(ends, ends[1:]))
    first = 1e3 * (ends[1] - ends[0]) if len(ends) > 1 else 0.0
    print(f"[window] {len(ms)} {what}: first {first:.1f} ms, median "
          f"{ms[len(ms) // 2]:.1f}, fastest {ms[0]:.1f}, slowest "
          f"{ms[-1]:.1f}", file=sys.stderr, flush=True)


def target_block(seed: int, seconds: float, warm_block_s: float) -> int:
    """The block of the window whose sum is checked, drawn from the seed
    among the blocks the window will surely hold (the last block is
    checked if the window ends before it)."""
    n = max(1, int(0.8 * seconds / max(warm_block_s, 1e-6)))
    return int(np.random.default_rng(seed).integers(0, n))


def window(prog: Progressive, k: int, seconds: float, target: int,
           keep_going=None, quiet: bool = False) -> dict:
    """Blocks of ``k`` until ``seconds`` have passed (or, with
    ``keep_going(elapsed) -> bool``, until it says stop: a group's rank 0
    decides for every rank) -> window seconds, iterations, rays, each
    block's end time, and the checked block (start iteration, the
    accumulator before it and after it)."""
    ends, checked, last = [], None, None
    rays = 0
    t0 = time.perf_counter()
    n = 0
    while True:
        before, start = prog.accum, prog.done
        rays += prog.block(k)
        now = time.perf_counter()
        last = (start, before, prog.accum)
        if n == target:
            checked = last
        n += 1
        ends.append(now)
        go = now - t0 < seconds
        if keep_going is not None:
            go = keep_going(go)
        if not go:
            break
    if not quiet:
        say_window("blocks", [t0] + ends)
    return dict(window_s=now - t0, iterations=n * k, blocks=n, rays=rays,
                block_ends=ends, checked=checked or last, t0=t0)


def traced_blocks(torch, prog: Progressive, k: int) -> dict:
    """After the window: the host syncs of one block, then one more block
    under the profiler with the device -> record entries (the block's
    host launch calls, kernels, device seconds by kernel, busy and wall
    seconds, idle gaps; its rays; its first iteration's index and merge
    kernel seconds)."""
    syncs = T.count_syncs(torch, lambda: prog.block(k))
    it = prog.done
    rays, dev, host, wall = T.profiled(torch, lambda: prog.block(k))
    summary = T.summarize(dev, host, wall, k)
    merges = sorted((a, b) for name, a, b in dev
                    if "merge_cells_kernel" in name)
    return dict(block=k, syncs_per_block=syncs,
                block_launch_calls=summary["launch_calls"],
                profiled_iteration=it, profiled_rays=rays,
                first_merge_s=(merges[0][1] - merges[0][0]) / 1e9
                if merges else 0.0, profile=summary)


def merge_counts(vcm, scene, cfg, iteration: int) -> dict:
    """Live queries, live photons and candidate pairs of one merging
    iteration (``vcm.merge_measure_iteration``, eager, the whole image)."""
    res_x, res_y = cfg.resolution
    flags = {"vcm": (True, False), "bpm": (False, False),
             "ppm": (False, True)}
    use_vc, ppm = flags[cfg.algorithm]
    pairs, n_p, n_q = vcm.merge_measure_iteration(
        scene, iteration, res_x, res_y, cfg.base_seed, cfg.max_path_length,
        cfg.min_path_length, cfg.radius_factor, cfg.radius_alpha, use_vc,
        ppm, cfg.rng_kind)
    return dict(queries=n_q, photons=n_p, candidates=pairs)


def replay_hook(torch, graphs, spans, on: bool):
    return T.replay_spans(torch, graphs, spans) if on else \
        contextlib.nullcontext(False)


def device_info(torch, dev, peak_bytes: int, count: int) -> dict:
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=count, memory_peak_bytes=int(peak_bytes))


def control_checks(ctx, replay: dict, dtype) -> list:
    """The block's checks with the reference's sum in ``dtype`` put in the
    program's place (the float32 reference judges it, with the rounding
    allowance of the program's own accumulators)."""
    import torch

    from ..harness import checks as C
    from ..reference import compute as ref

    dev = torch.device("cuda", 0) if ctx.device != "cpu" else \
        torch.device("cpu")
    scene = ref.build_scene(ctx.config, dev)
    args = (ctx.config, ctx.base_seed, replay["start"], replay["k"], dev)
    want = ref.block_sum(*args, scene=scene)
    got = ref.block_sum(*args, dtype=dtype, scene=scene)
    return C.held(C.image_gaps(got, want, replay["k"], replay["before"],
                               replay["after"]),
                  ctx.config["limits"]["render"])
