"""Progressive rendering sharded over the cards of one host: one process a
card joined in one ``torch.distributed`` group by the port's own launcher
(``parallel/multihost.spawn``, as ``cli --devices N``), every rank calling
``render.render`` with the group, a block at a time.

Each rank's set-up is the single card's (render_blocks.py) on its share of
the paths. The window starts on every rank after a barrier; after each
block rank 0 decides whether the seconds have passed and broadcasts it
(``comm.broadcast_flag``: one small collective a block, the harness's own
cost, whose host time each rank measures and rank 0 says on stderr). The
check: one block of the window drawn from the seed, its sum on rank 0
(every rank holds the summed image) against the reference's
single-process sum of the same iterations, which the main process works
out once the ranks have left. Each rank looks for JAX in its own modules
once its window has closed; the main process refuses the run if any rank
found one."""

from __future__ import annotations

import sys
import time

from ..harness import checks as C
from ..harness import env, spec
from ..harness import trace as T
from ..harness.context import Context, Outcome
from . import _progressive as P

# The configuration file's group of limits that this driver's checks use.
LIMITS = "render"

EXCHANGE_COUNTERS = ("all_gather_columns", "ring_shift")


def _exchange_bytes(comm) -> int:
    return sum(getattr(getattr(comm, n, None), "bytes", 0)
               for n in EXCHANGE_COUNTERS)


def rank_main(config: dict, seed: int, seconds: float, trace: bool,
              start_epoch: float, fault: str | None) -> dict:
    """One rank's run (module level: spawned ranks import it) -> what its
    window and, in a traced run, its profile measured; rank 0 adds the
    checked block's sum."""
    import torch

    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.algorithms import vcm
    from smallvcm_tpu_torch.parallel import comm, multihost
    from smallvcm_tpu_torch.scene.scene import load_cornell_box

    group = multihost.global_group()
    rank = comm.rank(group)
    cuda = torch.cuda.is_available() and config.get("_device") != "cpu"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    scene = load_cornell_box(tuple(config["resolution"]),
                             config["scene_mask"], device=dev)
    cfg = P.render_config(R, config, seed & 0xFFFFFFFF, group=group)
    prog = P.Progressive(R, scene, cfg)
    k = R.auto_block_size(cfg, cfg.algorithm)
    warm = P.set_up(prog, k, start_epoch, quiet=rank != 0)
    target = P.target_block(seed, seconds, warm)
    spec.apply_fault(fault)

    flag_s = []

    def rank0_decides(go: bool) -> bool:
        t = time.perf_counter()
        go = comm.broadcast_flag(go, group)
        flag_s.append(time.perf_counter() - t)
        return go

    spans = []
    torch.distributed.barrier(group)
    if cuda:
        torch.cuda.synchronize(dev)
    bytes0 = _exchange_bytes(comm)
    with P.replay_hook(torch, graphs, spans, trace and cuda):
        setup_s = time.time() - start_epoch
        w = P.window(prog, k, seconds, target, keep_going=rank0_decides,
                     quiet=rank != 0)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    out = dict(setup_s=setup_s, window_s=w["window_s"],
               iterations=w["iterations"], peak_bytes=peak,
               exchange_bytes=_exchange_bytes(comm) - bytes0, block=k,
               flag_ms=[1e3 * sum(flag_s) / len(flag_s), 1e3 * max(flag_s)],
               kind=torch.cuda.get_device_name(dev) if cuda else "cpu")
    if trace and cuda:
        out["block_gaps_ms"] = T.block_gaps_ms(w["block_ends"])
        out["replay_idle_share"] = T.replay_idle_share(spans)
        out.update(P.traced_blocks(torch, prog, k))
        if rank == 0 and cfg.algorithm in ("vcm", "bpm", "ppm"):
            out["merge_counts"] = P.merge_counts(
                vcm, scene, cfg, out["profiled_iteration"])
        torch.distributed.barrier(group)
    if rank == 0:
        out["checked"] = (w["checked"][0],
                          *(None if t is None else t.cpu()
                            for t in w["checked"][1:]))
    out["forbidden"] = env.forbidden_modules()
    return out


def _aggregate(ranks: list, trace: bool) -> tuple:
    """The ranks' records -> (the cell's record, busy_s, window_s)."""
    r0 = ranks[0]
    record = dict(setup_s=r0["setup_s"], window_s=r0["window_s"],
                  iterations=r0["iterations"],
                  peak_bytes=max(r["peak_bytes"] for r in ranks),
                  exchange_bytes=max(r["exchange_bytes"] for r in ranks),
                  world=len(ranks))
    if not trace or "profile" not in r0:
        return record, None, None
    its = [r["profile"] for r in ranks]
    idle = [r["replay_idle_share"] for r in ranks
            if r["replay_idle_share"] is not None]
    # The profiled block as one record: counts the most of any rank,
    # kernel seconds summed over the ranks (the rooflines price the whole
    # group's work), NCCL seconds the most of any rank.
    names = {}
    for s in its:
        for n, v in s["device_s_by_name"].items():
            names[n] = names.get(n, 0.0) + v
    profile = dict(its[0], kernels=max(s["kernels"] for s in its),
                     device_s_by_name=names)
    first_merge = sum(r.get("first_merge_s", 0.0) for r in ranks)
    record.update(
        block=r0["block"], block_gaps_ms=r0["block_gaps_ms"],
        replay_idle_share=max(idle) if idle else None,
        syncs_per_block=max(r["syncs_per_block"] for r in ranks),
        block_launch_calls=max(r["block_launch_calls"] for r in ranks),
        profiled_rays=r0["profiled_rays"], profile=profile,
        nccl_s_per_iter=max(T.kernel_seconds(s, "nccl", "NCCL")
                            / s["iterations"] for s in its),
        first_merge_s=first_merge, photon_reads=len(ranks))
    if "merge_counts" in r0:
        record["merge_counts"] = r0["merge_counts"]
    busy = sum(s["busy_s"] for s in its) / len(its)
    return record, busy, its[0]["window_s"]


def run(ctx: Context) -> Outcome:
    import torch

    from smallvcm_tpu_torch.parallel import multihost

    from ..reference import compute as ref

    config = dict(ctx.config, _device=ctx.device)
    world = int(config["ranks"])
    ranks = multihost.spawn(world, ctx.device, rank_main, config, ctx.seed,
                            ctx.seconds, ctx.trace, ctx.start_epoch,
                            ctx.fault)
    found = sorted({m for r in ranks for m in r["forbidden"]})
    if found:
        raise env.ForbiddenModules(found)
    flag = [r["flag_ms"] for r in ranks]
    print(f"[window] end-of-window broadcast a block: rank 0 mean "
          f"{flag[0][0]:.3f} ms, slowest {flag[0][1]:.3f}; the most of any "
          f"rank mean {max(f[0] for f in flag):.3f} ms", file=sys.stderr,
          flush=True)
    record, busy, span = _aggregate(ranks, ctx.trace)
    cuda = ctx.device != "cpu"
    device = dict(platform="gpu" if cuda else "cpu", kind=ranks[0]["kind"],
                  count=world, memory_peak_bytes=int(record["peak_bytes"]))
    breakdown = None
    if busy is not None:
        device.update(busy_s=busy, window_s=span)
        it0 = ranks[0]["profile"]
        breakdown = dict(device_ops=T.device_ops(it0),
                         idle_gaps=[list(g) for g in it0["idle_gaps"]])
    start, before, after = ranks[0]["checked"]
    got = after.double() - (0.0 if before is None else before.double())
    k = ranks[0]["block"]
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    want = ref.block_sum(ctx.config, ctx.base_seed, start, k, dev)
    checks = C.held(C.image_gaps(got, want, k, before, after),
                    ctx.config["limits"][LIMITS])
    failed = 0 if all(c.ok for c in checks) else k
    return Outcome(record=record, checks=checks,
                   attempted=record["iterations"], failed=failed,
                   device=device, breakdown=breakdown,
                   replay=dict(start=start, k=k, before=before, after=after))


def control_checks(ctx: Context, replay: dict, dtype) -> list:
    """The checks with the reference in ``dtype`` in the program's place."""
    return P.control_checks(ctx, replay, dtype)
