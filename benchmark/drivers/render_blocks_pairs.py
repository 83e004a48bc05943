"""Progressive rendering on one card through the pair merge: the traffic
of ``render_blocks`` (``render.render`` a block at a time, the accumulator
carried, one host read a block, a window of the traffic's seconds), judged
by the plain pair merge (``reference/pairs.py``) in place of the cell
merge's reference.

The pair merge visits a bucket's photons twice where two probe cells of a
query share the bucket, as SmallVCM's hash grid does; the cell merge
visits each photon once, so its reference is not this configuration's
answer. No ``merge_counts`` are recorded: there is no cell-merge kernel to
price."""

from __future__ import annotations

import time

from ..harness import checks as C
from ..harness import spec
from ..harness import trace as T
from ..harness.context import Context, Outcome
from . import _progressive as P

# The configuration file's group of limits that this driver's checks use.
LIMITS = "render"


def run(ctx: Context) -> Outcome:
    import torch

    from smallvcm_tpu_torch import graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.scene.scene import load_cornell_box

    from ..reference import pairs as ref

    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    config = ctx.config
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    scene = load_cornell_box(tuple(config["resolution"]),
                             config["scene_mask"], device=dev)
    cfg = P.render_config(R, config, ctx.base_seed)
    prog = P.Progressive(R, scene, cfg)
    k = R.auto_block_size(cfg, cfg.algorithm)
    warm = P.set_up(prog, k, ctx.start_epoch)
    target = P.target_block(ctx.seed, ctx.seconds, warm)
    spec.apply_fault(ctx.fault)

    spans = []
    with P.replay_hook(torch, graphs, spans, ctx.trace and cuda):
        setup_s = time.time() - ctx.start_epoch
        w = P.window(prog, k, ctx.seconds, target)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    record = dict(setup_s=setup_s, window_s=w["window_s"],
                  iterations=w["iterations"], peak_bytes=peak, world=1)
    device = P.device_info(torch, dev, peak, 1)
    breakdown = None
    if ctx.trace and cuda:
        record["block_gaps_ms"] = T.block_gaps_ms(w["block_ends"])
        record["replay_idle_share"] = T.replay_idle_share(spans)
        record.update(P.traced_blocks(torch, prog, k))
        it = record["profile"]
        device.update(busy_s=it["busy_s"], window_s=it["window_s"])
        breakdown = dict(device_ops=T.device_ops(it),
                         idle_gaps=[list(g) for g in it["idle_gaps"]])

    start, before, after = (w["checked"][0],
                            *(None if t is None else t.cpu()
                              for t in w["checked"][1:]))
    got = after.double() - (0.0 if before is None else before.double())
    del prog, scene, w
    if cuda:
        torch.cuda.empty_cache()
    want = ref.block_sum(config, ctx.base_seed, start, k, dev)
    checks = C.held(C.image_gaps(got, want, k, before, after),
                    config["limits"][LIMITS])
    failed = 0 if all(c.ok for c in checks) else k
    return Outcome(record=record, checks=checks,
                   attempted=record["iterations"], failed=failed,
                   device=device, breakdown=breakdown,
                   replay=dict(start=start, k=k, before=before, after=after))


def control_checks(ctx: Context, replay: dict, dtype) -> list:
    """The block's checks with the pair reference's sum in ``dtype`` put
    in the program's place (the float32 pair reference judges it, with the
    rounding allowance of the program's own accumulators)."""
    import torch

    from ..reference import compute, pairs

    dev = torch.device("cuda", 0) if ctx.device != "cpu" else \
        torch.device("cpu")
    scene = compute.build_scene(ctx.config, dev)
    args = (ctx.config, ctx.base_seed, replay["start"], replay["k"], dev)
    want = pairs.block_sum(*args, scene=scene)
    got = pairs.block_sum(*args, dtype=dtype, scene=scene)
    return C.held(C.image_gaps(got, want, replay["k"], replay["before"],
                               replay["after"]),
                  ctx.config["limits"][LIMITS])
