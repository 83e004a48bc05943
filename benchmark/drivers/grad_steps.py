"""Gradient steps on one card: ``diff.loss_and_grad`` of the configuration's
algorithm at its size, the L2 loss against a target, the parameters held
fixed, a block of the traffic's steps between host reads.

Set-up: the scene on the card; the target, the program's own progressive
render (``render.render``) of the configuration's ``target`` iterations
at the scene's published parameters through its merge, under the run's
base seed plus ``seed_offset``; the starting parameters (every material's
diffuse reflectance times ``start.diffuse_scale``); the pair merge's caps
fitted at them from the run's seed (``diff.fit_caps``); then step 0 (the
kernels' load, autograd eager), step 1 (the step's graph capture) and one
warm block. The window: blocks of steps, the iteration rising by one a
step, until the traffic's seconds have passed; a block's one host read
holds its summed loss, the truncation count (``diff.truncated_steps``),
the forwards' rays (``diff.traced_rays``) and the stage clocks' rows. A step whose pair merge truncated counts as
failed. The check: one step of the window drawn from the seed, its loss
and every gradient leaf against ``reference/grad.py`` at the same
parameters, target and iteration. The target is data that both sides take
alike: the gradient 2/N sum (image - target) d image / d parameter holds
every pixel's derivative for any finite target other than the step's own
image, so a faulty target cannot hide a fault in the step (a target that
is not finite fails the check); the render that makes it is judged by
the render cells.

A port without the graphed step (no ``diff.fit_caps``) cannot run this
traffic: the run stops at once with a non-zero exit."""

from __future__ import annotations

import sys
import time

import numpy as np

from ..harness import checks as C
from ..harness import spec
from ..harness import trace as T
from ..harness.context import Context, Outcome
from . import _progressive as P

# The configuration file's group of limits that this driver's checks use.
LIMITS = "grad"
# A gradient value's gap is measured against its reference value plus
# this share of its leaf's mean, so that values near 0 do not divide by ~0,
GRAD_FLOOR = 1e-3
# and plus this share of its lane mass (reference/grad.py), so that a value
# whose lanes' terms cancel is judged on the scale of those terms.
MASS_SHARE = 0.1


def grad_gaps(loss, grads, want_loss, want_grads, want_mass=None) -> dict:
    """Gaps of a step's loss and gradient leaves against the reference's:
    ``loss_rel_gap``, |l_p - l_r| / |l_r|; ``grad_max_gap``, the largest
    |g_p - g_r| / (|g_r| + floor + MASS_SHARE m_r) over every leaf's
    values, the floor 1e-3 times the leaf's mean |g_r| (of every leaf's,
    where the leaf's reference gradient is zero throughout; a gap of 0 is
    0) and ``m_r`` the value's lane mass (``want_mass``, zero where not
    given); and ``grad_rel_l1``, the sum of |g_p - g_r| over the sum of
    |g_r|. A value that is not finite is an infinite gap."""
    import torch

    f64 = lambda t: torch.as_tensor(t).detach().to("cpu", torch.float64)
    lp, lr = float(loss), float(want_loss)
    gp = [f64(g).reshape(-1) for g in grads]
    gr = [f64(g).reshape(-1) for g in want_grads]
    mr = [torch.zeros_like(b) for b in gr] if want_mass is None else \
        [f64(m).reshape(-1) for m in want_mass]
    if len(gp) != len(gr) or any(a.shape != b.shape for a, b in zip(gp, gr)) \
            or any(m.shape != b.shape for m, b in zip(mr, gr)):
        raise ValueError("gradient leaves differ in number or shape")
    inf = float("inf")
    if not (np.isfinite(lp) and all(bool(torch.isfinite(a).all())
                                    for a in gp)):
        return dict(loss_rel_gap=inf, grad_max_gap=inf, grad_rel_l1=inf)
    loss_gap = abs(lp - lr) / abs(lr) if lr else (0.0 if lp == lr else inf)
    every = torch.cat(gr).abs().mean()
    worst, diff_sum, ref_sum = 0.0, 0.0, 0.0
    for a, b, m in zip(gp, gr, mr):
        d = (a - b).abs()
        floor = GRAD_FLOOR * (b.abs().mean() if bool((b != 0).any())
                               else every)
        q = torch.where(d == 0, 0.0, d / (b.abs() + floor + MASS_SHARE * m))
        worst = max(worst, float(q.max()) if q.numel() else 0.0)
        diff_sum += float(d.sum())
        ref_sum += float(b.abs().sum())
    return dict(loss_rel_gap=loss_gap, grad_max_gap=worst,
                grad_rel_l1=diff_sum / ref_sum if ref_sum else
                (0.0 if diff_sum == 0 else inf))


def _flat(params) -> list:
    """The leaves of ``diff.Params`` in its order (a colour's three planes
    each)."""
    return [t for f in params for t in (f if isinstance(f, tuple) else (f,))]


class Steps:
    """The job's gradient steps: ``block(k)`` takes the next ``k`` steps
    with the clocks armed (``trace.block``), makes the block's one host
    read and returns the rays its forwards traced; keeps the step at
    ``check_at`` (and the last one)."""

    def __init__(self, torch, diff, trace, scene, params, target,
                 config: dict, kw: dict):
        self.torch, self.diff, self.trace = torch, diff, trace
        self.scene, self.params, self.target = scene, params, target
        self.alg = config["algorithm"]
        self.res = config["resolution"]
        self.n_iterations = config["n_iterations"]
        self.kw = kw
        self.dev = scene.device
        self.done = 0
        self.check_at = None
        self.checked = self.last = None
        self.loss_sum = 0.0
        self.truncated = self.rays = 0

    def block(self, k: int) -> int:
        torch = self.torch
        it0 = self.done
        total = torch.zeros((), dtype=torch.float32, device=self.dev)
        with self.trace.block(self.dev, it0, k) as clock:
            for j in range(k):
                it = it0 + j
                loss, grads = self.diff.loss_and_grad(
                    self.scene, self.params, self.target, it, self.alg,
                    *self.res, n_iterations=self.n_iterations, **self.kw)
                total = total + loss
                self.last = (it, loss, grads)
                if it == self.check_at:
                    self.checked = self.last
            parts = [total.reshape(1).double(),
                     self.diff.truncated_steps(self.dev).reshape(1).double(),
                     self.diff.traced_rays(self.dev).reshape(1).double()]
            if clock is not None:
                parts.append(clock.rows())
            values = torch.cat(parts).cpu()
            if clock is not None:
                clock.record(values[3:])
        self.done += k
        self.loss_sum += float(values[0])
        self.truncated = int(values[1])
        rays, self.rays = int(values[2]) - self.rays, int(values[2])
        return rays


def run(ctx: Context) -> Outcome:
    import torch

    from smallvcm_tpu_torch import diff, graphs
    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch import trace
    from smallvcm_tpu_torch.scene.scene import load_cornell_box

    from ..reference import grad as ref

    if not hasattr(diff, "fit_caps"):
        raise SystemExit("the port has no graphed gradient step "
                         "(diff.fit_caps): it cannot run grad_steps")
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    config = ctx.config
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    res_x, res_y = config["resolution"]
    scene = load_cornell_box((res_x, res_y), config["scene_mask"],
                             device=dev)
    t0 = time.time()
    tcfg = P.render_config(
        R, dict(config, block=0,
                merge_backend=config["target"]["merge_backend"]),
        (ctx.base_seed + config["target"]["seed_offset"]) & 0xFFFFFFFF)
    tcfg.iterations = config["target"]["iterations"]
    target = R.render(scene, tcfg)[0].clone()
    base = diff.extract_params(scene)
    params = base._replace(diffuse=base.diffuse
                           * config["start"]["diffuse_scale"])
    common = dict(base_seed=ctx.base_seed,
                  max_path_length=config["max_path_length"],
                  min_path_length=config["min_path_length"],
                  radius_factor=config["radius_factor"],
                  radius_alpha=config["radius_alpha"])
    kw = dict(common, **diff.fit_caps(scene, params, config["algorithm"],
                                      res_x, res_y, **common))
    print(f"[setup] target of {tcfg.iterations} iterations and caps "
          f"{time.time() - t0:.2f} s: {kw}", file=sys.stderr, flush=True)
    steps = Steps(torch, diff, trace, scene, params, target, config, kw)
    k = int(ctx.traffic["block"])
    warm = P.set_up(steps, k, ctx.start_epoch)
    n_sure = max(1, int(0.8 * ctx.seconds / max(warm / k, 1e-6)))
    steps.check_at = steps.done + int(
        np.random.default_rng(ctx.seed).integers(0, n_sure))
    truncated_before = steps.truncated
    spec.apply_fault(ctx.fault)

    spans, ends = [], []
    with P.replay_hook(torch, graphs, spans, ctx.trace and cuda):
        setup_s = time.time() - ctx.start_epoch
        first = steps.done
        t_start = time.perf_counter()
        while True:
            steps.block(k)
            ends.append(time.perf_counter())
            if ends[-1] - t_start >= ctx.seconds:
                break
    P.say_window("blocks", [t_start] + ends)
    n_steps = steps.done - first
    failed = steps.truncated - truncated_before
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    record = dict(setup_s=setup_s, window_s=ends[-1] - t_start,
                  iterations=n_steps, peak_bytes=peak, world=1,
                  mean_loss=steps.loss_sum / max(steps.done, 1),
                  truncated_steps=failed)
    device = P.device_info(torch, dev, peak, 1)
    breakdown = None
    if ctx.trace and cuda:
        record["block_gaps_ms"] = T.block_gaps_ms(ends)
        record["replay_idle_share"] = T.replay_idle_share(spans)
        record["syncs_per_block"] = T.count_syncs(torch,
                                                  lambda: steps.block(k))
        rays, dv, host, wall = T.profiled(torch, lambda: steps.block(k))
        it = T.summarize(dv, host, wall, k)
        record.update(block=k, block_launch_calls=it["launch_calls"],
                      profiled_rays=rays, profile=it)
        device.update(busy_s=it["busy_s"], window_s=it["window_s"])
        breakdown = dict(device_ops=T.device_ops(it),
                         idle_gaps=[list(g) for g in it["idle_gaps"]])

    it_checked, loss, grads = steps.checked or steps.last
    got_loss = loss.cpu()
    got = [g.cpu() for g in _flat(grads)]
    leaves = [t.cpu() for t in _flat(params)]
    target_cpu = target.cpu()
    del steps, scene, base, params, target, loss, grads
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.time()
    want_loss, want, mass = ref.loss_and_grad(
        config, ctx.base_seed, it_checked, leaves, target_cpu, dev)
    print(f"[check] step {it_checked} against the reference, "
          f"{time.time() - t0:.2f} s", file=sys.stderr, flush=True)
    checks = C.held(grad_gaps(got_loss, got, want_loss, want, mass),
                    config["limits"][LIMITS])
    if not all(c.ok for c in checks):
        failed += 1
    return Outcome(record=record, checks=checks, attempted=n_steps,
                   failed=failed, device=device, breakdown=breakdown,
                   replay=dict(iteration=it_checked, params=leaves,
                               target=target_cpu))


def control_checks(ctx: Context, replay: dict, dtype) -> list:
    """The checked step's checks with the reference's step in ``dtype``
    in the program's place (the float32 reference judges it)."""
    import torch

    from ..reference import compute
    from ..reference import grad as ref

    dev = torch.device("cuda", 0) if ctx.device != "cpu" else \
        torch.device("cpu")
    scene = compute.build_scene(ctx.config, dev)
    args = (ctx.config, ctx.base_seed, replay["iteration"], replay["params"],
            replay["target"], dev)
    want_loss, want, mass = ref.loss_and_grad(*args, scene=scene)
    got_loss, got, _ = ref.loss_and_grad(*args, dtype=dtype, scene=scene)
    return C.held(grad_gaps(got_loss, got, want_loss, want, mass),
                  ctx.config["limits"][LIMITS])
