#!/usr/bin/env python3
"""Scaling of the PyTorch/CUDA port over cards: 1 -> W ranks, VCM, scene 0.

The counterpart of ``scripts/scaling_bench.py`` (strong scaling) and of
``scripts/render_2048_mesh.py`` (the sharded-memory regime) for
``smallvcm_tpu_torch``. Imports nothing of JAX or of the JAX package.

Strong scaling (the default): VCM, scene 0, 512x512, on 1, 2 and 4 ranks,
one card a rank (NCCL, ``parallel/multihost.spawn``), with the all-gather
and with the ring photon exchange. One rank renders in this process; a
rank count above the visible cards is skipped, and said so. Every rank
renders through render.py's block runner, blocks of ``--iters`` (default
8) with one host read a block: on an NCCL group each iteration is one
CUDA graph with the exchange, the merge and the sums over ranks inside
(``vcm.sharded_iteration_stage``), so the graph is what is timed. Every
run uses the same merge caps, the configuration's default factors (3.0
photons and queries a path), frozen: the sharded runner measures nothing.
One warm block (iteration 0 eager, 1 captures, the rest replay), then
``--repeats`` timed blocks (default 5), each ended by its host read.
Printed, for each rank: ms/iteration (the median block, min and max), on
a card the host launch calls an iteration and the host syncs a block
(``bench_torch.block_host_counts``: three more blocks), the NCCL kernels'
device ms in one profiled iteration; then the exchange's own wall ms a
call (the packed light-vertex table ``[17, 9, paths of one rank]``
exchanged alone, 5 calls: a collective inside a graph cannot be timed
alone) and its bytes a rank an iteration (counted through the graph's
replays), the efficiency t_1 / (W t_W) of the slowest rank's median, peak
memory, and the image's max |err| against one rank's.

The sharded-memory regime: ``--res 2048 --exchange ring`` renders one
block of 2 iterations (no warm one) on every visible card, ``--res 2048
--ranks 1`` in one process (the merge caps measured or read from the
cache first); each rank's ``torch.cuda.max_memory_allocated`` and
``max_memory_reserved`` (a graph's private memory pool stays reserved
between replays, the gathered photon table among its buffers), the image
mean against the JAX package's record (artifacts/mesh2048_summary.json:
8 virtual devices, ring, 2 iterations, same seed) and the per-shard
account that ``render_2048_mesh.py`` printed, next to the port's own table
sizes. A run that does not fit its card prints the out-of-memory message.
Every run also prints the cell merge's candidate pairs a path an iteration
(the JAX package's pair merge caps them at ``pair_factor`` = 24 a path, a
ring hop's cap on the paths of one shard).

    python scripts/torch_scaling.py [--ranks 1 2 4] [--exchange allgather
        ring] [--iters 8] [--repeats 5] [--res 512] [--device cuda]
    python scripts/torch_scaling.py --res 2048 --exchange ring
    python scripts/torch_scaling.py --res 2048 --ranks 1

``--device cpu`` runs gloo ranks on the CPU (a rehearsal: no device
numbers; gloo ranks run the iteration eagerly). The last line is a JSON
object with every number printed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MESH_2048 = ROOT / "artifacts" / "mesh2048_summary.json"
MEMORY_RES = 2048      # at this size: 2 iterations, no warm one, memory
VERTEX_ROWS = 17       # the packed light-vertex table (vcm.pack_vertices)
MAX_L = 9              # light vertex slots at max path length 10


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _exchange_ms(torch, comm, group, dev, n_rank: int, exchange: str):
    """Wall ms of one exchange call on the iteration's table, 5 calls."""
    table = torch.rand((VERTEX_ROWS, MAX_L, n_rank), device=dev)
    call = (lambda: comm.all_gather_columns(table, group)) \
        if exchange == "allgather" else (lambda: comm.ring_shift(table,
                                                                 group))
    call()
    times = []
    for _ in range(5):
        _sync(torch, dev)
        t0 = time.perf_counter()
        call()
        _sync(torch, dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _nccl_device_ms(torch, run, start: int, accum) -> float:
    """Device ms of the NCCL kernels in one profiled block of one
    iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(start, 1, accum)
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "nccl" in e.name.lower()) / 1e3


def rank_run(device: str, res: int, iters: int, repeats: int,
             exchange: str, warm: bool) -> dict:
    """One rank's share (or the single process): render blocks through
    render.py's block runner, time them, measure."""
    import torch

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.parallel import comm, multihost
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    group = multihost.global_group()
    dev = multihost.rank_device(device)
    w = 1 if group is None else comm.world_size(group)
    scene = load_cornell_box((res, res), SCENE_CONFIGS[0], device=dev)
    # The memory regime sizes the single process's caps (at 2048x2048 the
    # default factors would not fit); strong scaling freezes the defaults
    # for every rank count alike.
    cfg = R.RenderConfig(algorithm="vcm", resolution=(res, res),
                         block_size=iters, vm_exchange=exchange, group=group,
                         merge_caps_frozen=warm)
    run = R._make_block_runner(scene, cfg, "vcm")
    out = dict(device=str(dev), world=w,
               backend=None if group is None else
               str(torch.distributed.get_backend(group)))
    accum = torch.zeros((res, res, 3), device=dev)
    done = 0
    if warm:
        accum = run(done, iters, accum).accum
        done += iters
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    comm.all_gather_columns.bytes = comm.ring_shift.bytes = 0
    ms, pairs = [], 0
    try:
        for _ in range(repeats):
            _sync(torch, dev)
            t0 = time.perf_counter()
            block = run(done, iters, accum)    # ends in its host read
            ms.append(1e3 * (time.perf_counter() - t0) / iters)
            accum = block.accum
            done += iters
            pairs += block.stats[0]
    except torch.cuda.OutOfMemoryError as e:
        out["out_of_memory"] = str(e).splitlines()[0]
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev)
        return out
    out.update(
        ms=ms, image=(accum / done).cpu(),
        pairs_per_path=pairs / (repeats * res * res),
        exchange_bytes=(comm.all_gather_columns.bytes
                        + comm.ring_shift.bytes) // (repeats * iters),
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        peak_reserved_bytes=(torch.cuda.max_memory_reserved(dev)
                             if dev.type == "cuda" else None),
        caps=R._caps_of(cfg))
    if dev.type == "cuda" and warm:
        from bench_torch import block_host_counts

        host = block_host_counts(scene, cfg, done, iters)
        out.update(host_launch_calls_per_iter=host["host_launch_calls"]
                   / iters, host_syncs_per_block=host["host_syncs"],
                   busy_share=host["busy_share"],
                   nccl_device_ms=_nccl_device_ms(torch, run, done, accum))
    if group is not None:
        out["exchange_ms"] = _exchange_ms(torch, comm, group, dev,
                                          res * res // w, exchange)
    return out


def run(w: int, device: str, res: int, iters: int, repeats: int,
        exchange: str, warm: bool) -> list:
    """The ranks' results of one configuration, in rank order."""
    from smallvcm_tpu_torch.parallel import multihost

    if w == 1:
        return [rank_run(device, res, iters, repeats, exchange, warm)]
    return multihost.spawn(w, device, rank_run, device, res, iters,
                           repeats, exchange, warm)


def account(res: int, w: int) -> dict:
    """Per-shard sizes: render_2048_mesh.py's formulas (the JAX package's
    layout), then the port's packed light-vertex table and its camera
    queries [17, max path length, paths of one rank] in f32."""
    n_shard = res * res // w
    gb = lambda words: round(4 * words / 1e9, 3)
    return dict(
        paths_total=res * res, paths_per_shard=n_shard,
        stored_vertices_GB=gb(2 * 16 * 10 * n_shard),
        connection_broadcast_GB=gb((10 - 2) * n_shard * 24),
        photon_table_GB=gb(3.0 * n_shard * 16),
        port_vertex_table_GB=gb(VERTEX_ROWS * MAX_L * n_shard),
        port_query_table_GB=gb(VERTEX_ROWS * (MAX_L + 1) * n_shard))


def summarize(ranks: list) -> dict:
    med = [statistics.median(r["ms"]) for r in ranks]
    return dict(
        rank_ms_median=med,
        rank_ms_min=[min(r["ms"]) for r in ranks],
        rank_ms_max=[max(r["ms"]) for r in ranks],
        ms=max(med),   # the job waits for its slowest rank
        exchange_ms=ranks[0].get("exchange_ms"),
        exchange_bytes=ranks[0]["exchange_bytes"],
        pairs_per_path=ranks[0]["pairs_per_path"],
        peak_GiB=[None if r["peak_bytes"] is None
                  else round(r["peak_bytes"] / 2 ** 30, 3) for r in ranks],
        peak_reserved_GiB=[None if r["peak_reserved_bytes"] is None
                           else round(r["peak_reserved_bytes"] / 2 ** 30, 3)
                           for r in ranks],
        host_launch_calls_per_iter=[r.get("host_launch_calls_per_iter")
                                    for r in ranks],
        host_syncs_per_block=[r.get("host_syncs_per_block") for r in ranks],
        busy_share=[r.get("busy_share") for r in ranks],
        nccl_device_ms=[r.get("nccl_device_ms") for r in ranks],
        caps=ranks[0]["caps"],
        backend=ranks[0]["backend"])


def card_line() -> str:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return "; ".join(out.stdout.strip().splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=None,
                    help="rank counts (default 1 2 4; at 2048: every card)")
    ap.add_argument("--exchange", nargs="+", default=["allgather", "ring"],
                    choices=["allgather", "ring"])
    ap.add_argument("--iters", type=int, default=8,
                    help="iterations a block (at 2048: 2)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed blocks (at 2048: 1, no warm block)")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from smallvcm_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    memory = args.res >= MEMORY_RES
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        print(f"[card] {card_line()} ({n_cards} visible)", flush=True)
    else:
        n_cards = None
        print("[card] cpu: gloo ranks, no device numbers", flush=True)
    ranks = args.ranks or ([n_cards or 1] if memory else [1, 2, 4])
    iters, repeats, warm = ((2, 1, False) if memory
                            else (args.iters, args.repeats, True))
    result = dict(res=args.res, block=iters, repeats=repeats,
                  warm_block=warm, device=dev.type, runs=[])
    base = None
    for w in ranks:
        if n_cards is not None and w > n_cards:
            print(f"[skip] {w} ranks: only {n_cards} card(s) visible",
                  flush=True)
            continue
        for exchange in (args.exchange if w > 1 else args.exchange[:1]):
            t0 = time.perf_counter()
            out = run(w, args.device, args.res, iters, repeats, exchange,
                      warm)
            row = dict(ranks=w, exchange=exchange if w > 1 else None,
                       wall_s=round(time.perf_counter() - t0, 1),
                       account=account(args.res, w))
            if any("out_of_memory" in r for r in out):
                row["out_of_memory"] = [r.get("out_of_memory") for r in out]
                row["peak_GiB"] = [round(r["peak_bytes"] / 2 ** 30, 3)
                                   for r in out]
                row["peak_reserved_GiB"] = [
                    round(r["peak_reserved_bytes"] / 2 ** 30, 3) for r in out]
                print(f"[oom] {w} rank(s) at {args.res}x{args.res}: "
                      f"{row['out_of_memory']}", flush=True)
                result["runs"].append(row)
                continue
            row.update(summarize(out))
            img = out[0]["image"]
            row["mean"] = float(img.mean())
            if w == 1:
                base = img
                result["t1_ms"] = row["ms"]
            elif base is not None:
                row["max_abs_err_vs_1"] = float((img - base).abs().max())
            if "t1_ms" in result:
                row["efficiency"] = result["t1_ms"] / (w * row["ms"])
            if memory:
                ref = json.loads(MESH_2048.read_text())["mean"]
                row["jax_mean"] = ref
                row["mean_rel_vs_jax"] = row["mean"] / ref - 1.0
            result["runs"].append(row)
            print(f"[{w} rank(s){', ' + exchange if w > 1 else ''}] "
                  f"{args.res}x{args.res}: ms/iteration by rank (median) "
                  f"{[round(x, 1) for x in row['rank_ms_median']]}, spread "
                  f"{[round(x, 1) for x in row['rank_ms_min']]}.."
                  f"{[round(x, 1) for x in row['rank_ms_max']]}; exchange "
                  f"{row['exchange_bytes']} B a rank an iteration, "
                  f"{row['exchange_ms']} ms a call; candidate pairs "
                  f"{row['pairs_per_path']:.2f} a path; host launch calls "
                  f"an iteration {row['host_launch_calls_per_iter']}, host "
                  f"syncs a block {row['host_syncs_per_block']}, busy share "
                  f"{row['busy_share']}, NCCL kernels' device ms in one "
                  f"iteration {row['nccl_device_ms']}; caps {row['caps']}; "
                  f"efficiency "
                  f"{row.get('efficiency')}; peak GiB {row['peak_GiB']} "
                  f"allocated, {row['peak_reserved_GiB']} reserved; "
                  f"mean {row['mean']:.6f}"
                  + (f" vs JAX {row['jax_mean']:.6f} "
                     f"({100 * row['mean_rel_vs_jax']:+.3f}%)"
                     if memory else "")
                  + (f"; max |err| vs 1 rank {row['max_abs_err_vs_1']:.3g}"
                     if "max_abs_err_vs_1" in row else "")
                  + f"; {row['wall_s']} s", flush=True)
            print(f"  account: {row['account']}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
