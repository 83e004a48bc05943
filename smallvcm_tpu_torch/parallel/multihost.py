"""Multi-process / multi-host set-up: the process group and a launcher.

Port of ``smallvcm_tpu/parallel/multihost.py``. The JAX package calls
``jax.distributed.initialize`` and builds a global mesh; here every
process joins one ``torch.distributed`` process group and renders its path
shard on its own device (parallel/sharding.py). Processes come from
:func:`spawn` (the CLI's ``--devices N``), from ``torchrun`` (whose
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``
:func:`initialize` reads), or from the caller, on one or many hosts.

Devices and backends: a rank asked for "cuda" renders on
``cuda:LOCAL_RANK``; "cuda:k" pins it to card k (several ranks may share
it); "cpu" renders on the CPU. The group's backend is NCCL when every rank
has a card of its own, and gloo on the CPU or when ranks share a card
(NCCL refuses two ranks on one device). Under gloo the exchanges stage
CUDA tensors through host memory (parallel/comm.py); the coordinator says
so when it picks gloo for CUDA ranks.

A rank leaves its group through :func:`shutdown`, which drops the CUDA
graphs that captured the group's collectives before the communicator goes.

Failure model (as the JAX package's): fail-fast. A rank that raises
brings the job down with a non-zero exit (:func:`spawn` stops the other
ranks); inter-iteration state is only (framebuffer, iteration, seed), so a
job resumes bit for bit from its last checkpoint (checkpoint.py).
"""

from __future__ import annotations

import gc
import os
import socket
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import graphs
from ..device import resolve_device


def _init_url(coordinator_address) -> str:
    """None -> torchrun's env://; "host:port" -> tcp://host:port; a URL
    (file://, tcp://, env://) as it is."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def rank_device(device="cuda", local_rank: int | None = None):
    """The device a rank renders on: "cuda" -> cuda:LOCAL_RANK (from the
    argument or the environment, default 0), "cuda:k" -> cuda:k, "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def _pick_backend(store, dev, rank: int, world: int) -> str:
    """NCCL when every rank has a card of its own, else gloo; decided alike
    on every rank from what each one published in the rendezvous store."""
    store.set(f"smallvcm/card/{rank}", f"{socket.gethostname()}/{dev}")
    cards = [store.get(f"smallvcm/card/{k}").decode() for k in range(world)]
    if dev.type != "cuda":
        return "gloo"
    if len(set(cards)) == world:
        return "nccl"
    if rank == 0:
        print("[smallvcm_tpu_torch] ranks share a card: gloo backend, "
              "exchanges staged through host memory", flush=True)
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device="cuda"):
    """Join the job's process group -> the group, or None for a single
    process (a no-op, as the JAX package's ``initialize`` is).

    Unset arguments come from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``/``MASTER_PORT`` through env://). Returns the
    existing group when one is already initialised. Sets the rank's card
    as the current CUDA device (see :func:`rank_device`)."""
    if dist.is_initialized():
        return dist.group.WORLD
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if num_processes <= 1:
        return None
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store, _, _ = next(dist.rendezvous(_init_url(coordinator_address),
                                       process_id, num_processes))
    backend = _pick_backend(store, dev, process_id, num_processes)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes)
    return dist.group.WORLD


def shutdown() -> None:
    """Leave the job's process group. The CUDA graphs that captured its
    collectives go first, and the card finishes its work: ranks that
    destroyed an NCCL group under live graphs which had replayed its
    kernels waited in ``destroy_process_group`` until killed (four H100s,
    NCCL 2.28.9); with the graphs dropped first they left in under a
    second."""
    group = dist.group.WORLD
    if graphs.drop_group(group):
        gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    dist.destroy_process_group()


def global_group():
    """The job's process group, or None outside a multi-process job."""
    return dist.group.WORLD if dist.is_initialized() else None


def is_coordinator() -> bool:
    """True on rank 0, and in a single process (it writes images and
    checkpoints)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_entry(rank: int, world: int, device, init: str, out_dir: str,
                fn, args):
    os.environ["LOCAL_RANK"] = str(rank)
    initialize(init, world, rank, device)
    try:
        torch.save(fn(*args), Path(out_dir) / f"result{rank}.pt")
    finally:
        shutdown()


def spawn(world_size: int, device, fn, *args) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes joined in one
    group (a file:// rendezvous in a temporary directory), rank r on
    ``rank_device(device, r)`` -> the ranks' return values in rank order.

    ``fn`` and its arguments must pickle (a module-level function). If a
    rank raises, the others are stopped and the error is raised here
    (torch.multiprocessing.ProcessRaisedException)."""
    with tempfile.TemporaryDirectory(prefix="smallvcm_ranks_") as tmp:
        init = Path(tmp, "rendezvous").as_uri()
        mp.start_processes(_rank_entry,
                           args=(world_size, device, init, tmp, fn, args),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(Path(tmp) / f"result{r}.pt", weights_only=False)
                for r in range(world_size)]
