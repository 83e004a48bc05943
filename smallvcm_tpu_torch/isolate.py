"""Fault-isolated rendering: supervise the render in a child process.

Port of ``smallvcm_tpu/isolate.py``, opt-in (``--isolate on``; ``auto``
means off). A CUDA or NCCL runtime fault (an illegal address, a lost or
hung peer) leaves the process's CUDA context or process group unusable,
while the render's whole inter-iteration state is (framebuffer, iteration,
seed) in a checkpoint. So:

* the parent re-invokes ``python -m smallvcm_tpu_torch.cli`` as a child
  with periodic checkpointing (checkpoint.py: resume is bit-exact);
* if the child dies with a fault signature (_FAULT_MARKERS: CUDA and NCCL
  runtime errors, which the test hook render.py::_maybe_inject_test_fault
  imitates), the parent respawns it, resuming from the checkpoint;
* after ``MAX_STALLED_FAULTS`` faults in a row with no checkpoint
  progress (a dead card), or ``MAX_FAULTS`` faults in all, the parent
  gives up with the child's non-zero exit code and says why.

Unlike the JAX supervisor, it never switches the child to another merge
backend after repeated faults: that would swap the merge kernel out and
hide the fault. The parent never touches the card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_FAULT_MARKERS = (
    "CUDA error",
    "NCCL error",
    "DistBackendError",
    "illegal memory access",
)

MAX_FAULTS = 3
# Consecutive faults with no checkpoint progress before giving up: a dead
# card faults again before the next checkpoint, so the parent stops sooner
# than MAX_FAULTS there.
MAX_STALLED_FAULTS = 2


def _strip_flag(argv, flag, has_value=True):
    out = []
    i = 0
    while i < len(argv):
        if argv[i] == flag:
            i += 2 if has_value else 1
            continue
        out.append(argv[i])
        i += 1
    return out


def _checkpoint_iteration(path: str) -> int:
    """Saved iteration count, or -1 if no checkpoint exists yet."""
    try:
        import numpy as np

        with np.load(path, allow_pickle=False) as z:
            return int(z["iterations_done"])
    except (OSError, KeyError, ValueError):
        return -1


def run_supervised(argv) -> int:
    """Run ``python -m smallvcm_tpu_torch.cli <argv>`` in a supervised
    child -> the final exit code. ``argv`` is the parent's CLI argv
    (without the program name)."""
    from .cli import make_parser

    args = make_parser().parse_args(list(argv))

    # Reuse a user-supplied checkpoint so their resumable file is written;
    # fall back to a temp path only when absent.
    ckpt = args.checkpoint or os.path.join(
        tempfile.mkdtemp(prefix="smallvcm_isolate_"), "ckpt.npz"
    )
    every = min(args.checkpoint_every or 8, 8)

    env = dict(os.environ)
    pkg_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH")) if p)

    base = _strip_flag(list(argv), "--checkpoint")
    base = _strip_flag(base, "--checkpoint-every")
    base = _strip_flag(base, "--isolate")

    # Time budget across respawns.
    t_budget = args.max_time if args.max_time > 0 else None
    t0 = time.time()

    faults = 0
    stalled = 0
    last_iter = _checkpoint_iteration(ckpt)
    while True:
        cmd = base[:]
        if t_budget is not None:
            remaining = max(1.0, t_budget - (time.time() - t0))
            cmd = _strip_flag(cmd, "-t") + ["-t", str(remaining)]
        cmd += ["--isolate", "off", "--checkpoint", ckpt,
                "--checkpoint-every", str(every)]
        proc = subprocess.run(
            [sys.executable, "-m", "smallvcm_tpu_torch.cli", *cmd],
            env=env, stderr=subprocess.PIPE, text=True,
        )
        sys.stderr.write(proc.stderr[-2000:] if proc.returncode else "")
        if proc.returncode == 0:
            return 0
        if not any(m in proc.stderr for m in _FAULT_MARKERS):
            return proc.returncode
        faults += 1
        now_iter = _checkpoint_iteration(ckpt)
        stalled = 0 if now_iter > last_iter else stalled + 1
        last_iter = now_iter
        if stalled >= MAX_STALLED_FAULTS:
            print("[smallvcm_tpu_torch] runtime faulted "
                  f"{stalled}x with no checkpoint progress; giving up",
                  flush=True)
            return proc.returncode
        if faults >= MAX_FAULTS:
            print(f"[smallvcm_tpu_torch] runtime faulted {faults}x (the "
                  f"limit is {MAX_FAULTS}); giving up, the merge backend "
                  "is never switched", flush=True)
            return proc.returncode
        print(f"[smallvcm_tpu_torch] runtime fault (#{faults}); respawning "
              "from checkpoint", flush=True)
