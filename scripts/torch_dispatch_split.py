#!/usr/bin/env python3
"""The ATen kernels of one iteration, split by the port's module that
launched them.

Runs one iteration of an algorithm on the CPU under a TorchDispatchMode
and gives each ATen op to the innermost module of ``smallvcm_tpu_torch``
on the Python stack, passing over the vector helpers (``core/vec3.py``,
``core/vecmath.py``), whose ops belong to their caller. Views, the
scalars' wraps and reads, empty tensors, copies and fills are left out:
they launch no kernel on the card or are the copies and fills that
``kernels_per_iter`` leaves out. A hand-written kernel's plain CPU
version counts as the one launch the kernel makes on the card: the two
sweeps and the cell merge, and ``uniform_slots`` unless ``--plain-rng``
counts the int64 chain that the RNG runs on the CPU. The count does not
depend on the resolution; the stage clocks' stamps (the card's block
runner only) are not in it.

    python scripts/torch_dispatch_split.py [--alg vcm] [--res 32] [--plain-rng]

Prints one JSON line (and ``main`` returns it as a dict): the total, the
count by module, and the calls of ``uniform_slots`` by their number of
slots.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PKG = "smallvcm_tpu_torch/"
HELPERS = ("core/vec3.py", "core/vecmath.py")
SKIPPED = {"copy_", "fill_", "zero_", "empty", "empty_like", "empty_strided",
           "lift_fresh", "scalar_tensor", "_local_scalar_dense", "clone",
           "detach", "alias", "set_"}


def _module():
    """The innermost package module on the stack, helpers passed over."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        at = path.rfind(PKG)
        if at >= 0:
            rel = path[at + len(PKG):]
            if rel not in HELPERS:
                return rel
        f = f.f_back
    return "(outside the package)"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alg", default="vcm")
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--plain-rng", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from smallvcm_tpu_torch import render as R
    from smallvcm_tpu_torch.core import rng
    from smallvcm_tpu_torch.ops import merge as M
    from smallvcm_tpu_torch.ops import sweep as S
    from smallvcm_tpu_torch.scene.scene import SCENE_CONFIGS, load_cornell_box

    counts = collections.Counter()
    slots = collections.Counter()
    quiet = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            name = func.overloadpacket.__name__
            if not quiet[0] and not func.is_view and name not in SKIPPED:
                counts[_module()] += 1
            return func(*a, **(kw or {}))

    def one_launch(module, fn):
        def launch(*a, **kw):
            counts[module] += 1
            quiet[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                quiet[0] -= 1
        return launch

    plain = rng._uniform_slots_plain
    if not args.plain_rng:
        plain = one_launch("core/rng.py", plain)

    def uniform_slots_plain(seed, stream, path_ids, n_slots, *rest):
        slots[n_slots] += 1
        return plain(seed, stream, path_ids, n_slots, *rest)

    torch.set_num_threads(2)
    res = (args.res, args.res)
    scene = load_cornell_box(res, SCENE_CONFIGS[0], device="cpu")
    cfg = R.RenderConfig(algorithm=args.alg, resolution=res)
    alg = R.resolve_algorithm(scene, args.alg)
    with contextlib.ExitStack() as patches:
        for owner, name, fn in (
                (S, "sweep_plain", one_launch("ops/sweep.py", S.sweep_plain)),
                (S, "occluded_plain",
                 one_launch("ops/sweep.py", S.occluded_plain)),
                (M, "merge_cells_plain",
                 one_launch("ops/merge.py", M.merge_cells_plain)),
                (rng, "_uniform_slots_plain", uniform_slots_plain)):
            patches.enter_context(mock.patch.object(owner, name, fn))
        R.render_iteration(scene, cfg, alg, 0)
        counts.clear()
        slots.clear()
        with Count():
            R.render_iteration(scene, cfg, alg, 1)
    result = {
        "alg": args.alg, "res": args.res, "plain_rng": args.plain_rng,
        "total": sum(counts.values()),
        "by_module": dict(counts.most_common()),
        "uniform_slots_calls_by_slots": dict(sorted(slots.items())),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
