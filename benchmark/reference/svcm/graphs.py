"""Stages run eagerly: the reference's stand-in for the port's CUDA graphs.

The port captures each stage as a CUDA graph (``graphs.stage``) and
replays it; a replay gives the bits of the eager call. The reference runs
every stage eagerly, as the port's first call of a stage does: ``fn(scene,
*tensors, *scalars, *static)`` with each scalar as a 0-dim device tensor.
"""

from __future__ import annotations

import torch


def _scalar(value, dev):
    dtype = torch.int64 if isinstance(value, int) else torch.float32
    return torch.full((), value, dtype=dtype, device=dev)


def stage(fn, scene, tensors: tuple, scalars: tuple, static: tuple):
    """``fn(scene, *tensors, *scalars, *static)``, eagerly."""
    return fn(scene, *tensors, *(_scalar(v, scene.device) for v in scalars),
              *static)
