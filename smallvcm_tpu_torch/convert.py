"""Carry a scene across from the JAX package: numpy leaves -> port tensors.

The renderer's "weights" are the scene tensors. ``scene_from_numpy`` takes
a JAX ``SceneData`` whose leaves were turned into numpy arrays (for example
``jax.tree.map(np.asarray, scene)``) and rebuilds it as the port's
``SceneData`` on ``device``, matching NamedTuples by class name;
``params_from_numpy`` does the same for the differentiable parameters of
``diff.Params``. This module imports nothing of JAX: it only reads
attributes and arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.vec3 import V3
from .diff import Params
from .scene.camera import CameraData
from .scene.scene import Lights, Materials, SceneData, SceneSphere

_NAMED = {cls.__name__: cls
          for cls in (V3, Materials, Lights, SceneSphere, CameraData,
                      Params)}


def _convert(node, device):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        cls = _NAMED.get(type(node).__name__)
        if cls is None or cls._fields != node._fields:
            raise TypeError(f"unknown scene record {type(node).__name__}")
        return cls(*(_convert(v, device) for v in node))
    return torch.from_numpy(np.array(node, copy=True)).to(device)


def scene_from_numpy(tree, device="cpu") -> SceneData:
    """JAX ``SceneData`` with numpy leaves -> port ``SceneData`` on device."""
    device = torch.device(device)
    kw = {f.name: _convert(getattr(tree, f.name), device)
          for f in dataclasses.fields(SceneData)
          if f.name != "background_idx"}
    return SceneData(**kw, background_idx=int(tree.background_idx))


def params_from_numpy(tree, device="cpu") -> Params:
    """JAX ``diff.Params`` with numpy leaves -> port ``Params`` on device."""
    params = _convert(tree, torch.device(device))
    if not isinstance(params, Params):
        raise TypeError(f"expected Params, got {type(tree).__name__}")
    return params
