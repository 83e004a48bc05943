"""Faults planted in the port's timed path, to see ``correct`` come out
false (test_benchmark_faults.py). Each is named "module:function" in a
Context's ``fault``; :func:`restore` takes every one back."""

from __future__ import annotations

import torch

_SAVED = []


def _patch(obj, name, new):
    _SAVED.append((obj, name, getattr(obj, name)))
    setattr(obj, name, new)


def restore() -> None:
    while _SAVED:
        obj, name, old = _SAVED.pop()
        setattr(obj, name, old)


def _vcm_block(change):
    """Wrap the VCM family's block (vcm.render_block_with_stats): the
    block's images (its sum less the accumulator it started from) pass
    through ``change(images, accum)``."""
    from smallvcm_tpu_torch.algorithms import vcm

    real = vcm.render_block_with_stats

    def block(*args, accum=None, **kw):
        acc, *rest = real(*args, accum=accum, **kw)
        base = torch.zeros_like(acc) if accum is None else accum
        return (change(acc - base, base), *rest)

    _patch(vcm, "render_block_with_stats", block)


def _halved(img):
    """Half of the paths left out (every other row), the mean taken over
    the rest."""
    out = torch.zeros_like(img)
    out[::2] = 2.0 * img[::2]
    return out


def render_unchanged():
    """A block that returns its accumulator unchanged."""
    _vcm_block(lambda img, base: base)


def render_half():
    _vcm_block(lambda img, base: base + _halved(img))


def render_altered():
    """One pixel of a block's images altered where they are produced."""
    def change(img, base):
        img = img.clone()
        img[img.shape[0] // 2, img.shape[1] // 2] *= 1.01
        return base + img
    _vcm_block(change)


def pt_half():
    """pt's iteration image with half of its paths left out."""
    from smallvcm_tpu_torch import render as R

    real = R.render_iteration

    def iteration(*args, **kw):
        img, rays = real(*args, **kw)
        return _halved(img), rays

    _patch(R, "render_iteration", iteration)


def sharded_unchanged():
    """A sharded rank's iterations leave the accumulator unchanged, by the
    one-graph path (NCCL) or stage by stage (gloo)."""
    from smallvcm_tpu_torch.parallel import sharding

    render_unchanged()
    real = sharding.sharded_render_iteration_with_stats

    def iteration(*args, **kw):
        img, *rest = real(*args, **kw)
        return (torch.zeros_like(img), *rest)

    _patch(sharding, "sharded_render_iteration_with_stats", iteration)


def exchange_left_out():
    """The photon exchange between ranks left out: each rank merges its
    own photons only."""
    from smallvcm_tpu_torch.parallel import comm

    _patch(comm, "all_gather_columns", lambda x, group=None: x)


def jax_in_rank_1():
    """Rank 1 of the group loads a module named ``jax`` (an empty stand-in)
    after its set-up."""
    import sys
    import types

    import torch.distributed as dist

    if dist.get_rank() == 1:
        sys.modules["jax"] = types.ModuleType("jax")
