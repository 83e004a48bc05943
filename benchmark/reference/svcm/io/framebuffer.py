"""Accumulation framebuffer planes.

Port of the device side of ``smallvcm_tpu/io/framebuffer.py``: the
framebuffer is a V3 of ``[resY, resX]`` f32 planes.

Determinism: every scatter-add here goes through
:func:`deterministic_index_add`. On the CPU ``index_add_`` accumulates in
source order, which is the JAX package's sorted (key, iota) order; on
CUDA it runs under ``torch.use_deterministic_algorithms``, whose
``index_add_`` sorts the indices and sums without atomics, so a render is
bitwise repeatable on the card.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.vec3 import V3


@contextlib.contextmanager
def _deterministic():
    """Scoped ``torch.use_deterministic_algorithms(True)``."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def deterministic_index_add(n_rows: int, index, rows):
    """``zeros(n_rows, C).index_add_(0, index, rows)`` with a repeatable
    summation order on every device (rows [M, C], index [M] in
    [0, n_rows]); rows whose index is the sentinel ``n_rows`` add nothing.

    No host read: a sentinel row becomes a +0.0 row at index ``j %
    n_rows`` (its own position j), so every output row gets a few of them
    and none is hot (the deterministic CUDA ``index_add_`` sums each
    index's rows serially, and the sentinel can hold most of the rows).
    The bits are those of dropping the sentinel rows: each output row
    still sums its live rows in source order (the CPU ``index_add_`` runs
    in source order, the deterministic CUDA one sorts the indices
    stably), and adding +0.0 leaves every float but -0.0 as it is, while a
    sum that starts at +0.0 is never -0.0."""
    m = index.shape[0]
    dead = index >= n_rows
    spread = torch.remainder(
        torch.arange(m, dtype=index.dtype, device=index.device), n_rows)
    index = torch.where(dead, spread, index)
    rows = torch.where(dead[:, None], 0.0, rows)
    out = torch.zeros((n_rows, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    if rows.device.type == "cpu":
        return out.index_add_(0, index, rows)
    with _deterministic():
        return out.index_add_(0, index, rows)


def add_color_at_pix(fb, pix, color):
    """Own-pixel accumulate for camera sub-paths.

    Camera-path contributions always land on the path's own pixel
    (floor(x + jitter) == x for jitter in [0, 1)), and each path owns a
    distinct pixel, so this is a gather-add-put with unique indices: no
    accumulation order to fix.
    """
    def upd(plane, c):
        flat = plane.reshape(-1).clone()
        flat[pix] = flat[pix] + c
        return flat.reshape(plane.shape)

    return V3(upd(fb.x, color.x), upd(fb.y, color.y), upd(fb.z, color.z))


def splat_colors(fb, pix1d, color):
    """Scattered splat of [L, N] contributions -> fb planes, one 3-wide
    deterministic scatter-add.

    ``pix1d``: integer [L, N] flat pixel index per splat; dead splats carry
    the sentinel ``res_x * res_y`` and add nothing (no host read: see
    :func:`deterministic_index_add`). Light-tracer camera
    connections land on arbitrary pixels, so the per-bounce splats are
    deferred and flushed here once per iteration.
    """
    res_y, res_x = fb.x.shape
    p = res_x * res_y
    rows = torch.stack([color.x.reshape(-1), color.y.reshape(-1),
                        color.z.reshape(-1)], dim=1)
    buf = deterministic_index_add(p, pix1d.reshape(-1).long(), rows)
    return V3(
        fb.x + buf[:, 0].reshape(res_y, res_x),
        fb.y + buf[:, 1].reshape(res_y, res_x),
        fb.z + buf[:, 2].reshape(res_y, res_x),
    )


def new_fb_planes(res_x: int, res_y: int, device="cpu"):
    """Device-side accumulation planes (V3 of [resY, resX])."""
    z = torch.zeros((res_y, res_x), dtype=torch.float32, device=device)
    return V3(z, z, z)
