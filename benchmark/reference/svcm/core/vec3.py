"""Structure-of-arrays 3-vectors over torch tensors.

``V3`` keeps x/y/z as three separate ``[...]`` tensors, the layout of the
JAX package's ``core/vec3.py``, so public functions compare like with
like and broadcasting against per-primitive axes ([N] x [T] -> [N, T])
needs no 3-component interleaving.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- shape helpers ------------------------------------------------------
    @property
    def shape(self):
        return self.x.shape

    def broadcast_to(self, shape):
        b = lambda a: torch.broadcast_to(a, shape)
        return V3(b(self.x), b(self.y), b(self.z))

    def __getitem__(self, idx):
        """Index/gather each component (idx applies per component tensor)."""
        return V3(self.x[idx], self.y[idx], self.z[idx])

    def expand(self, axis):
        e = lambda a: a.unsqueeze(axis)
        return V3(e(self.x), e(self.y), e(self.z))

    def max_component(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def to_array(self):
        """-> [..., 3] (host interop / framebuffer only)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def v3_splat(s) -> V3:
    """Scalar (or tensor) replicated into all three components."""
    return V3(s, s, s)


def v3_where(mask, a: V3, b) -> V3:
    if not isinstance(b, V3):
        b = v3_splat(b)
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def len_sqr(a: V3):
    return dot(a, a)


def length(a: V3):
    return torch.sqrt(len_sqr(a).clamp_min(1e-35))


def normalize(a: V3) -> V3:
    return a * (1.0 / length(a))


def luminance(rgb: V3):
    return 0.212671 * rgb.x + 0.715160 * rgb.y + 0.072169 * rgb.z


def reflect_local(v: V3) -> V3:
    return V3(-v.x, -v.y, v.z)


def max_gt_zero(a: V3):
    """True where any component is positive (the usual !IsZero test for
    nonnegative radiance/factors)."""
    return a.max_component() > 0.0


def take(table, idx):
    """``table[idx]`` for a small 1-D table (or a V3 of them), such as the
    materials or lights gathered per lane."""
    if isinstance(table, V3):
        return V3(*(take(c, idx) for c in table))
    return table[idx]
