"""The numbers that decide ``correct``: each a gap between what the timed
path produced and the plain reference's answer, held to a limit of its
own (the configuration file's ``limits``; PERF.md gives the readings each
limit was set from)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

# A pixel value's gap is measured against its reference value plus this
# share of the image's mean, so that dark pixels do not divide by ~0.
PIXEL_FLOOR = 1e-3


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def image_gaps(got, want, k: int, before=None, after=None) -> dict:
    """Gaps of a block's sum of ``k`` images against the reference's sum
    of the same iterations: ``img_max_gap``, the largest |p - r| / (|r| +
    floor) over pixel values, and ``img_rel_l1``, the sum of |p - r| over
    the sum of |r|.

    ``got`` is the program's accumulator after the block less the one
    before it (``before``, ``after``: None where the sum was made from
    zero). Each pixel value's gap is taken beyond what float32 rounding
    alone may put there: half a unit in the last place of ``before``, of
    ``after`` and of each of the k running sums on either side
    (2^-24 ((k + 1) |after| + |before| + k |r|))."""
    p = got.detach().to("cpu", torch.float64)
    r = want.detach().to("cpu", torch.float64)
    if p.shape != r.shape:
        raise ValueError(f"image shapes differ: {tuple(p.shape)} against "
                         f"{tuple(r.shape)}")
    if not torch.isfinite(p).all():
        return dict(img_max_gap=float("inf"), img_rel_l1=float("inf"))
    mag = r.abs()
    slack = k * mag
    for acc, times in ((before, 1), (after, k + 1)):
        if acc is not None:
            slack = slack + times * acc.detach().to("cpu",
                                                    torch.float64).abs()
    gap = ((p - r).abs() - 2.0 ** -24 * slack).clamp_min(0.0)
    floor = PIXEL_FLOOR * float(mag.mean())
    return dict(img_max_gap=float((gap / (mag + floor)).max()),
                img_rel_l1=float(gap.sum() / max(float(mag.sum()), 1e-30)))


def held(gaps: dict, limits: dict) -> list:
    """Each gap beside its limit, as Checks (a gap without a limit is an
    error of the configuration file)."""
    return [Check(name, float(v), float(limits[name]))
            for name, v in gaps.items()]
