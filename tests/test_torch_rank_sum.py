"""The image sum over ranks (parallel/comm.py::framebuffer_sum) on four
gloo CPU ranks: every rank's image added in rank order, the same bits on
every rank and on every backend.

From three ranks on, an all-reduce's order is its backend's own, and four
NCCL ranks summed a VCM image one ulp away from their gloo twins; the sum
in rank order makes both the left fold ((x_0 + x_1) + x_2) + x_3. The
ranks' images here are built so that the other orders of the sum give
other bits.
"""

import pytest
import torch

from smallvcm_tpu_torch.parallel import comm, multihost

RANKS = 4
SHAPE = (8, 8, 3)


def _images():
    """Each rank's image: per element, 1e8, 1, -1e8 and 1 in a random
    order over the ranks, so the fold's order shows in the bits."""
    g = torch.Generator().manual_seed(1234)
    vals = torch.tensor([1e8, 1.0, -1e8, 1.0])
    perm = torch.argsort(torch.rand((*SHAPE, RANKS), generator=g), dim=-1)
    return vals[perm].movedim(-1, 0).contiguous()       # [RANKS, *SHAPE]


def _rank_sums():
    """Runs in every rank: its image summed over the ranks, forward and
    backward."""
    group = multihost.global_group()
    x = _images()[comm.rank(group)].clone().requires_grad_(True)
    total = comm.framebuffer_sum(x, group)
    (total * 3.0).sum().backward()
    counts = torch.full(SHAPE, comm.rank(group) + 1, dtype=torch.int64)
    return dict(total=total.detach(), grad=x.grad,
                counts=comm.all_reduce_sum(counts, group))


@pytest.fixture(scope="module")
def ranks():
    return multihost.spawn(RANKS, "cpu", _rank_sums)


def test_sum_is_the_rank_order_fold_on_every_rank(ranks):
    parts = _images()
    fold = parts[0].clone()
    for k in range(1, RANKS):
        fold = fold + parts[k]
    # The images do tell the orders apart: pairing the ranks differently
    # gives other bits on some elements.
    assert not torch.equal(fold, (parts[0] + parts[2]) + (parts[1] + parts[3]))
    for r, out in enumerate(ranks):
        assert torch.equal(out["total"], fold), r


def test_sum_backward_is_identity(ranks):
    for out in ranks:
        assert torch.equal(out["grad"], torch.full(SHAPE, 3.0))


def test_counts_still_all_reduce(ranks):
    """Integer sums (rays, overflow, merge stats) need no order and stay
    one all-reduce: 1 + 2 + 3 + 4 on every element."""
    for out in ranks:
        assert torch.equal(out["counts"],
                           torch.full(SHAPE, 10, dtype=torch.int64))
