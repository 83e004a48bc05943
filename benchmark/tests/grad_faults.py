"""Faults planted in the gradient step's timed path (test_benchmark_grad.py),
named "module:function" in a Context's ``fault``; the ``restore_faults``
fixture takes them back (``faults.restore``)."""

from __future__ import annotations

from benchmark.tests.faults import _patch


def grad_leaf_scaled():
    """Every step's gradient of the first leaf (the diffuse reflectance's
    x plane) scaled by 1.01 where it is produced."""
    from smallvcm_tpu_torch import diff

    real = diff.loss_and_grad

    def step(*args, **kw):
        loss, g = real(*args, **kw)
        return loss, g._replace(diffuse=g.diffuse._replace(
            x=g.diffuse.x * 1.01))

    _patch(diff, "loss_and_grad", step)


def grad_loss_offset():
    """Every step's loss 1% high, its gradient as it is."""
    from smallvcm_tpu_torch import diff

    real = diff.loss_and_grad

    def step(*args, **kw):
        loss, g = real(*args, **kw)
        return loss * 1.01, g

    _patch(diff, "loss_and_grad", step)
