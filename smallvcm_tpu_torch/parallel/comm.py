"""Collectives of the sharded path, with their gradients written out.

Counterpart of the JAX package's ``psum`` / ``all_gather`` / ``ppermute``
inside ``shard_map`` (smallvcm_tpu/algorithms/vcm.py:1107-1118, 1344-1391)
and of their transpose rules, over a ``torch.distributed`` process group
whose ranks own contiguous path shards (parallel/sharding.py):

* :func:`framebuffer_sum`: every rank's image gathered and summed in rank
  order forward, **identity** backward. An all-reduce's order is the
  backend's: from three ranks on, NCCL's and gloo's sums of the same
  images differ in the last bit (four H100s), so the images are gathered
  and added left to right, the same bits on every backend. Every rank
  computes the same replicated loss from the summed image, so a
  rank's upstream gradient is already the full one; all-reducing it too
  (as ``torch.distributed.nn.functional.all_reduce`` does) would give W
  times the gradient. The ranks' partial parameter gradients are summed
  once, at the end (diff.sharded_loss_and_grad).
* :func:`all_gather_columns`: gathers the last dimension in rank order;
  backward hands each rank the sum over ranks of its slice of the gathered
  gradient (reduce-scatter on NCCL; gloo has none, so all-reduce + slice).
* :func:`ring_shift`: rank r's tensor goes to rank r + 1; backward is the
  reverse shift.

Every rank issues the same collectives in the same order, forward and
backward, or the job deadlocks; the functions here take no data-dependent
branch. gloo moves CUDA tensors only for broadcast and all-reduce, so
under gloo every exchange here stages a card's tensor through host memory
explicitly (:func:`_staged`); the kernels still run on the rank's card.

On NCCL every forward here can be captured into a CUDA graph
(:func:`capturable`): the all-gathers write into one preallocated
``[W, ...]`` tensor, the all-reduce into a clone, the ring's shift into an
empty buffer, and nothing passes through the host. The sharded iteration
therefore runs as one graph with its collectives inside
(algorithms/vcm.py::sharded_iteration_stage). gloo stages through host
memory and is never captured. Backwards always run eagerly: autograd never
runs as a graph.

``all_gather_columns.bytes`` and ``ring_shift.bytes`` count the bytes each
call brought to this rank (plain integers, like the kernels' launch
counters; chip_smoke.py reads them). They are bumped in Python, which a
graph replay does not run, so graphs.py treats them as it treats the
kernels' ``.launches``: a capture takes its increments back and each
replay adds them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(group):
    return dist.group.WORLD if group is None else group


# PyTorch 2.13 renamed all_gather_into_tensor to all_gather_single; either
# gathers into one preallocated tensor, the ranks' inputs concatenated.
_all_gather_tensor = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)


def capturable(group=None) -> bool:
    """Can the group's collectives run inside a CUDA graph? NCCL's can;
    gloo's stage CUDA tensors through host memory and cannot.
    ``graphs.why_eager`` asks this of a stage's group, never a failed
    capture."""
    return dist.get_backend(_group(group)) == dist.Backend.NCCL


def shard_ids(n: int, world: int, rank: int, device) -> torch.Tensor:
    """Global path ids ``[rank * n / world, (rank + 1) * n / world)``: the
    contiguous shard of ``n`` paths that rank ``rank`` of ``world``
    renders."""
    if n % world != 0:
        raise ValueError(f"path count {n} not divisible by {world} devices")
    m = n // world
    return torch.arange(rank * m, (rank + 1) * m, dtype=torch.int64,
                        device=device)


def world_size(group=None) -> int:
    return dist.get_world_size(_group(group))


def rank(group=None) -> int:
    return dist.get_rank(_group(group))


def _staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` must pass through host memory: a CUDA tensor in a
    gloo group."""
    return (t.device.type == "cuda"
            and dist.get_backend(_group(group)) == dist.Backend.GLOO)


def _wire(t: torch.Tensor, group, copy: bool = False) -> torch.Tensor:
    """A contiguous detached buffer the group's backend can move: on the
    host for a CUDA tensor under gloo, else on the tensor's device."""
    dev = torch.device("cpu") if _staged(t, group) else t.device
    return t.detach().to(dev, copy=copy).contiguous()


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group's ranks -> a new tensor on ``t``'s device
    (no gradient)."""
    buf = _wire(t, group, copy=True)
    dist.all_reduce(buf, group=_group(group))
    return buf.to(t.device)


def broadcast_flag(value: bool, group=None) -> bool:
    """Rank 0's ``value`` on every rank (the run-time budget's decision)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(_group(group)) == dist.Backend.NCCL
           else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int32, device=dev)
    dist.broadcast(t, src=dist.get_global_rank(_group(group), 0),
                   group=_group(group))
    return bool(t.item())


class _FramebufferSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # ((x_0 + x_1) + x_2) + ...: the same bits on every backend.
        parts = _gather_stack(x, group)
        out = parts[0].clone()
        for k in range(1, parts.shape[0]):
            out = out + parts[k]
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def framebuffer_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of every rank's ``x``, replicated; identity backward (see the
    module docstring)."""
    return _FramebufferSum.apply(x, group)


def _gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """[W, *t.shape]: every rank's ``t`` in rank order, on ``t``'s device,
    gathered by one collective into one preallocated tensor."""
    buf = _wire(t, group).reshape(-1)
    w = world_size(group)
    out = buf.new_empty((w * buf.numel(),))
    _all_gather_tensor(out, buf, group=_group(group))
    return out.view(w, *t.shape).to(t.device)


class _AllGatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = _gather_stack(x, group)              # [W, ..., n]
        all_gather_columns.bytes += ((parts.shape[0] - 1) * x.numel()
                                     * x.element_size())
        return torch.cat(parts.unbind(0), dim=-1)    # [..., W * n]

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        w, r = world_size(group), rank(group)
        g = grad.reshape(*grad.shape[:-1], w, grad.shape[-1] // w)
        g = g.movedim(-2, 0).contiguous()            # [W, ..., n]
        if dist.get_backend(_group(group)) == dist.Backend.NCCL:
            out = torch.empty_like(g[0])
            dist.reduce_scatter_tensor(out, g, group=_group(group))
            return out, None
        return all_reduce_sum(g, group)[r], None


def all_gather_columns(x: torch.Tensor, group=None) -> torch.Tensor:
    """[..., n] on each rank -> [..., W * n], rank r's columns at
    [r * n, (r + 1) * n); differentiable (see the module docstring)."""
    return _AllGatherColumns.apply(x, group)


all_gather_columns.bytes = 0


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``t`` to rank + step and receive rank - step's tensor."""
    g = _group(group)
    w, r = world_size(group), rank(group)
    buf = _wire(t, group)
    out = torch.empty_like(buf)
    peer = lambda k: dist.get_global_rank(g, k % w)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, peer(r + step), group=g),
        dist.P2POp(dist.irecv, out, peer(r - step), group=g),
    ])
    for req in reqs:
        req.wait()
    return out.to(t.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ring_shift.bytes += x.numel() * x.element_size()
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's ``x`` -> rank r + 1 (mod W); the reverse shift backward."""
    return _RingShift.apply(x, group)


ring_shift.bytes = 0
