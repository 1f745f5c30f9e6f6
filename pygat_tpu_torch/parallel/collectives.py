"""Collectives over the mesh's process group (port of
``pygat_tpu/parallel/collectives.py``).

The JAX package names a mesh axis; the port has one group, the default
one, whose ranks are the ``data`` axis (the model axis is ROADMAP item
18). Without a group each is the identity of one rank. Each function
returns a new tensor and leaves its argument alone.
:func:`ppermute_ring` is differentiable (its gradient is the permute back
by ``-shift``); the reductions are not, and the callers reduce detached
values or gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size() -> int:
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def axis_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _reduce(x: torch.Tensor, op) -> torch.Tensor:
    # a group of one reduces too: the same calls (and, on CUDA, the same
    # NCCL launches to capture) at every world size
    out = x.detach().clone()
    if dist.is_initialized():
        dist.all_reduce(out, op=op)
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.SUM)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    return all_reduce_sum(x) / axis_size()


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MAX)


def all_reduce_min(x: torch.Tensor) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order (the JAX
    ``all_gather(..., tiled=True)``)."""
    if not dist.is_initialized():
        return x.detach().clone()
    parts = [torch.empty_like(x) for _ in range(axis_size())]
    dist.all_gather(parts, x.detach().contiguous())
    return torch.cat(parts)


def _permute(x: torch.Tensor, shift: int) -> torch.Tensor:
    d = axis_size()
    if shift % d == 0:
        return x.clone()
    me = axis_index()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (me + shift) % d),
           dist.P2POp(dist.irecv, out, (me - shift) % d)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PermuteRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift):
        ctx.shift = shift
        return _permute(x, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, -ctx.shift), None


def ppermute_ring(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rotate ``x`` around the ring by ``shift``: send it to rank ``(rank +
    shift) % d`` and return what rank ``(rank - shift) % d`` sent (one
    ``batch_isend_irecv``). With ``shift % d == 0`` (one rank, say) nothing
    is sent. Differentiable: the gradient goes back by ``-shift``, so every
    rank runs the same sends in its backward, in reverse order."""
    return _PermuteRing.apply(x, int(shift))


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier()
