"""Collectives over the mesh's process groups (port of
``pygat_tpu/parallel/collectives.py``).

The JAX package names a mesh axis; the port names a process group:
``group=None`` is the default group (every rank), else a mesh's
``data_group`` or ``model_group``. Without a group each is the identity of
one rank. Each function returns a new tensor and leaves its argument alone.
:func:`ppermute_ring` is differentiable (its gradient is the permute back
by ``-shift``); the reductions and :func:`all_gather` are not, and the
callers reduce detached values or gradients.

The model axis's combines are differentiable, and their backwards differ
on purpose; they sit side by side here:

* :func:`enter_heads`: identity forward, model-group sum of the gradient
  backward. A split layer's input feeds only this rank's heads, so its
  gradient here is this rank's heads' share; the sum makes it the whole
  gradient, the same on every model rank, before it flows into what made
  the input (the gathered or summed output of the layer before, or a
  replicated layer);
* :func:`gather_heads`: model-group all-gather of the heads' columns,
  backward the rank's own slice, no sum. Everything after it runs on the
  same values on every model rank, and (through :func:`enter_heads`)
  receives the whole gradient there, so the gradient arriving here is
  already the same on every model rank: a reduce-scatter sum would count
  it ``n_model`` times;
* :func:`sum_heads`: model-group all-reduce sum (the mean of a final
  layer's heads, divided by H after), backward the identity, for the same
  reason: each rank's partial sum enters the total once;
* :func:`gather_rows`: data-group all-gather of node rows (the dense
  layers' sender tables), backward a reduce-scatter **sum**. Here each
  data rank's receivers read every sender row, and the ranks' gradients
  of those rows are different partial sums that must be added.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(group=None) -> int:
    """The number of ranks of ``group`` (1 without a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def axis_index(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    # a group of one reduces too: the same calls (and, on CUDA, the same
    # NCCL launches to capture) at every world size
    out = x.detach().clone()
    if dist.is_initialized():
        dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.SUM, group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce_sum(x, group) / axis_size(group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MAX, group)


def all_reduce_min(x: torch.Tensor, group=None) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MIN, group)


def _gather_parts(x: torch.Tensor, group) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return parts


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order (the JAX
    ``all_gather(..., tiled=True)``)."""
    if not dist.is_initialized():
        return x.detach().clone()
    return torch.cat(_gather_parts(x, group))


def _permute(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    d = axis_size(group)
    if shift % d == 0:
        return x.clone()
    me = axis_index(group)
    x = x.contiguous()
    out = torch.empty_like(x)

    def peer(k):  # P2POp takes global ranks
        return k if group is None else dist.get_global_rank(group, k)

    ops = [dist.P2POp(dist.isend, x, peer((me + shift) % d), group),
           dist.P2POp(dist.irecv, out, peer((me - shift) % d), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PermuteRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _permute(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, -ctx.shift, ctx.group), None, None


def ppermute_ring(x: torch.Tensor, shift: int = 1, group=None) -> torch.Tensor:
    """Rotate ``x`` around the ring of ``group`` by ``shift``: send it to
    group rank ``(me + shift) % d`` and return what group rank ``(me -
    shift) % d`` sent (one ``batch_isend_irecv``). With ``shift % d == 0``
    (one rank, say) nothing is sent. Differentiable: the gradient goes back
    by ``-shift``, so every rank runs the same sends in its backward, in
    reverse order."""
    return _PermuteRing.apply(x, int(shift), group)


class _EnterHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def enter_heads(x: torch.Tensor, group) -> torch.Tensor:
    """A split layer's input: ``x`` itself; its gradient summed over the
    model ``group`` (see the module docstring). The identity both ways
    without a model group."""
    if group is None:
        return x
    return _EnterHeads.apply(x, group)


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[1]
        return torch.cat(_gather_parts(x, group), dim=1)

    @staticmethod
    def backward(ctx, g):
        me, w = axis_index(ctx.group), ctx.width
        return g[:, me * w:(me + 1) * w].contiguous(), None


def gather_heads(x: torch.Tensor, group) -> torch.Tensor:
    """A concat layer's heads: this rank's ``[N, H/M * F]`` columns beside
    every model rank's, in model order, ``[N, H * F]`` head-major as the
    layer on one device gives them; backward the rank's own columns (see
    the module docstring). ``x`` itself without a model group."""
    if group is None:
        return x
    return _GatherHeads.apply(x, group)


class _SumHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_heads(x: torch.Tensor, group) -> torch.Tensor:
    """A final layer's heads: the sum of every model rank's head sum
    ``[N, F]``; backward the identity (see the module docstring). ``x``
    itself without a model group."""
    if group is None:
        return x
    return _SumHeads.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(_gather_parts(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        me, n, dim = axis_index(ctx.group), ctx.n, ctx.dim
        if dist.get_backend(ctx.group) == dist.Backend.NCCL:
            parts = [t.contiguous() for t in g.split(n, dim=dim)]
            out = torch.empty_like(parts[0])
            dist.reduce_scatter(out, parts, group=ctx.group)
            return out, None, None
        # gloo has no reduce-scatter: the whole sum, then this rank's rows
        total = all_reduce_sum(g, ctx.group)
        return total.narrow(dim, me * n, n).contiguous(), None, None


def gather_rows(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every data rank's node rows of ``x`` (along ``dim``) side by side,
    in rank order; backward a reduce-scatter sum (see the module
    docstring). ``x`` itself without a process group."""
    if not dist.is_initialized():
        return x
    return _GatherRows.apply(x, dim, group)


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if dist.is_initialized():
        dist.barrier()
