"""Segment sums and edge gathers over a Graph (port of the part of
``pygat_tpu/ops/segment.py`` that the SpMM and SDDMM ops use).

* :func:`segment_sum` is the plain scatter-add (``index_add_``), the
  reference's ``jax.ops.segment_sum``;
* :func:`segment_sum_receivers` / :func:`segment_sum_senders` sum edge data
  per receiver / per sender through the stream segment sum (kernel
  ``csrc/stream_scatter.cu``), the receiver side over the graph's physical
  stream order, the sender side through the CSC slot map; their gradient is
  a row gather;
* :func:`gather_receivers` / :func:`gather_senders` are the row gathers
  ``x[graph.receivers]`` / ``x[graph.senders]`` whose gradient is the
  opposite-side stream segment sum, as in the reference's custom VJPs.

Edge data may be [E_pad] or [E_pad, ...]; trailing dimensions are summed
as columns. A graph without stream layouts (N_pad not a multiple of 128)
sums with :func:`segment_sum` instead, where the reference runs its sorted
scans. The reference's ``segment_max``, softmax, scan ops and the impl
switch are not ported here (ROADMAP item 10).
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.ops.stream import stream_scatter


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, sorted_ids: bool = True) -> torch.Tensor:
    """``out[s] = sum of data[e] over segment_ids[e] == s`` ([num_segments,
    ...]). ``sorted_ids`` is accepted for the reference's signature; the
    sum does not need it."""
    del sorted_ids
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _receiver_sum(data: torch.Tensor, graph) -> torch.Tensor:
    n_pad = graph.num_nodes_padded
    if graph.r_local is None:
        return segment_sum(data, graph.receivers, n_pad)
    flat = data.reshape(data.shape[0], -1).contiguous()
    out = stream_scatter(flat, graph.r_local, graph.r_chunk, n_pad)
    return out.reshape((n_pad,) + tuple(data.shape[1:]))


def _sender_sum(data: torch.Tensor, graph) -> torch.Tensor:
    n_pad = graph.num_nodes_padded
    if graph.c_local is None:
        return segment_sum(data, graph.senders, n_pad, sorted_ids=False)
    flat = data.reshape(data.shape[0], -1).contiguous()
    out = stream_scatter(flat, graph.c_local, graph.c_chunk, n_pad,
                         slot=graph.c_slot)
    return out.reshape((n_pad,) + tuple(data.shape[1:]))


class _SumReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, graph):
        ctx.graph = graph
        return _receiver_sum(data, graph)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.graph.receivers.long()], None


class _SumSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, graph):
        ctx.graph = graph
        return _sender_sum(data, graph)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.graph.senders.long()], None


class _GatherReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return x[graph.receivers.long()]

    @staticmethod
    def backward(ctx, g):
        return _receiver_sum(g, ctx.graph), None


class _GatherSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return x[graph.senders.long()]

    @staticmethod
    def backward(ctx, g):
        return _sender_sum(g, ctx.graph), None


def segment_sum_receivers(data: torch.Tensor, graph) -> torch.Tensor:
    """Sum edge ``data`` [E_pad, ...] per receiver -> [N_pad, ...]; the
    gradient is ``g[graph.receivers]``."""
    return _SumReceivers.apply(data, graph)


def segment_sum_senders(data: torch.Tensor, graph) -> torch.Tensor:
    """Sum edge ``data`` [E_pad, ...] per sender -> [N_pad, ...]; the
    gradient is ``g[graph.senders]``."""
    return _SumSenders.apply(data, graph)


def gather_receivers(x: torch.Tensor, graph) -> torch.Tensor:
    """``x[graph.receivers]``, whose gradient is the receiver segment sum."""
    return _GatherReceivers.apply(x, graph)


def gather_senders(x: torch.Tensor, graph) -> torch.Tensor:
    """``x[graph.senders]``, whose gradient is the sender segment sum."""
    return _GatherSenders.apply(x, graph)
