"""SpMM: sparse (adjacency with edge values) @ dense (port of
``pygat_tpu/ops/spmm.py``).

The counterpart of the reference's ``SpecialSpmmFunction`` /
``SpecialSpmm`` (reference ``layers.py:70-95``): gradients flow to the edge
values and the dense operand only, and the edge-value gradient is an O(E)
SDDMM, never a dense [N, N] product. ``values[e]`` weights the edge
``senders[e] -> receivers[e]``: ``out[i] = sum_e values[e] *
dense[senders[e]]`` over the edges into ``i``.

:func:`spmm` is the plain version over edge arrays (row gathers and
``index_add_``); :func:`spmm_graph` runs the forward sum through the stream
segment sum (``csrc/stream_scatter.cu``) and the backward through the
sender-side one.
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.ops.segment import (
    gather_senders,
    segment_sum,
    segment_sum_receivers,
)


def spmm_backward(g, values, dense, senders, receivers, edge_mask):
    """(d values, d dense) of the SpMM for the cotangent ``g`` [N_pad, F]:
    the SDDMM ``<g[recv], dense[send]>`` per edge (the reference's dense
    ``grad_output @ b.T`` of ``layers.py:85-87`` at O(E F)) and ``A^T @ g``,
    a sum over senders; row gathers and ``index_add_``."""
    g_recv = g[receivers.long()]
    dvalues = torch.where(
        edge_mask, (g_recv * dense[senders.long()]).sum(-1), 0.0)
    v = torch.where(edge_mask, values, 0.0)
    ddense = segment_sum(v[:, None] * g_recv, senders, dense.shape[0],
                         sorted_ids=False)
    return dvalues, ddense


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, dense, senders, receivers, edge_mask):
        ctx.save_for_backward(values, dense, senders, receivers, edge_mask)
        v = torch.where(edge_mask, values, 0.0)
        return segment_sum(v[:, None] * dense[senders.long()], receivers,
                           dense.shape[0])

    @staticmethod
    def backward(ctx, g):
        return spmm_backward(g, *ctx.saved_tensors) + (None, None, None)


def spmm(values: torch.Tensor, dense: torch.Tensor, senders: torch.Tensor,
         receivers: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """[N_pad, F] scatter-add over receivers of values * dense[senders]."""
    return _Spmm.apply(values, dense, senders, receivers, edge_mask)


def spmm_graph(values: torch.Tensor, dense: torch.Tensor,
               graph) -> torch.Tensor:
    """Graph-aware SpMM: the receiver stream segment sum of
    ``values * dense[senders]``; its backward is the SDDMM
    ``<g[recv], dense[send]>`` and the sender stream segment sum."""
    v = torch.where(graph.edge_mask, values, 0.0)
    msgs = v[:, None] * gather_senders(dense, graph)
    return segment_sum_receivers(msgs, graph)
