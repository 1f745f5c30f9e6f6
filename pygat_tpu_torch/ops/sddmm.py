"""SDDMM: per-edge dot products of two dense row sets (port of
``pygat_tpu/ops/sddmm.py``).

``edge_out[e] = <a[receivers[e]], b[senders[e]]>``, zero on padding edges:
the sampled dense-dense product that gives per-edge logits without the
reference's [2F', E] concat (reference ``layers.py:141-144``) or any [N, N]
product. Differentiable in both dense operands, O(E F) backward.
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.ops.segment import (
    gather_receivers,
    gather_senders,
    segment_sum,
)


class _Sddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, senders, receivers, edge_mask):
        ctx.save_for_backward(a, b, senders, receivers, edge_mask)
        out = (a[receivers.long()] * b[senders.long()]).sum(-1)
        return torch.where(edge_mask, out, 0.0)

    @staticmethod
    def backward(ctx, g):
        a, b, senders, receivers, edge_mask = ctx.saved_tensors
        g = torch.where(edge_mask, g, 0.0)
        da = segment_sum(g[:, None] * b[senders.long()], receivers,
                         a.shape[0])
        db = segment_sum(g[:, None] * a[receivers.long()], senders,
                         b.shape[0], sorted_ids=False)
        return da, db, None, None, None


def sddmm(a: torch.Tensor, b: torch.Tensor, senders: torch.Tensor,
          receivers: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """[E_pad] ``<a[receivers[e]], b[senders[e]]>``, 0 where ``edge_mask``
    is false (plain row gathers and ``index_add_``)."""
    return _Sddmm.apply(a, b, senders, receivers, edge_mask)


def sddmm_graph(a: torch.Tensor, b: torch.Tensor, graph) -> torch.Tensor:
    """Graph-aware SDDMM: the forward is two row gathers and a product; the
    gradients of ``a`` and ``b`` are the receiver and sender stream segment
    sums (``csrc/stream_scatter.cu``)."""
    out = (gather_receivers(a, graph) * gather_senders(b, graph)).sum(-1)
    return torch.where(graph.edge_mask, out, 0.0)
