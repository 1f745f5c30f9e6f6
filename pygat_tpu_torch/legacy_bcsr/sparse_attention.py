"""Differentiable sparse GATv1 attention with dropout, by two routes (port
of the JAX package's ``tests/legacy_bcsr/sparse_attention.py``).

:func:`gat_attention_v1` keeps the reference's ``backend`` strings, so a
test calls both packages with the same arguments:

* ``"xla"``, the segment-op route: :func:`_xla_forward`, per-edge logits
  and :func:`~pygat_tpu_torch.ops.segment.segment_softmax_stable`, then
  the aggregation by :func:`~pygat_tpu_torch.ops.segment.sorted_segment_sum`,
  differentiated by autograd;
* ``"pallas"``, the fused route: the BCSR attention forward
  (:func:`~.fused_attention.bcsr_attention`, the kernel
  ``csrc/bcsr_attention.cu`` on CUDA tensors) with the analytic backward
  of the reference's ``_fused_bwd``. With q = keep/(1-p), att the softmax
  weights and attq = att*q:

      dattq[e] = <g[recv_e], wh[send_e]>
      S[i]     = sum over i's edges of attq * dattq
      dl[e]    = attq[e] * dattq[e] - att[e] * S[recv_e]
      dpre     = dl * leaky'(pre)
      df_dst   = sum of dpre per receiver;  df_src = sum of dpre per sender
      dwh[s]   = sum over s's edges of attq[e] * g[recv_e]

  batched over heads as [E, H] columns. The forward's max and denominator
  are its residuals, so the backward takes no segment max, and S[i] is
  ``<g[i], out[i]>``, the same sum (out[i] is sum attq * wh[send]). The
  receiver and sender sums go through
  :func:`~pygat_tpu_torch.ops.segment.segment_sum_receivers` /
  :func:`~pygat_tpu_torch.ops.segment.segment_sum_senders`: on a graph from
  ``build_graph`` on CUDA, one ``stream_scatter`` launch each.

Attention dropout follows the reference (``layers.py`` :150-160): the
denominator comes from the numerators before dropout, the aggregation from
the numerators after it. One keep mask over the graph's edges serves all
heads; it is drawn from an explicit ``torch.Generator`` and carried into
chunk layout through ``TiledGraph.edge_perm``. Its bits differ from the
JAX package's PRNG, as the model's masks do (``models/layers.py``), so the
tests feed both packages one mask through :func:`_gat_attention_v1`.
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.legacy_bcsr.fused_attention import bcsr_attention
from pygat_tpu_torch.legacy_bcsr.tiles import TiledGraph
from pygat_tpu_torch.ops.segment import (
    segment_softmax_stable,
    segment_sum,
    segment_sum_receivers,
    segment_sum_senders,
    sorted_segment_sum,
)


def _leaky(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _attention_weights(f_dst, f_src, senders, receivers, edge_mask, alpha,
                       n_pad, row_ptr=None):
    """(att, pre) [E, ...]: the attention after the softmax and before
    dropout, and the pre-activation, from node terms [N, ...] (trailing
    dimensions, such as heads, are batched)."""
    pre = f_dst[receivers.long()] + f_src[senders.long()]
    logit = _leaky(pre, alpha)
    num, den = segment_softmax_stable(logit, receivers, n_pad,
                                      edge_mask=edge_mask, row_ptr=row_ptr)
    att = num / torch.where(den > 0, den, 1.0)[receivers.long()]
    return att, pre


def _xla_forward(f_dst, f_src, wh, senders, receivers, edge_mask, alpha,
                 keep_scaled=None, row_ptr=None):
    """[H, N_pad, F] by the segment ops, heads batched: f_dst / f_src [H,
    N_pad], wh [H, N_pad, F]; ``keep_scaled`` [E] multiplies the numerator
    only (None: no dropout)."""
    n_pad = f_dst.shape[-1]
    att, _ = _attention_weights(f_dst.T, f_src.T, senders, receivers,
                                edge_mask, alpha, n_pad, row_ptr=row_ptr)
    attq = att if keep_scaled is None else att * keep_scaled[:, None]
    msgs = attq[:, :, None] * wh.permute(1, 0, 2)[senders.long()]  # [E, H, F]
    if row_ptr is not None:
        out = sorted_segment_sum(msgs, receivers, row_ptr)
    else:
        out = segment_sum(msgs, receivers, n_pad)
    return out.permute(1, 0, 2)


class _FusedAttention(torch.autograd.Function):
    """The fused route: the BCSR forward, and the reference's ``_fused_bwd``
    batched over heads."""

    @staticmethod
    def forward(ctx, f_dst, f_src, wh, tiles, drop, keep_scaled, graph,
                alpha, precision):
        f_dst, f_src, wh = (t.contiguous() for t in (f_dst, f_src, wh))
        out, m, den = bcsr_attention(f_dst, f_src, wh, tiles, alpha, drop,
                                     precision)
        ctx.save_for_backward(f_dst, f_src, wh, keep_scaled, out, m, den)
        ctx.graph, ctx.alpha = graph, alpha
        return out

    @staticmethod
    def backward(ctx, g):
        f_dst, f_src, wh, keep_scaled, out, m, den = ctx.saved_tensors
        graph, alpha = ctx.graph, ctx.alpha
        h, n_pad, f = wh.shape
        snd, rcv = graph.senders.long(), graph.receivers.long()
        live = graph.edge_mask[:, None]

        pre = f_dst.T[rcv] + f_src.T[snd]  # [E, H]
        num = torch.where(live, torch.exp(_leaky(pre, alpha) - m.T[rcv]), 0.0)
        att = num / torch.where(den > 0, den, 1.0).T[rcv]
        attq = att if keep_scaled is None else att * keep_scaled[:, None]
        g_n = g.permute(1, 0, 2)  # [N, H, F]
        g_r = g_n[rcv]  # [E, H, F]
        dattq = (g_r * wh.permute(1, 0, 2)[snd]).sum(-1)  # [E, H]
        s = (g_n * out.permute(1, 0, 2)).sum(-1)  # [N, H]
        dl = attq * dattq - att * s[rcv]
        dpre = torch.where(live, torch.where(pre >= 0, dl, alpha * dl), 0.0)
        df_dst = segment_sum_receivers(dpre, graph)
        by_sender = segment_sum_senders(
            torch.cat([dpre, (attq[:, :, None] * g_r).reshape(-1, h * f)], 1),
            graph)
        df_src = by_sender[:, :h]
        dwh = by_sender[:, h:].reshape(n_pad, h, f).permute(1, 0, 2)
        return (df_dst.T, df_src.T, dwh) + (None,) * 6


def _gat_attention_v1(f_dst, f_src, wh, graph: Graph,
                      tiles: TiledGraph | None, *, alpha: float,
                      backend: str = "xla", precision: str = "default",
                      keep_scaled: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`gat_attention_v1` with an explicit dropout multiplier
    ``keep_scaled`` [E_pad] (keep / (1 - p); None: no dropout)."""
    if backend == "pallas":
        if tiles is None:
            raise ValueError("pallas backend requires a TiledGraph")
        if graph.col_perm is None or graph.col_ptr is None:
            # the analytic backward sums over senders through the CSC view
            raise ValueError(
                "pallas backend requires a Graph with a CSC view "
                "(col_perm/col_ptr); build it via "
                "pygat_tpu_torch.graph.build_graph")
        drop = None
        if keep_scaled is not None:
            drop = keep_scaled[tiles.edge_perm.long().clamp(min=0)] * tiles.valid
        return _FusedAttention.apply(f_dst, f_src, wh, tiles, drop,
                                     keep_scaled, graph, alpha, precision)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}: 'pallas' (the fused "
                         "BCSR kernel) or 'xla' (the segment ops)")
    return _xla_forward(f_dst, f_src, wh, graph.senders, graph.receivers,
                        graph.edge_mask, alpha, keep_scaled=keep_scaled,
                        row_ptr=graph.row_ptr)


def gat_attention_v1(
    f_dst: torch.Tensor,  # [H, N_pad]
    f_src: torch.Tensor,  # [H, N_pad]
    wh: torch.Tensor,  # [H, N_pad, F]
    graph: Graph,
    tiles: TiledGraph | None,
    *,
    alpha: float,
    backend: str = "xla",
    precision: str = "default",
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,
    train: bool = False,
) -> torch.Tensor:
    """Head-batched sparse GATv1 attention and aggregation, [H, N_pad, F].

    ``backend="pallas"`` takes the fused route over ``tiles`` (the BCSR
    kernel ``csrc/bcsr_attention.cu`` on CUDA tensors, its plain version on
    CPU ones; needs a graph with the CSC view), ``"xla"`` the segment-op
    route. With ``train`` and ``dropout_rate`` > 0 one keep mask over the
    graph's edges, drawn from ``generator``, serves every head.
    """
    keep_scaled = None
    if train and dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout requires a generator")
        keep = torch.rand(graph.senders.shape, generator=generator,
                          device=graph.senders.device) < 1.0 - dropout_rate
        keep_scaled = keep.to(torch.float32) / (1.0 - dropout_rate)
    return _gat_attention_v1(f_dst, f_src, wh, graph, tiles, alpha=alpha,
                             backend=backend, precision=precision,
                             keep_scaled=keep_scaled)
