"""Head-batched sparse GATv1 and GATv2 layers (port of the fused branches
of ``pygat_tpu/models/layers.py::gat_v1_sparse_heads`` and
``gat_v2_sparse_heads`` and the pieces they use).

Dropout placement copies the reference: on the inputs, after the
projection(s), and on the attention numerators, with the softmax denominator
computed from pre-dropout numerators (reference layers.py:150-160). Masks
are drawn from an explicit ``torch.Generator``: the same distribution as
the JAX package's masks, not the same bits.

With a :class:`~pygat_tpu_torch.ops.banded.BandPlan` (``plan=``, the large-N
path the trainers pick past 300k nodes) the attention runs over the plan's
banded slots, and its keep mask is drawn over those slots, not the receiver
stream's: a different draw of the same distribution, as in the JAX package.
With :class:`~pygat_tpu_torch.ops.large.CscCsrPlans` (the corner plans,
opt-in) it runs over the receiver stream's slots with sender windows built
by expand and corner-turn, and draws the stream path's keep mask at the
stream path's site: the same generator gives both paths the same masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.ops.banded import (
    BandPlan,
    fused_v1_attention_banded,
    fused_v2_attention_banded,
)
from pygat_tpu_torch.ops.fused_corner import (
    fused_v1_attention_corner,
    fused_v2_attention_corner,
)
from pygat_tpu_torch.ops.fused_stream import (
    fused_v1_attention,
    fused_v2_attention,
    leaky_relu,
)
from pygat_tpu_torch.ops.large import CscCsrPlans

# Softmax-denominator clamp. 1e-18, not 0: with the bound-shifted softmax a
# row whose incoming logits all sit far under the bound can underflow its
# denominator toward the f32 subnormal band; a naive backward forms den^2,
# which underflows to 0 below den ~1.1e-19, and 1/den^2 = inf turns every
# parameter gradient NaN. 1e-18 keeps den^2 normal while zeroing only rows
# whose best incoming edge sits > 41 nats under the bound. The clamp alone
# is not enough: just above it the per-element products g*agg/den^2 can
# still overflow, so every division by den goes through softmax_div, whose
# backward uses one power of den (see _DivStable).
DEN_MIN = 1e-18


class _DivStable(torch.autograd.Function):
    """``agg / den[..., None]`` with an overflow-safe backward: the den
    cotangent is computed as ``-sum(g * out) / den`` (intermediates of the
    scale of the true value), never through ``agg / den**2``."""

    @staticmethod
    def forward(ctx, agg, den):
        out = agg / den[..., None]
        ctx.save_for_backward(out, den)
        return out

    @staticmethod
    def backward(ctx, g):
        out, den = ctx.saved_tensors
        return g / den[..., None], -(g * out).sum(-1) / den


def softmax_div(agg: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Clamped, backward-stable softmax normalization: agg [..., F] divided
    by den [...]; rows with den <= DEN_MIN (padding / numerically collapsed)
    pass through unscaled with zero den-gradient."""
    den = torch.where(den > DEN_MIN, den, torch.ones_like(den))
    return _DivStable.apply(agg, den)


class V1Params(NamedTuple):
    W: torch.Tensor  # [H, F_in, F_out]
    a: torch.Tensor  # [H, 2 * F_out] (a[:, :F_out] receiver, a[:, F_out:] sender)
    skip: torch.Tensor | None  # [H, F_in, F_out] or None


class V2Params(NamedTuple):
    W: torch.Tensor  # [H, 2 * F_in, F_out] (W[:, :F_in] left, W[:, F_in:] right)
    a: torch.Tensor  # [H, F_out]
    skip: torch.Tensor | None  # [H, F_in, F_out] or None


def _keep(gen: torch.Generator, keep_prob: float, shape) -> torch.Tensor:
    """Boolean keep mask, one draw per dropout site (P(keep) = keep_prob)."""
    return torch.rand(shape, generator=gen, device=gen.device) < keep_prob


def _heads_tail(out, params: V1Params | V2Params, h, x_h, concat: bool):
    """Shared skip/ELU/concat-or-mean tail: ``out`` is [N, H, F_out]."""
    n, n_heads, f_out = out.shape
    if params.skip is not None:
        if x_h is not None:
            out = out + torch.einsum("nhf,hfo->nho", x_h, params.skip)
        else:
            out = out + torch.einsum("nf,hfo->nho", h, params.skip)
    if concat:
        return F.elu(out).reshape(n, n_heads * f_out)
    return out.mean(dim=1)


def _att_keepq(gen, keep: float, n_slots: int, n_heads: int,
               use_drop: bool, device) -> torch.Tensor:
    """[E, H] attention keep/(1-p) factors over ``n_slots`` edge slots
    (ones in eval)."""
    if not use_drop:
        return torch.ones(n_slots, n_heads, dtype=torch.float32,
                          device=device)
    return torch.where(_keep(gen, keep, (n_slots, n_heads)), 1.0 / keep, 0.0)


def _slots(graph: Graph, plan: BandPlan | CscCsrPlans | None) -> int:
    """The attention's edge slots: a band plan's banded ones, else the
    receiver stream's (also over the corner plans)."""
    return plan.num_slots if isinstance(plan, BandPlan) else graph.num_edges_padded


def _need_stream_layout(graph: Graph) -> None:
    if graph.r_local is None:
        raise NotImplementedError(
            "graphs without a stream layout (N_pad not a multiple of 128) "
            "need the unfused branch, not yet ported (ROADMAP Queue 1, "
            "item 10: unfused layer branches)")


def gat_v1_sparse_heads(
    params: V1Params,  # stacked [H, ...] leaves
    h: torch.Tensor,  # [N, F_in] (or [N, H*F] from a previous concat layer)
    graph: Graph,
    gen: torch.Generator | None,  # dropout generator; unused unless train
    *,
    alpha: float,
    drop: float,
    concat: bool,
    train: bool,
    plan: BandPlan | CscCsrPlans | None = None,
) -> torch.Tensor:
    """Head-batched sparse GATv1 through the fused attention op (over the
    banded order of a band ``plan``, or over the corner plans).

    Heads stay folded into the minor axis (``[N, H*F_out]`` projections,
    ``[E, H]`` per-edge factors). Returns ``[N, H*F_out]`` (ELU'd head
    concat) when ``concat`` else the head mean ``[N, F_out]``.
    """
    _need_stream_layout(graph)
    n_heads, f_in, f_out = params.W.shape
    n = h.shape[0]
    use_drop = train and drop > 0.0
    keep = 1.0 - drop

    if use_drop:
        # per-head masked inputs [N, H, F_in] and one batched product
        x_h = torch.where(_keep(gen, keep, (n, n_heads, f_in)),
                          h[:, None, :] / keep, 0.0)
        wh = torch.einsum("nhf,hfo->nho", x_h, params.W).reshape(
            n, n_heads * f_out)
        wh = torch.where(_keep(gen, keep, wh.shape), wh / keep, 0.0)
    else:
        x_h = None
        wh = h @ params.W.permute(1, 0, 2).reshape(f_in, n_heads * f_out)

    wh3 = wh.view(n, n_heads, f_out)
    f_dst_n = torch.einsum("nho,ho->nh", wh3, params.a[:, :f_out])  # [N, H]
    # Softmax stabilization without a segment max: the softmax is invariant
    # to a per-receiver shift, so subtract the upper bound
    # leaky(f_dst + max over real senders of f_src) >= every logit of the
    # row (gradient-stopped: the shift's true gradient is zero).
    with torch.no_grad():
        f_src_n = torch.einsum("nho,ho->nh", wh3, params.a[:, f_out:])
        m_src = torch.where(graph.node_mask[:, None], f_src_n,
                            float("-inf")).amax(dim=0)
        m_src = torch.where(torch.isfinite(m_src), m_src, 0.0)
        bound = leaky_relu(f_dst_n + m_src[None, :], alpha)
    keepq = _att_keepq(gen, keep, _slots(graph, plan), n_heads, use_drop,
                       wh.device)
    if isinstance(plan, BandPlan):
        agg, den = fused_v1_attention_banded(
            wh, f_dst_n, bound, params.a[:, f_out:], keepq, plan, alpha)
    elif plan is not None:
        agg, den = fused_v1_attention_corner(
            wh, f_dst_n, bound, params.a[:, f_out:], keepq, graph, plan, alpha)
    else:
        agg, den = fused_v1_attention(
            wh, f_dst_n, bound, params.a[:, f_out:], keepq,
            graph.senders, graph.receivers, graph.r_local, graph.r_chunk,
            graph.c_slot, graph.c_local, graph.c_chunk, alpha,
            graph.stream_walk, graph.sender_walk,
        )
    out = softmax_div(agg.view(n, n_heads, f_out), den)
    return _heads_tail(out, params, h, x_h, concat)


def gat_v2_sparse_heads(
    params: V2Params,  # stacked [H, ...] leaves; W [H, 2*F_in, F_out]
    h: torch.Tensor,  # [N, F_in]
    graph: Graph,
    gen: torch.Generator | None,  # dropout generator; unused unless train
    *,
    alpha: float,
    drop: float,
    concat: bool,
    train: bool,
    plan: BandPlan | CscCsrPlans | None = None,
) -> torch.Tensor:
    """Head-batched sparse GATv2 through the fused attention op (over the
    banded order of a band ``plan``, or over the corner plans): LeakyReLU
    before the a-projection (reference layers.py:280-283), aggregation of
    the LEFT projection ``whi`` gathered at senders (layers.py:296); dropout
    on the input, both projections and the attention numerator (drawn in
    that order), with a pre-dropout softmax denominator. Layouts and return
    value as :func:`gat_v1_sparse_heads`.
    """
    _need_stream_layout(graph)
    n_heads, two_f_in, f_out = params.W.shape
    f_in = two_f_in // 2
    n = h.shape[0]
    hf = n_heads * f_out
    use_drop = train and drop > 0.0
    keep = 1.0 - drop

    # both projections in one product: [W_left | W_right] side by side
    w_ij = torch.cat([params.W[:, :f_in], params.W[:, f_in:]], dim=2)
    if use_drop:
        x_h = torch.where(_keep(gen, keep, (n, n_heads, f_in)),
                          h[:, None, :] / keep, 0.0)
        wh_ij = torch.einsum("nhf,hfo->nho", x_h, w_ij)  # [N, H, 2F]
        whi = wh_ij[:, :, :f_out].reshape(n, hf)
        whj = wh_ij[:, :, f_out:].reshape(n, hf)
        whi = torch.where(_keep(gen, keep, whi.shape), whi / keep, 0.0)
        whj = torch.where(_keep(gen, keep, whj.shape), whj / keep, 0.0)
    else:
        x_h = None
        wh_ij = (h @ w_ij.permute(1, 0, 2).reshape(f_in, 2 * hf)).view(
            n, n_heads, 2 * f_out)
        whi = wh_ij[:, :, :f_out].reshape(n, hf)
        whj = wh_ij[:, :, f_out:].reshape(n, hf)

    # Softmax stabilization without a segment max. The logits are
    #   e[h, i, j] = sum_f a[h, f] * leaky(whi[i, hf] + whj[j, hf])
    # and leaky_relu is monotone, so per (h, f) the j-term is bounded by the
    # max (a >= 0) or min (a < 0) of whj[:, hf] over real nodes:
    #   ub[h, i] = sum_f a+ * leaky(whi + Mq) + a- * leaky(whi + mq) >= e
    # (gradient-stopped: the shift's true gradient is zero).
    with torch.no_grad():
        node_col = graph.node_mask[:, None]
        big = float("inf")
        mq_max = torch.where(node_col, whj, -big).amax(dim=0)  # [H*F]
        mq_min = torch.where(node_col, whj, big).amin(dim=0)
        mq_max = torch.where(torch.isfinite(mq_max), mq_max, 0.0)
        mq_min = torch.where(torch.isfinite(mq_min), mq_min, 0.0)
        whi3 = whi.view(n, n_heads, f_out)
        ub = torch.einsum(
            "nhf,hf->nh",
            leaky_relu(whi3 + mq_max.view(1, n_heads, f_out), alpha),
            params.a.clamp(min=0.0))
        ub = ub + torch.einsum(
            "nhf,hf->nh",
            leaky_relu(whi3 + mq_min.view(1, n_heads, f_out), alpha),
            params.a.clamp(max=0.0))
    keepq = _att_keepq(gen, keep, _slots(graph, plan), n_heads, use_drop,
                       whi.device)
    if isinstance(plan, BandPlan):
        agg, den = fused_v2_attention_banded(whi, whj, ub, params.a, keepq,
                                             plan, alpha)
    elif plan is not None:
        agg, den = fused_v2_attention_corner(whi, whj, ub, params.a, keepq,
                                             graph, plan, alpha)
    else:
        agg, den = fused_v2_attention(
            whi, whj, ub, params.a, keepq,
            graph.senders, graph.receivers, graph.r_local, graph.r_chunk,
            graph.c_slot, graph.c_local, graph.c_chunk, alpha,
            graph.stream_walk, graph.sender_walk,
        )
    out = softmax_div(agg.view(n, n_heads, f_out), den)
    return _heads_tail(out, params, h, x_h, concat)
