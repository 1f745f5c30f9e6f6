"""GAT attention layers (port of ``pygat_tpu/models/layers.py``).

* :func:`gat_v1_dense` / :func:`gat_v2_dense`: masked ``[N, N]`` attention
  (reference layers.py:8-67, 179-232), GATv2 with the reference's [N, 1]
  logit quirk, each the two halves :func:`dense_project` (the receivers'
  projections) and :func:`dense_attend` (their attention over a sender
  table, which the dense types by receiver rows gather between the two).
  A layer's heads run batched: with stacked ``[H, ...]`` leaves (and
  ``[H, ...]`` masks) every product carries a leading head axis, as the
  JAX package's ``vmap`` gives;
* :func:`gat_v1_sparse` / :func:`gat_v2_sparse`: single-head edge-list
  attention over :func:`~pygat_tpu_torch.ops.segment.segment_softmax_stable`
  (no model path calls them; tests hold them to the reference's goldens);
* :func:`gat_v1_sparse_heads` / :func:`gat_v2_sparse_heads`: the
  head-batched sparse layers of the model. Their fused branch runs the
  fused attention op (over the receiver stream, a band plan's banded
  order, or the corner plans), their unfused branch the segment gathers
  and sums of :mod:`~pygat_tpu_torch.ops.segment` with one receiver sum
  of ``[E, H F + H]``; :func:`~pygat_tpu_torch.ops.fused_stream.
  fused_enabled` picks, as in the JAX package.

Dropout placement copies the reference: on the inputs, after the
projection(s), and on the attention numerators, with the softmax denominator
computed from pre-dropout numerators (reference layers.py:150-160). Masks
are drawn from an explicit ``torch.Generator``: the same distribution as
the JAX package's masks, not the same bits. The dense and single-head
layers also take pre-drawn :class:`DropoutMasks`, so the same boolean masks
can go through both packages.

With a :class:`~pygat_tpu_torch.ops.banded.BandPlan` (``plan=``, the large-N
path the trainers pick past 300k nodes) the fused attention runs over the
plan's banded slots, and its keep mask is drawn over those slots, not the
receiver stream's: a different draw of the same distribution, as in the JAX
package. With :class:`~pygat_tpu_torch.ops.large.CscCsrPlans` (the corner
plans, opt-in) it runs over the receiver stream's slots with sender windows
built by expand and corner-turn, and draws the stream path's keep mask at
the stream path's site: the same generator gives both paths the same masks.
The unfused branch ignores ``plan``, as in the JAX package.

Both sparse branches run at the stream sums' module default precision
(:func:`~pygat_tpu_torch.ops.segment.stream_precision`, set by
``PYGAT_STREAM_PRECISION``: ``'high'``, or ``'fastest'``, one bf16 limb),
as the reference passes ``segment._STREAM_PRECISION``: the fused attention
op in every order (the receiver stream, a band plan, the corner plans)
and the unfused branch's sums.
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
    fused_enabled,
    fused_v1_attention,
    fused_v2_attention,
    leaky_relu,
)
from pygat_tpu_torch.ops.large import CscCsrPlans
from pygat_tpu_torch.ops.segment import (
    gather_receivers,
    gather_receivers_hn,
    gather_senders,
    segment_softmax_stable,
    segment_sum,
    segment_sum_receivers,
    sorted_segment_sum,
    stream_precision,
    take_receivers,
    take_senders,
)

NEG_INF = -9e15  # the reference's masking constant (layers.py:40)

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


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """torch-style inverted dropout (``F.dropout`` semantics) drawn from
    ``gen``."""
    if not train or rate <= 0.0:
        return x
    return apply_mask(x, _keep(gen, 1.0 - rate, x.shape), rate)


class DropoutMasks(NamedTuple):
    """Pre-drawn boolean keep masks of one layer's dropout sites, each
    ``[N, F]`` (or ``[E]`` / ``[N, N]`` for the attention), with a leading
    ``[H]`` when drawn for a layer's heads at once (one draw per site).
    ``m_proj2`` masks the second projection of the GATv2 layers (reference
    layers.py:207-211); None for GATv1."""

    m_in: torch.Tensor | None  # [.., N, F_in]
    m_proj: torch.Tensor | None  # [.., N, F_out]
    m_proj2: torch.Tensor | None  # [.., N, F_out] (GATv2 only)
    m_att: torch.Tensor | None  # [.., E] sparse / [.., N, N] dense


NO_MASKS = DropoutMasks(None, None, None, None)


def apply_mask(x: torch.Tensor, keep: torch.Tensor | None,
               rate: float) -> torch.Tensor:
    """Inverted dropout by a pre-drawn boolean keep mask (None: no-op)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


def draw_masks(gen: torch.Generator, layer_type: str, drop: float, *, n: int,
               f_in: int, f_out: int, e: int, heads: int | None = None,
               train: bool = True, n_send: int | None = None
               ) -> DropoutMasks:
    """A layer's keep masks drawn from ``gen`` in site order (input,
    projection, second projection, attention), with a leading ``[heads]``
    when given: one draw per site for all heads. A dense layer's attention
    is ``[n, n_send]`` (default ``n_send = n``; fewer receiver rows than
    senders by receiver rows)."""
    if not train or drop <= 0.0:
        return NO_MASKS
    lead = () if heads is None else (heads,)
    keep = 1.0 - drop
    att = lead + ((e,) if layer_type.endswith("_sparse")
                  else (n, n if n_send is None else n_send))
    return DropoutMasks(
        m_in=_keep(gen, keep, lead + (n, f_in)),
        m_proj=_keep(gen, keep, lead + (n, f_out)),
        m_proj2=(_keep(gen, keep, lead + (n, f_out))
                 if layer_type.startswith("GATv2") else None),
        m_att=_keep(gen, keep, att),
    )


def _coerce_masks(gen_or_masks, layer_type: str, drop: float, train: bool,
                  n: int, f_in: int, f_out: int, e: int) -> DropoutMasks:
    """Pre-drawn :class:`DropoutMasks` as given, or unbatched masks drawn
    from a ``torch.Generator``; :data:`NO_MASKS` unless training with
    dropout."""
    if not train or drop <= 0.0:
        return NO_MASKS
    if isinstance(gen_or_masks, DropoutMasks):
        return gen_or_masks
    return draw_masks(gen_or_masks, layer_type, drop, n=n, f_in=f_in,
                      f_out=f_out, e=e)


def _finish(h_prime, h_dropped, skip, concat: bool):
    """Shared tail: the skip projection of the dropped input (reference
    layers.py:166), then ELU unless the layer is the last."""
    if skip is not None:
        h_prime = h_prime + h_dropped @ skip
    return F.elu(h_prime) if concat else h_prime


# ---------------------------------------------------------------------------
# Dense layers: masked [N, N] attention. Leaves may carry a leading [H]:
# W [H, F_in, F_out] and a [H, 2F] (or [H, F]) give [H, N, F_out].
# ---------------------------------------------------------------------------


def _vec(a: torch.Tensor) -> torch.Tensor:
    """An attention vector [.., F] as a column [.., F, 1] for a product."""
    return a.unsqueeze(-1)


def dense_project(params: V1Params | V2Params, h: torch.Tensor,
                  m: DropoutMasks, *, alpha: float, drop: float):
    """The first half of a dense layer over the receiver rows ``h``
    [n, F_in]: (the dropped input, the receiver logit term [.., n, 1], the
    sender table [.., n, F_out]). GATv1: ``wh @ a_dst`` and ``wh``; GATv2
    (the reference's per-receiver logit): ``leaky_relu(wh1 + wh2) @ a``
    and ``wh2``, the projection it aggregates."""
    if isinstance(params, V2Params):
        f_in = h.shape[-1]
        h = apply_mask(h, m.m_in, drop)
        wh1 = apply_mask(h @ params.W[..., :f_in, :], m.m_proj, drop)
        wh2 = apply_mask(h @ params.W[..., f_in:, :], m.m_proj2, drop)
        return h, leaky_relu(wh1 + wh2, alpha) @ _vec(params.a), wh2
    f_out = params.W.shape[-1]
    h = apply_mask(h, m.m_in, drop)
    wh = apply_mask(h @ params.W, m.m_proj, drop)
    return h, wh @ _vec(params.a[..., :f_out]), wh


def dense_attend(params: V1Params | V2Params, h: torch.Tensor,
                 recv: torch.Tensor, table: torch.Tensor,
                 adj_mask: torch.Tensor, m_att: torch.Tensor | None, *,
                 alpha: float, drop: float, concat: bool) -> torch.Tensor:
    """The second half: the receivers' masked row softmax over every sender
    of ``table`` [.., N_send, F_out] (``adj_mask`` [n, N_send]; GATv1's
    logit ``leaky_relu(recv + table @ a_src)``, GATv2's ``recv`` broadcast
    along the row), dropped by ``m_att``, the aggregation, and the skip of
    the dropped input ``h`` and the ELU of :func:`_finish`:
    ``[.., n, F_out]``."""
    if isinstance(params, V2Params):
        e = recv  # [.., n, 1], constant along each row
    else:
        e_j = table @ _vec(params.a[..., table.shape[-1]:])  # sender term
        e = leaky_relu(recv + e_j.transpose(-1, -2), alpha)  # e[i, j]
    att = torch.softmax(torch.where(adj_mask, e, NEG_INF), dim=-1)
    att = apply_mask(att, m_att, drop)
    return _finish(att @ table, h, params.skip, concat)


def gat_v1_dense(
    params: V1Params,
    h: torch.Tensor,  # [N, F_in]
    adj_mask: torch.Tensor,  # [N, N] bool; adj_mask[i, j]: edge j -> i
    masks,  # DropoutMasks or a torch.Generator; unused unless train
    *,
    alpha: float,
    drop: float,
    concat: bool,
    train: bool,
) -> torch.Tensor:
    """Dense GATv1 (reference layers.py:8-67): ``[.., N, F_out]``."""
    m = _coerce_masks(masks, "GAT", drop, train, h.shape[-2], h.shape[-1],
                      params.W.shape[-1], 0)
    h, recv, wh = dense_project(params, h, m, alpha=alpha, drop=drop)
    return dense_attend(params, h, recv, wh, adj_mask, m.m_att, alpha=alpha,
                        drop=drop, concat=concat)


def gat_v2_dense(
    params: V2Params,
    h: torch.Tensor,
    adj_mask: torch.Tensor,
    masks,
    *,
    alpha: float,
    drop: float,
    concat: bool,
    train: bool,
) -> torch.Tensor:
    """Reference-faithful dense GATv2, its [N, 1] logit quirk included:
    ``e = leaky_relu(Wh1 + Wh2) @ a`` is per node, broadcast along each row
    against the adjacency mask, so the row softmax is uniform over the
    neighbours; it aggregates the right projection Wh2 (reference
    layers.py:212-220). The sparse GATv2 aggregates the left one."""
    m = _coerce_masks(masks, "GATv2", drop, train, h.shape[-2], h.shape[-1],
                      params.W.shape[-1], 0)
    h, recv, wh2 = dense_project(params, h, m, alpha=alpha, drop=drop)
    return dense_attend(params, h, recv, wh2, adj_mask, m.m_att,
                        alpha=alpha, drop=drop, concat=concat)


# ---------------------------------------------------------------------------
# Single-head sparse layers: edge-list segment attention
# ---------------------------------------------------------------------------


def _sparse_attention_aggregate(edge_logits, values, graph: Graph, m_att, *,
                                drop: float):
    """Segment softmax over each receiver's incoming edges, then the
    aggregation of ``values`` [N, F] gathered at the senders; the
    denominator from pre-dropout numerators (reference layers.py:145-160).
    With the graph's CSC view the gathers and sums take the reference's
    sorted-segment forms."""
    n_pad = graph.num_nodes_padded
    fast = graph.col_perm is not None
    num, den = segment_softmax_stable(
        edge_logits, graph.receivers, n_pad, edge_mask=graph.edge_mask,
        row_ptr=graph.row_ptr if fast else None)
    num = apply_mask(num, m_att, drop)
    if fast:
        vals = take_senders(values, graph.senders, graph.col_perm,
                            graph.col_ptr)
        h_prime = sorted_segment_sum(num[:, None] * vals, graph.receivers,
                                     graph.row_ptr)
    else:
        h_prime = segment_sum(num[:, None] * values[graph.senders.long()],
                              graph.receivers, n_pad)
    return softmax_div(h_prime, den)


def gat_v1_sparse(
    params: V1Params,  # W [F_in, F_out], a [2 F_out]
    h: torch.Tensor,
    graph: Graph,
    masks,
    *,
    alpha: float,
    drop: float,
    concat: bool,
    train: bool,
) -> torch.Tensor:
    """Single-head sparse GATv1 (reference layers.py:98-176)."""
    f_out = params.W.shape[1]
    m = _coerce_masks(masks, "GAT_sparse", drop, train, h.shape[0],
                      h.shape[1], f_out, graph.num_edges_padded)
    h = apply_mask(h, m.m_in, drop)
    wh = apply_mask(h @ params.W, m.m_proj, drop)
    f_dst = wh @ params.a[:f_out]  # pairs the receiver
    f_src = wh @ params.a[f_out:]  # pairs the sender
    if graph.col_perm is not None:
        e_dst = take_receivers(f_dst, graph.receivers, graph.row_ptr)
        e_src = take_senders(f_src, graph.senders, graph.col_perm,
                             graph.col_ptr)
    else:
        e_dst = f_dst[graph.receivers.long()]
        e_src = f_src[graph.senders.long()]
    h_prime = _sparse_attention_aggregate(
        leaky_relu(e_dst + e_src, alpha), wh, graph, m.m_att, drop=drop)
    return _finish(h_prime, h, params.skip, concat)


def gat_v2_sparse(
    params: V2Params,  # W [2 F_in, F_out], a [F_out]
    h: torch.Tensor,
    graph: Graph,
    masks,
    *,
    alpha: float,
    drop: float,
    concat: bool,
    train: bool,
) -> torch.Tensor:
    """Single-head sparse GATv2 (reference layers.py:234-316): LeakyReLU
    before the a-projection, aggregation of the left projection Whi
    gathered at the senders."""
    f_in = h.shape[1]
    m = _coerce_masks(masks, "GATv2_sparse", drop, train, h.shape[0], f_in,
                      params.W.shape[1], graph.num_edges_padded)
    h = apply_mask(h, m.m_in, drop)
    whi = apply_mask(h @ params.W[:f_in], m.m_proj, drop)
    whj = apply_mask(h @ params.W[f_in:], m.m_proj2, drop)
    if graph.col_perm is not None:
        pre = (take_receivers(whi, graph.receivers, graph.row_ptr)
               + take_senders(whj, graph.senders, graph.col_perm,
                              graph.col_ptr))
    else:
        pre = whi[graph.receivers.long()] + whj[graph.senders.long()]
    h_prime = _sparse_attention_aggregate(
        leaky_relu(pre, alpha) @ params.a, whi, graph, m.m_att, drop=drop)
    return _finish(h_prime, h, params.skip, concat)


def _heads_tail(out, params: V1Params | V2Params, h, x_h, concat: bool,
                head_sum: bool = False):
    """Shared skip/ELU/concat-or-mean tail: ``out`` is [N, H, F_out]; a
    final layer's heads are averaged, or with ``head_sum`` summed (a model
    rank's share of the mean over every rank's heads)."""
    n, n_heads, f_out = out.shape
    if params.skip is not None:
        if x_h is not None:
            out = out + torch.einsum("nhf,hfo->nho", x_h, params.skip)
        else:
            out = out + torch.einsum("nf,hfo->nho", h, params.skip)
    if concat:
        return F.elu(out).reshape(n, n_heads * f_out)
    return out.sum(dim=1) if head_sum else out.mean(dim=1)


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


def _unfused_aggregate(gathered, logits, bound, graph: Graph, gen, keep,
                       use_drop: bool, n_heads: int, f_out: int):
    """The unfused branch's softmax and aggregation: numerators ``exp(logit
    - bound)`` [H, E] (0 on padding edges), their dropped copies weighting
    the gathered sender rows [E, H F], and one receiver segment sum of
    both side by side, ``[E, H F + H]`` (the denominator from the
    pre-dropout numerators). Returns the normalized [N, H, F_out]."""
    e_pad, hf = gathered.shape[0], n_heads * f_out
    num = torch.where(graph.edge_mask[None, :],
                      torch.exp(logits - bound[:, graph.receivers.long()]),
                      0.0)
    qnum = (torch.where(_keep(gen, keep, num.shape), num / keep, 0.0)
            if use_drop else num)
    msgs = torch.cat([
        (gathered.view(e_pad, n_heads, f_out) * qnum.t()[:, :, None]
         ).reshape(e_pad, hf),
        num.t(),
    ], dim=1)
    agg = segment_sum_receivers(msgs, graph,
                                precision=stream_precision())  # [N, HF + H]
    return softmax_div(agg[:, :hf].reshape(-1, n_heads, f_out), agg[:, hf:])


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
    head_sum: bool = False,
) -> torch.Tensor:
    """Head-batched sparse GATv1: the fused attention op (over the receiver
    stream, the banded order of a band ``plan``, or the corner plans) where
    :func:`~pygat_tpu_torch.ops.fused_stream.fused_enabled`, else the
    unfused branch (``plan`` ignored).

    Heads stay folded into the minor axis (``[N, H*F_out]`` projections,
    per-edge factors ``[E, H]`` fused, ``[H, E]`` unfused). Returns
    ``[N, H*F_out]`` (ELU'd head concat) when ``concat`` else the head mean
    ``[N, F_out]`` (with ``head_sum`` the head sum).
    """
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
    if not fused_enabled(graph):
        # the sender rows gathered once: the sender logit term is read from
        # them, so the backward sums the logits' and the messages'
        # cotangents per sender in one segment sum
        f_dst = torch.einsum("nho,ho->hn", wh3, params.a[:, :f_out])  # [H, N]
        gathered = gather_senders(wh, graph)  # [E, HF]
        l_src = torch.einsum("ehf,hf->he",
                             gathered.view(-1, n_heads, f_out),
                             params.a[:, f_out:])  # [H, E]
        logits = leaky_relu(gather_receivers_hn(f_dst, graph) + l_src, alpha)
        # the bound leaky(f_dst + max over real senders of f_src) >= every
        # logit of the row (gradient-stopped: the shift's gradient is zero)
        with torch.no_grad():
            f_src = torch.einsum("nho,ho->hn", wh3, params.a[:, f_out:])
            m_src = torch.where(graph.node_mask[None, :], f_src,
                                float("-inf")).amax(dim=1)
            m_src = torch.where(torch.isfinite(m_src), m_src, 0.0)
            bound = leaky_relu(f_dst + m_src[:, None], alpha)
        out = _unfused_aggregate(gathered, logits, bound, graph, gen, keep,
                                 use_drop, n_heads, f_out)
        return _heads_tail(out, params, h, x_h, concat, head_sum)

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
    precision = stream_precision()
    keepq = _att_keepq(gen, keep, _slots(graph, plan), n_heads, use_drop,
                       wh.device)
    if isinstance(plan, BandPlan):
        agg, den = fused_v1_attention_banded(
            wh, f_dst_n, bound, params.a[:, f_out:], keepq, plan, alpha,
            precision)
    elif plan is not None:
        agg, den = fused_v1_attention_corner(
            wh, f_dst_n, bound, params.a[:, f_out:], keepq, graph, plan, alpha,
            precision)
    else:
        agg, den = fused_v1_attention(
            wh, f_dst_n, bound, params.a[:, f_out:], keepq,
            graph.senders, graph.receivers, graph.r_local, graph.r_chunk,
            graph.c_slot, graph.c_local, graph.c_chunk, alpha,
            graph.stream_walk, graph.sender_walk, precision,
        )
    out = softmax_div(agg.view(n, n_heads, f_out), den)
    return _heads_tail(out, params, h, x_h, concat, head_sum)


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
    head_sum: bool = False,
) -> torch.Tensor:
    """Head-batched sparse GATv2, fused or unfused as
    :func:`gat_v1_sparse_heads`: LeakyReLU before the a-projection
    (reference layers.py:280-283), aggregation of the LEFT projection
    ``whi`` gathered at senders (layers.py:296); dropout on the input, both
    projections and the attention numerator (drawn in that order), with a
    pre-dropout softmax denominator. Both branches shift the logits by the
    sign-split bound ``ub``. Layouts and return value as
    :func:`gat_v1_sparse_heads`.
    """
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
    if not fused_enabled(graph):
        pre = leaky_relu(gather_receivers(whi, graph)
                         + gather_senders(whj, graph), alpha)  # [E, HF]
        logits = torch.einsum("ehf,hf->he", pre.view(-1, n_heads, f_out),
                              params.a)  # [H, E]
        out = _unfused_aggregate(gather_senders(whi, graph), logits, ub.t(),
                                 graph, gen, keep, use_drop, n_heads, f_out)
        return _heads_tail(out, params, h, x_h, concat, head_sum)
    precision = stream_precision()
    keepq = _att_keepq(gen, keep, _slots(graph, plan), n_heads, use_drop,
                       whi.device)
    if isinstance(plan, BandPlan):
        agg, den = fused_v2_attention_banded(whi, whj, ub, params.a, keepq,
                                             plan, alpha, precision)
    elif plan is not None:
        agg, den = fused_v2_attention_corner(whi, whj, ub, params.a, keepq,
                                             graph, plan, alpha, precision)
    else:
        agg, den = fused_v2_attention(
            whi, whj, ub, params.a, keepq,
            graph.senders, graph.receivers, graph.r_local, graph.r_chunk,
            graph.c_slot, graph.c_local, graph.c_chunk, alpha,
            graph.stream_walk, graph.sender_walk, precision,
        )
    out = softmax_div(agg.view(n, n_heads, f_out), den)
    return _heads_tail(out, params, h, x_h, concat, head_sum)
