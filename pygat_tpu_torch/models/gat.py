"""Multi-layer multi-head GAT model (port of ``pygat_tpu/models/gat.py``).

Each layer's heads live in one stacked ``[H, ...]`` parameter set
(:class:`~pygat_tpu_torch.models.layers.V1Params` or
:class:`~pygat_tpu_torch.models.layers.V2Params`), the layout of the JAX
package, so parameters carry over between the two packages unchanged
(:mod:`pygat_tpu_torch.models.convert`). Semantics follow the reference
container (models.py:7-35): layer ``i`` takes ``nfeats[i] * nheads[i-1]``
inputs; non-final layers ELU and concat their heads, the final layer
averages them.

The sparse types run the head-batched sparse layers. The dense types
(``GAT``, ``GATv2``) run a layer's heads as one batch of ``[H, N, N]``
attention over the graph's dense neighbourhood mask; above
``PYGAT_DENSE_VMAP_BYTES`` of such attention (2 GiB by default, as in the
JAX package) the heads run one after another, each under
``torch.utils.checkpoint``, so that the backward recomputes a head's
attention instead of keeping it. Their dropout masks are drawn before the
checkpointed function and passed in: the recompute reads the same masks
(the checkpoint's RNG stash covers the global generators only, and the
port draws from an explicit one).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.models import init as gini
from pygat_tpu_torch.models.layers import (
    NO_MASKS,
    DropoutMasks,
    V1Params,
    V2Params,
    dense_attend,
    dense_project,
    draw_masks,
    gat_v1_sparse_heads,
    gat_v2_sparse_heads,
)
from pygat_tpu_torch.ops.banded import BandPlan
from pygat_tpu_torch.ops.large import CscCsrPlans
from pygat_tpu_torch.utils.platform import resolve_device

LAYER_TYPES = ("GAT", "GAT_sparse", "GATv2", "GATv2_sparse")

# Dense attention switches from batched heads to sequential rematerialized
# heads above this many bytes of [H, N, N] f32 attention (see apply_gat).
_DENSE_VMAP_BYTES = int(os.environ.get("PYGAT_DENSE_VMAP_BYTES", 2 << 30))


class GATConfig(NamedTuple):
    nlayers: int
    nheads: tuple[int, ...]  # heads per layer, e.g. (8, 1)
    nfeats: tuple[int, ...]  # len == nlayers + 1, e.g. (1433, 8, 7)
    dropout: float
    alpha: float
    layer_type: str = "GAT_sparse"
    skip_connection: bool = False

    @property
    def is_sparse(self) -> bool:
        return self.layer_type.endswith("_sparse")

    @property
    def is_v2(self) -> bool:
        return self.layer_type.startswith("GATv2")


def _check_type(cfg: GATConfig) -> None:
    if cfg.layer_type not in LAYER_TYPES:
        raise ValueError(f"unknown layer_type {cfg.layer_type!r}")


def layer_dims(cfg: GATConfig, i: int) -> tuple[int, int, int]:
    """(in_features, out_features, heads) of layer i, reference models.py:18-25."""
    heads = (1,) + tuple(cfg.nheads)
    return cfg.nfeats[i] * heads[i], cfg.nfeats[i + 1], heads[i + 1]


def init_gat(cfg: GATConfig, gen: torch.Generator,
             device: torch.device | str | None = None
             ) -> list[V1Params | V2Params]:
    """Per-layer stacked-head parameters with the reference's init
    distributions (W and a xavier uniform for the dense types, xavier
    normal for the sparse ones; skip projections always uniform, reference
    layers.py:22,112,119,193,248), drawn from ``gen`` and moved to
    ``device`` (CUDA unless the caller names another device; raises
    without CUDA). Leaves require grad."""
    _check_type(cfg)
    device = resolve_device(device)
    if len(cfg.nfeats) != cfg.nlayers + 1 or len(cfg.nheads) != cfg.nlayers:
        raise ValueError("nfeats must have nlayers+1 entries, nheads nlayers")

    cls = V2Params if cfg.is_v2 else V1Params
    w_init = gini.xavier_normal if cfg.is_sparse else gini.xavier_uniform
    params = []
    for i in range(cfg.nlayers):
        f_in, f_out, h = layer_dims(cfg, i)
        if cfg.is_v2:
            w = w_init(gen, (h, 2 * f_in, f_out), 2 * f_in + f_out)
            a = w_init(gen, (h, f_out), f_out + 1)
        else:
            w = w_init(gen, (h, f_in, f_out), f_in + f_out)
            a = w_init(gen, (h, 2 * f_out), 2 * f_out + 1)
        skip = (gini.xavier_uniform(gen, (h, f_in, f_out), f_in + f_out)
                if cfg.skip_connection else None)
        params.append(cls(
            *(None if t is None else t.to(device).requires_grad_()
              for t in (w, a, skip))))
    return params


def parameters(params: list[V1Params | V2Params]) -> list[torch.Tensor]:
    """The parameter tensors in a fixed order (layer by layer, W, a, skip)."""
    return [t for p in params for t in p if t is not None]


def param_count(params: list[V1Params | V2Params]) -> int:
    return sum(t.numel() for t in parameters(params))


class HeadGenerators(NamedTuple):
    """A model rank's dropout generators under a model axis: ``shared``
    draws the masks of every replicated layer and is seeded alike on every
    model rank of a data index (the replicas stay equal); ``heads`` draws
    the masks of this rank's heads of each split layer, seeded apart (the
    heads' masks stay independent, as on one device)."""

    shared: torch.Generator
    heads: torch.Generator


def layer_generator(gen, split: bool):
    """The generator that draws a layer's masks: ``gen`` itself, or one of
    a :class:`HeadGenerators` pair."""
    if isinstance(gen, HeadGenerators):
        return gen.heads if split else gen.shared
    return gen


def is_split(cfg: GATConfig, i: int, layer_params) -> bool:
    """Whether ``layer_params`` hold a share of layer ``i``'s heads (a
    model rank's, from :func:`~pygat_tpu_torch.parallel.sharding.
    head_slice`) rather than all ``cfg.nheads[i]``."""
    return layer_params.W.shape[0] < cfg.nheads[i]


class HeadCombine(NamedTuple):
    """How a split layer's heads are joined (:func:`head_parallel`):
    ``enter`` passes the layer's input to the pieces; ``cat`` joins the
    pieces of a concat layer, ``sum`` those of the final one (then divided
    by H)."""

    enter: Callable
    cat: Callable
    sum: Callable


# every model rank's pieces run on this device, one after another
ONE_DEVICE = HeadCombine(lambda h: h, lambda outs: torch.cat(outs, dim=1),
                         sum)


def group_combine(group) -> HeadCombine | None:
    """This rank's piece joined with its model ``group``'s:
    ``enter_heads``, ``gather_heads``, ``sum_heads``; None without a
    group (a split layer then raises)."""
    from pygat_tpu_torch.parallel import collectives as col

    if group is None:
        return None
    return HeadCombine(lambda h: col.enter_heads(h, group),
                       lambda outs: col.gather_heads(outs[0], group),
                       lambda outs: col.sum_heads(outs[0], group))


def head_parallel(cfg: GATConfig, i: int, layers: list, gens: list,
                  h: torch.Tensor, piece, combine: HeadCombine | None
                  ) -> torch.Tensor:
    """Layer ``i`` over a model axis: ``layers`` are the layer's parameters
    of the model ranks run here (a rank's own under a process group; every
    rank's, from :func:`~pygat_tpu_torch.parallel.sharding.head_slice`, on
    one device), ``gens`` their generators, ``piece(lp, h, gen, split)``
    the per-rank function (:func:`layer_piece`, or the ring's). A layer
    whose ``layers[0]`` holds all its heads runs whole, once, with the
    replicas' generator; a split one runs every rank's piece on its input
    through ``combine.enter``, each with its heads' generator, and joins
    them: ``combine.cat`` for a concat layer, ``combine.sum`` / H for the
    final one."""
    if not is_split(cfg, i, layers[0]):
        return piece(layers[0], h, layer_generator(gens[0], False), False)
    if combine is None:
        raise ValueError(f"layer {i} holds {layers[0].W.shape[0]} of "
                         f"{cfg.nheads[i]} heads, and there is no model "
                         "group to combine them (a mesh from make_mesh)")
    h = combine.enter(h)
    outs = [piece(lp, h, layer_generator(g, True), True)
            for lp, g in zip(layers, gens)]
    if i < cfg.nlayers - 1:
        return combine.cat(outs)
    return combine.sum(outs) / cfg.nheads[i]


def layer_piece(cfg: GATConfig, i: int, layer_params, h: torch.Tensor, gen,
                split: bool, *, graph: Graph | None, train: bool,
                plans: BandPlan | CscCsrPlans | None = None,
                neighborhood: torch.Tensor | None = None,
                gather=None) -> torch.Tensor:
    """Layer ``i`` over the heads of ``layer_params`` (all of the layer's,
    or with ``split`` a model rank's share) on the input ``h`` [n, F_in],
    which every model rank holds whole: the per-rank function of the
    head-parallel model. Returns the ELU'd heads side by side [n, H_r F]
    of a concat layer; of the final layer the head mean [n, F], or of a
    share the head sum (the caller adds the ranks' sums and divides by H).
    ``gen`` draws the layer's masks (unused unless training with dropout).
    The dense types: ``neighborhood`` [n, N_send] is the receiver rows'
    mask (the whole graph's [N, N], or a rank's rows of it), and
    ``gather`` makes the senders' table [H, N_send, F] from the rows' own
    (None: the rows are every sender)."""
    concat = i < cfg.nlayers - 1
    if cfg.is_sparse:
        heads_fn = gat_v2_sparse_heads if cfg.is_v2 else gat_v1_sparse_heads
        return heads_fn(layer_params, h, graph, gen, alpha=cfg.alpha,
                        drop=cfg.dropout, concat=concat, train=train,
                        plan=plans, head_sum=split and not concat)
    n, n_send = neighborhood.shape
    n_heads, f_out = layer_params.W.shape[0], layer_params.W.shape[-1]
    remat = n_heads * n * n_send * 4 > _DENSE_VMAP_BYTES
    masks = NO_MASKS
    if train and cfg.dropout > 0.0:
        kw = dict(n=n, n_send=n_send, f_in=h.shape[1], f_out=f_out, e=0)
        # remat: each head's masks drawn on their own, so that no
        # [H, n, N_send] draw is ever materialized
        masks = ([draw_masks(gen, cfg.layer_type, cfg.dropout, **kw)
                  for _ in range(n_heads)] if remat else
                 draw_masks(gen, cfg.layer_type, cfg.dropout,
                            heads=n_heads, **kw))
    outs = dense_heads(cfg, layer_params, h, neighborhood, masks,
                       concat=concat, train=train, remat=remat, gather=gather)
    if concat:  # torch.cat of the head outputs: head-major blocks
        return outs.permute(1, 0, 2).reshape(n, -1)
    return outs.sum(dim=0) if split else outs.mean(dim=0)


def _neighborhood(cfg: GATConfig, graph: Graph):
    # the reference's `adj > 0` test (layers.py:41) against the densified
    # adjacency, once per forward for every layer
    return None if cfg.is_sparse else graph.to_dense(binary=True) > 0


def apply_gat(
    params: list[V1Params | V2Params],
    cfg: GATConfig,
    x: torch.Tensor,  # [N_pad, F0]
    graph: Graph | None,
    gen,
    *,
    train: bool,
    plans: BandPlan | CscCsrPlans | None = None,
    mesh=None,
    neighborhood: torch.Tensor | None = None,
    gather=None,
) -> torch.Tensor:
    """Forward pass; returns raw per-node outputs [N_pad, n_classes] (the
    final layer has no activation; the transductive loss head adds ELU +
    log_softmax). ``gen`` draws the dropout masks and is unused unless
    training with dropout. ``plans`` (a large-N plan of ``graph``, see
    :func:`~pygat_tpu_torch.ops.banded.maybe_plan_large`) runs every sparse
    layer's fused attention over the banded order of a band plan, or over
    the corner plans; the unfused branch and the dense layers ignore it.

    ``mesh`` (a :class:`~pygat_tpu_torch.parallel.mesh.Mesh` with a model
    axis; every rank of its model group calls this together): ``params``
    are this rank's heads
    (:func:`~pygat_tpu_torch.parallel.sharding.head_slice`) and ``gen`` its
    :class:`HeadGenerators`. Each split layer runs this rank's heads
    (:func:`layer_piece`) and combines them over the model group
    (:func:`head_parallel`); a layer whose H does not divide by the model
    axis runs whole on every model rank.

    The dense types by receiver rows (``graph`` None): ``x`` is a rank's
    rows, ``neighborhood`` [n, N_pad] their rows of the mask and
    ``gather`` the data group's gather of the sender table (see
    :func:`layer_piece`)."""
    combine = group_combine(None if mesh is None else mesh.model_group)
    return _apply(cfg, [params], [gen], x, combine, graph=graph,
                  train=train, plans=plans, neighborhood=neighborhood,
                  gather=gather)


def apply_gat_pieces(rank_params: list, cfg: GATConfig, x: torch.Tensor,
                     graph: Graph, gens: list, *, train: bool,
                     plans: BandPlan | CscCsrPlans | None = None
                     ) -> torch.Tensor:
    """:func:`apply_gat` over a model axis of ``M = len(rank_params)``
    ranks, run on one device: each split layer once per model rank, with
    its heads (``rank_params[m]``, from ``head_slice``) and its generators
    (``gens[m]``), the pieces joined by ``torch.cat`` (a concat layer) or
    their sum / H (the final one), as ``gather_heads`` / ``sum_heads``
    join them across ranks; a replicated layer once, with rank 0's leaves
    and generators. The same per-rank code as :func:`apply_gat` under a
    mesh, held to the whole model by the tests and on the card."""
    return _apply(cfg, rank_params, gens, x, ONE_DEVICE, graph=graph,
                  train=train, plans=plans)


def _apply(cfg: GATConfig, rank_params: list, gens: list, x: torch.Tensor,
           combine: HeadCombine | None, *, neighborhood=None,
           **piece_kw) -> torch.Tensor:
    _check_type(cfg)
    if neighborhood is None:
        neighborhood = _neighborhood(cfg, piece_kw["graph"])
    h = x
    for i in range(cfg.nlayers):
        h = head_parallel(cfg, i, [p[i] for p in rank_params], gens, h,
                          partial(layer_piece, cfg, i,
                                  neighborhood=neighborhood, **piece_kw),
                          combine)
    return h


def dense_heads(cfg: GATConfig, params: V1Params | V2Params,
                h: torch.Tensor, neighborhood: torch.Tensor,
                masks: DropoutMasks | list[DropoutMasks], *, concat: bool,
                train: bool, remat: bool, gather=None) -> torch.Tensor:
    """One dense layer's heads over the receiver rows ``h`` [n, F_in] ->
    [H, n, F_out]: every head's projections at once (:func:`~pygat_tpu_
    torch.models.layers.dense_project`), the sender table through
    ``gather`` (see :func:`layer_piece`), then the attention
    (:func:`~pygat_tpu_torch.models.layers.dense_attend`): batched
    (``masks`` with leading [H] leaves, or :data:`NO_MASKS`), or with
    ``remat`` one head after another, each under ``torch.utils.checkpoint``
    with its attention mask passed in (``masks`` a list of per-head masks,
    or batched masks sliced per head): the recompute in the backward reads
    the same mask, and needs no RNG state."""
    kw = dict(alpha=cfg.alpha, drop=cfg.dropout)
    att = None
    if not train or cfg.dropout <= 0.0:
        masks = NO_MASKS
    elif isinstance(masks, list):  # the per-head draws of the remat path
        att = [m.m_att for m in masks]
        masks = DropoutMasks(*(None if ms[0] is None else torch.stack(ms)
                               for ms in zip(*masks)))
    hd, recv, table = dense_project(params, h, masks, **kw)
    if gather is not None:
        table = gather(table)
    if not remat:
        return dense_attend(params, hd, recv, table, neighborhood,
                            masks.m_att, concat=concat, **kw)

    def run_head(p, hd_k, recv_k, table_k, m_k):
        return dense_attend(p, hd_k, recv_k, table_k, neighborhood, m_k,
                            concat=concat, **kw)

    outs = []
    for k in range(params.W.shape[0]):
        p = type(params)(*(None if t is None else t[k] for t in params))
        m_k = (att[k] if att is not None else
               None if masks.m_att is None else masks.m_att[k])
        outs.append(checkpoint(run_head, p, hd[k] if hd.dim() == 3 else hd,
                               recv[k], table[k], m_k, use_reentrant=False,
                               preserve_rng_state=False))
    return torch.stack(outs)
