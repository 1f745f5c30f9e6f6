"""The ring GAT model and its transductive loss (port of
``pygat_tpu/parallel/ring_model.py``).

:func:`ring_apply_gat` is ``apply_gat`` of the sparse layer types over the
ring attention of :mod:`~pygat_tpu_torch.parallel.partition`: each rank
projects its own node rows (with the reference's per-head input dropout
and the projections' dropout), runs the attention over its shard's blocks,
and adds the skip, the ELU and the head mean. The attention dropout keeps
are drawn in partition layout ([D, E_blk, H]) from the rank's own
generator, so each rank's masks differ: the same distribution as the JAX
package's, not the same bits. :class:`RingLoss` is the transductive loss
of the rank's nodes over the global split. With a model axis each split
layer runs the rank's heads and combines them over the model group.

:class:`DenseRowsLoss` is the loss of the dense types by receiver rows
(torch has no GSPMD to place the JAX package's [N, N] attention): each
data rank runs ``apply_gat`` over its rows' [H, n_local, N_pad] attention,
the sender projections gathered over the data group (``gather_rows``);
:func:`dense_rows_grid` runs the same per-rank code over a whole mesh on
one device.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from pygat_tpu_torch.models.gat import (
    ONE_DEVICE,
    GATConfig,
    apply_gat,
    group_combine,
    head_parallel,
    layer_piece,
)
from pygat_tpu_torch.models.layers import (
    NO_MASKS,
    _heads_tail,
    _keep,
    dense_project,
)
from pygat_tpu_torch.parallel import collectives as col
from pygat_tpu_torch.parallel.partition import (
    ShardBlocks,
    ring_gat_attention,
    ring_gat_attention_v2,
)
from pygat_tpu_torch.parallel.sharding import ShardIdx


def ring_halo_default() -> bool:
    """``PYGAT_RING_HALO=1``: the direct halo exchange, else the rotation."""
    return os.environ.get("PYGAT_RING_HALO") == "1"


def _drop(x, gen, keep):
    return torch.where(_keep(gen, keep, x.shape), x / keep, 0.0)


def ring_apply_gat(params, cfg: GATConfig, x: torch.Tensor,
                   blocks: ShardBlocks, gen, *, train: bool,
                   halo: bool | None = None, mesh=None) -> torch.Tensor:
    """This rank's [n_local, C] outputs of the sparse model (same math as
    ``apply_gat``): ``x`` [n_local, F0] is the rank's rows, ``blocks`` its
    shard's blocks, ``gen`` its dropout generator (unused unless training
    with dropout). ``halo`` (None: ``PYGAT_RING_HALO``) picks the direct
    halo exchange over the full rotation. Every rank of the ring's group
    calls it together. ``mesh`` (with a model axis): ``params`` are this
    rank's heads and ``gen`` its ``HeadGenerators``; each split layer runs
    the ring over the data group with those heads, and its heads are
    combined over the model group as ``apply_gat(mesh=)`` combines
    them."""
    if not cfg.is_sparse:
        raise ValueError("the ring implements the sparse layer types")
    if halo is None:
        halo = ring_halo_default()
    combine = group_combine(None if mesh is None else mesh.model_group)
    h = x
    for i, lp in enumerate(params):
        h = head_parallel(
            cfg, i, [lp], [gen], h,
            lambda lp, h, gen, split, i=i: _ring_layer(
                cfg, i, lp, h, blocks, gen, train=train, halo=halo,
                head_sum=split),
            combine)
    return h


def _ring_layer(cfg: GATConfig, i: int, lp, h, blocks: ShardBlocks, gen, *,
                train: bool, halo: bool, head_sum: bool) -> torch.Tensor:
    """Layer ``i`` of the ring over the heads of ``lp`` (``head_sum``: a
    final layer's heads summed, not averaged)."""
    use_drop = train and cfg.dropout > 0.0
    keep = 1.0 - cfg.dropout
    concat = i < cfg.nlayers - 1
    n = h.shape[0]
    n_heads, f_out = lp.W.shape[0], lp.W.shape[-1]
    hf = n_heads * f_out
    f_in = h.shape[1]
    x_h = None
    if use_drop:
        x_h = torch.where(_keep(gen, keep, (n, n_heads, f_in)),
                          h[:, None, :] / keep, 0.0)  # [n, H, F_in]
    if cfg.is_v2:
        w_ij = torch.cat([lp.W[:, :f_in], lp.W[:, f_in:]], dim=2)
        if use_drop:
            wh = torch.einsum("nhf,hfo->nho", x_h, w_ij)
        else:
            wh = (h @ w_ij.permute(1, 0, 2).reshape(f_in, 2 * hf)).view(
                n, n_heads, 2 * f_out)
        whi = wh[:, :, :f_out].reshape(n, hf)
        whj = wh[:, :, f_out:].reshape(n, hf)
        if use_drop:
            whi = _drop(whi, gen, keep)
            whj = _drop(whj, gen, keep)
        att = _att_keep(gen, keep, blocks, n_heads) if use_drop else None
        out = ring_gat_attention_v2(whi, whj, lp.a, blocks, alpha=cfg.alpha,
                                    att_keep=att, halo=halo)
    else:
        if use_drop:
            whf = torch.einsum("nhf,hfo->nho", x_h, lp.W).reshape(n, hf)
            whf = _drop(whf, gen, keep)
        else:
            whf = h @ lp.W.permute(1, 0, 2).reshape(f_in, hf)
        f_dst = torch.einsum("nho,ho->nh", whf.view(n, n_heads, f_out),
                             lp.a[:, :f_out])
        att = _att_keep(gen, keep, blocks, n_heads) if use_drop else None
        out = ring_gat_attention(f_dst, whf, lp.a[:, f_out:], blocks,
                                 alpha=cfg.alpha, att_keep=att, halo=halo)
    return _heads_tail(out.view(n, n_heads, f_out), lp, h, x_h, concat,
                       head_sum)


def _att_keep(gen, keep: float, blocks: ShardBlocks, n_heads: int):
    """[D, E_blk, H] keep/(1-p) factors of the attention dropout."""
    shape = (blocks.n_shards, blocks.block_edges, n_heads)
    return torch.where(_keep(gen, keep, shape), 1.0 / keep, 0.0)


class RingLoss:
    """The transductive loss over the ring: ``loss(params, x, graph, labels,
    idx, gen, train) -> (loss, acc, out)`` with ``x``/``labels`` this
    rank's rows and ``idx`` its :class:`ShardIdx` of a split (``graph`` is
    not read). ``loss`` has the value of the mean NLL over the whole split
    and the gradient of this rank's share of it (its nodes' NLL over the
    split's size); ``acc`` is the split's accuracy. Both are reduced over
    the ring's group (a mesh's data group: the model ranks of a data index
    hold the same rows and the same outputs, which a reduction over every
    rank would count ``n_model`` times) with one all-reduce, so every rank
    reads the same numbers. ``mesh``: a mesh with a model axis, whose
    ranks hold their heads of ``params``."""

    def __init__(self, cfg: GATConfig, blocks: ShardBlocks,
                 halo: bool | None = None, mesh=None):
        self.cfg, self.blocks, self.halo, self.mesh = cfg, blocks, halo, mesh

    @property
    def group(self):
        """The group the loss and the gradients reduce over."""
        return self.blocks.group

    def metrics(self, out, labels, idx: ShardIdx, keep_grad: bool = False):
        """(loss, accuracy) of ``out`` [n_local, C] over the split ``idx``."""
        lp = F.log_softmax(F.elu(out), dim=1)[idx.local]
        lab = labels[idx.local].long()
        nll = -lp.gather(1, lab[:, None]).sum() / idx.count
        correct = (lp.argmax(dim=1) == lab).float().sum() / idx.count
        stats = col.all_reduce_sum(torch.stack([nll.detach(), correct]),
                                   self.group)
        loss = nll + (stats[0] - nll.detach()) if keep_grad else stats[0]
        return loss, stats[1]

    def forward(self, params, x, gen, train):
        return ring_apply_gat(params, self.cfg, x, self.blocks, gen,
                              train=train, halo=self.halo, mesh=self.mesh)

    def __call__(self, params, x, graph, labels, idx: ShardIdx, gen, train):
        out = self.forward(params, x, gen, train)
        loss, acc = self.metrics(out, labels, idx, keep_grad=train)
        return loss, acc, out


class DenseRowsLoss(RingLoss):
    """The transductive loss of the dense types over a mesh, as
    :class:`RingLoss`, the rank computing its receiver rows' attention over
    ``neighborhood`` [n_local, N_pad], its rows of the graph's dense
    neighbourhood mask, against every sender's projections, gathered over
    the data group; ``blocks`` is None (the loss reduces over
    ``mesh.data_group``)."""

    def __init__(self, cfg: GATConfig, neighborhood: torch.Tensor, mesh):
        super().__init__(cfg, None, None, mesh)
        self.neighborhood = neighborhood

    @property
    def group(self):
        return self.mesh.data_group

    def forward(self, params, x, gen, train):
        group = self.mesh.data_group
        return apply_gat(params, self.cfg, x, None, gen, train=train,
                         mesh=self.mesh, neighborhood=self.neighborhood,
                         gather=lambda t: col.gather_rows(t, 1, group))


def dense_rows_grid(rank_params: list, cfg: GATConfig, xs: list,
                    neighborhoods: list) -> torch.Tensor:
    """:class:`DenseRowsLoss`'s forward (eval) over a ``(D, M)`` mesh run
    on one device: ``rank_params[m]`` model index ``m``'s heads, ``xs[d]``
    and ``neighborhoods[d]`` data index ``d``'s rows. Layer by layer, every
    data index runs the per-rank code (``layer_piece`` through
    ``head_parallel``, the heads joined by ``torch.cat`` or their sum / H
    as ``apply_gat_pieces`` joins them), its ``gather`` joining the rank's
    sender table with the other data indices' (their rows'
    ``dense_project``) by ``torch.cat``, as ``gather_rows`` joins them.
    Returns the D row blocks' outputs stacked in data order."""
    gens = [None] * len(rank_params)
    hs = list(xs)
    for i in range(cfg.nlayers):
        layers = [p[i] for p in rank_params]
        hs = [head_parallel(
            cfg, i, layers, gens, hs[d],
            lambda lp, h, gen, split, d=d, nb=nb, i=i, ins=hs: layer_piece(
                cfg, i, lp, h, gen, split, graph=None, train=False,
                neighborhood=nb, gather=_grid_gather(cfg, lp, ins, d)),
            ONE_DEVICE) for d, nb in enumerate(neighborhoods)]
    return torch.cat(hs)


def _grid_gather(cfg: GATConfig, lp, ins: list, d: int):
    """Data index ``d``'s ``gather_rows`` of the sender table on one
    device: its own table between the others' (``dense_project`` of their
    inputs ``ins``, eval) in data order."""
    def gather(table):
        return torch.cat([table if k == d else dense_project(
            lp, h, NO_MASKS, alpha=cfg.alpha, drop=cfg.dropout)[2]
            for k, h in enumerate(ins)], dim=1)
    return gather
