"""The ring GAT model and its transductive loss (port of
``pygat_tpu/parallel/ring_model.py``).

:func:`ring_apply_gat` is ``apply_gat`` of the sparse layer types over the
ring attention of :mod:`~pygat_tpu_torch.parallel.partition`: each rank
projects its own node rows (with the reference's per-head input dropout
and the projections' dropout), runs the attention over its shard's blocks,
and adds the skip, the ELU and the head mean. The attention dropout keeps
are drawn in partition layout ([D, E_blk, H]) from the rank's own
generator, so each rank's masks differ: the same distribution as the JAX
package's, not the same bits. :func:`make_ring_loss` is the transductive
loss of the rank's nodes over the global split.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from pygat_tpu_torch.models.gat import GATConfig
from pygat_tpu_torch.models.layers import _heads_tail, _keep
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
                   blocks: ShardBlocks, gen: torch.Generator | None, *,
                   train: bool, halo: bool | None = None) -> torch.Tensor:
    """This rank's [n_local, C] outputs of the sparse model (same math as
    ``apply_gat``): ``x`` [n_local, F0] is the rank's rows, ``blocks`` its
    shard's blocks, ``gen`` its dropout generator (unused unless training
    with dropout). ``halo`` (None: ``PYGAT_RING_HALO``) picks the direct
    halo exchange over the full rotation. Every rank of the group calls it
    together."""
    if not cfg.is_sparse:
        raise ValueError("the ring implements the sparse layer types")
    if halo is None:
        halo = ring_halo_default()
    use_drop = train and cfg.dropout > 0.0
    keep = 1.0 - cfg.dropout
    n = x.shape[0]
    h = x
    for i, lp in enumerate(params):
        concat = i < cfg.nlayers - 1
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
            att = (_att_keep(gen, keep, blocks, n_heads)
                   if use_drop else None)
            out = ring_gat_attention_v2(whi, whj, lp.a, blocks,
                                        alpha=cfg.alpha, att_keep=att,
                                        halo=halo)
        else:
            if use_drop:
                whf = torch.einsum("nhf,hfo->nho", x_h, lp.W).reshape(n, hf)
                whf = _drop(whf, gen, keep)
            else:
                whf = h @ lp.W.permute(1, 0, 2).reshape(f_in, hf)
            f_dst = torch.einsum("nho,ho->nh", whf.view(n, n_heads, f_out),
                                 lp.a[:, :f_out])
            att = (_att_keep(gen, keep, blocks, n_heads)
                   if use_drop else None)
            out = ring_gat_attention(f_dst, whf, lp.a[:, f_out:], blocks,
                                     alpha=cfg.alpha, att_keep=att,
                                     halo=halo)
        h = _heads_tail(out.view(n, n_heads, f_out), lp, h, x_h, concat)
    return h


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
    the ranks with one all-reduce, so every rank reads the same numbers."""

    def __init__(self, cfg: GATConfig, blocks: ShardBlocks,
                 halo: bool | None = None):
        self.cfg, self.blocks, self.halo = cfg, blocks, halo

    def metrics(self, out, labels, idx: ShardIdx, keep_grad: bool = False):
        """(loss, accuracy) of ``out`` [n_local, C] over the split ``idx``."""
        lp = F.log_softmax(F.elu(out), dim=1)[idx.local]
        lab = labels[idx.local].long()
        nll = -lp.gather(1, lab[:, None]).sum() / idx.count
        correct = (lp.argmax(dim=1) == lab).float().sum() / idx.count
        stats = col.all_reduce_sum(torch.stack([nll.detach(), correct]))
        loss = nll + (stats[0] - nll.detach()) if keep_grad else stats[0]
        return loss, stats[1]

    def __call__(self, params, x, graph, labels, idx: ShardIdx, gen, train):
        out = ring_apply_gat(params, self.cfg, x, self.blocks, gen,
                             train=train, halo=self.halo)
        loss, acc = self.metrics(out, labels, idx, keep_grad=train)
        return loss, acc, out
