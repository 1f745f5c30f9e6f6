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
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.models import init as gini
from pygat_tpu_torch.models.layers import (
    NO_MASKS,
    DropoutMasks,
    V1Params,
    V2Params,
    draw_masks,
    gat_v1_dense,
    gat_v1_sparse_heads,
    gat_v2_dense,
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


def apply_gat(
    params: list[V1Params | V2Params],
    cfg: GATConfig,
    x: torch.Tensor,  # [N_pad, F0]
    graph: Graph,
    gen: torch.Generator | None,
    *,
    train: bool,
    plans: BandPlan | CscCsrPlans | None = None,
) -> torch.Tensor:
    """Forward pass; returns raw per-node outputs [N_pad, n_classes] (the
    final layer has no activation; the transductive loss head adds ELU +
    log_softmax). ``gen`` draws the dropout masks and is unused unless
    training with dropout. ``plans`` (a large-N plan of ``graph``, see
    :func:`~pygat_tpu_torch.ops.banded.maybe_plan_large`) runs every sparse
    layer's fused attention over the banded order of a band plan, or over
    the corner plans; the unfused branch and the dense layers ignore it."""
    _check_type(cfg)
    if cfg.is_sparse:
        heads_fn = gat_v2_sparse_heads if cfg.is_v2 else gat_v1_sparse_heads
        h = x
        for i, layer_params in enumerate(params):
            h = heads_fn(
                layer_params, h, graph, gen,
                alpha=cfg.alpha, drop=cfg.dropout,
                concat=i < cfg.nlayers - 1, train=train, plan=plans,
            )
        return h

    # the reference's `adj > 0` test (layers.py:41) against the densified
    # adjacency, once per forward for every layer
    neighborhood = graph.to_dense(binary=True) > 0
    use_drop = train and cfg.dropout > 0.0
    n_pad = x.shape[0]
    h = x
    for i, layer_params in enumerate(params):
        concat = i < cfg.nlayers - 1
        n_heads, f_out = layer_params.W.shape[0], layer_params.W.shape[-1]
        remat = n_heads * n_pad * n_pad * 4 > _DENSE_VMAP_BYTES
        masks = NO_MASKS
        if use_drop:
            kw = dict(n=n_pad, f_in=h.shape[1], f_out=f_out, e=0)
            # remat: each head's masks drawn on their own, so that no
            # [H, N, N] draw is ever materialized
            masks = ([draw_masks(gen, cfg.layer_type, cfg.dropout, **kw)
                      for _ in range(n_heads)] if remat else
                     draw_masks(gen, cfg.layer_type, cfg.dropout,
                                heads=n_heads, **kw))
        outs = dense_heads(cfg, layer_params, h, neighborhood, masks,
                           concat=concat, train=train, remat=remat)
        if concat:  # torch.cat of the head outputs: head-major blocks
            h = outs.permute(1, 0, 2).reshape(n_pad, -1)
        else:
            h = outs.mean(dim=0)
    return h


def dense_heads(cfg: GATConfig, params: V1Params | V2Params,
                h: torch.Tensor, neighborhood: torch.Tensor,
                masks: DropoutMasks | list[DropoutMasks], *, concat: bool,
                train: bool, remat: bool) -> torch.Tensor:
    """One dense layer's heads -> [H, N, F_out]: batched (``masks`` with
    leading [H] leaves, or :data:`NO_MASKS`), or with ``remat`` one head
    after another, each under ``torch.utils.checkpoint`` with its masks
    passed in (``masks`` a list of per-head masks, or batched masks sliced
    per head): the recompute in the backward reads the same masks, and
    needs no RNG state."""
    fn = gat_v2_dense if cfg.is_v2 else gat_v1_dense
    kw = dict(alpha=cfg.alpha, drop=cfg.dropout, concat=concat, train=train)
    if not remat:
        return fn(params, h, neighborhood, masks, **kw)

    def run_head(p, m):
        return fn(p, h, neighborhood, m, **kw)

    outs = []
    for k in range(params.W.shape[0]):
        p = type(params)(*(None if t is None else t[k] for t in params))
        m = masks[k] if isinstance(masks, list) else DropoutMasks(
            *(None if t is None else t[k] for t in masks))
        outs.append(checkpoint(run_head, p, m, use_reentrant=False,
                               preserve_rng_state=False))
    return torch.stack(outs)
