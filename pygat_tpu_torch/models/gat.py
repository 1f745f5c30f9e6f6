"""Multi-layer multi-head GAT model (port of ``pygat_tpu/models/gat.py``).

Each layer's heads live in one stacked ``[H, ...]`` parameter set
(:class:`~pygat_tpu_torch.models.layers.V1Params` or
:class:`~pygat_tpu_torch.models.layers.V2Params`), the layout of the JAX
package, so parameters carry over between the two packages unchanged
(:mod:`pygat_tpu_torch.models.convert`). Semantics follow the reference
container (models.py:7-35): layer ``i`` takes ``nfeats[i] * nheads[i-1]``
inputs; non-final layers ELU and concat their heads, the final layer
averages them.

``GAT_sparse`` and ``GATv2_sparse`` are ported; the dense layer types raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.models import init as gini
from pygat_tpu_torch.models.layers import (
    V1Params,
    V2Params,
    gat_v1_sparse_heads,
    gat_v2_sparse_heads,
)
from pygat_tpu_torch.ops.banded import BandPlan
from pygat_tpu_torch.utils.platform import resolve_device

LAYER_TYPES = ("GAT", "GAT_sparse", "GATv2", "GATv2_sparse")
PORTED_LAYER_TYPES = ("GAT_sparse", "GATv2_sparse")


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


def _check_ported(cfg: GATConfig) -> None:
    if cfg.layer_type not in LAYER_TYPES:
        raise ValueError(f"unknown layer_type {cfg.layer_type!r}")
    if cfg.layer_type not in PORTED_LAYER_TYPES:
        raise NotImplementedError(
            f"layer_type {cfg.layer_type!r} is not ported yet "
            "(ROADMAP Queue 1, item 10: the dense layers)")


def layer_dims(cfg: GATConfig, i: int) -> tuple[int, int, int]:
    """(in_features, out_features, heads) of layer i, reference models.py:18-25."""
    heads = (1,) + tuple(cfg.nheads)
    return cfg.nfeats[i] * heads[i], cfg.nfeats[i + 1], heads[i + 1]


def init_gat(cfg: GATConfig, gen: torch.Generator,
             device: torch.device | str | None = None
             ) -> list[V1Params | V2Params]:
    """Per-layer stacked-head parameters with the reference's init
    distributions (xavier normal for the sparse W and a, xavier uniform for
    skip projections), drawn from ``gen`` and moved to ``device`` (CUDA
    unless the caller names another device; raises without CUDA). Leaves
    require grad."""
    _check_ported(cfg)
    device = resolve_device(device)
    if len(cfg.nfeats) != cfg.nlayers + 1 or len(cfg.nheads) != cfg.nlayers:
        raise ValueError("nfeats must have nlayers+1 entries, nheads nlayers")

    cls = V2Params if cfg.is_v2 else V1Params
    params = []
    for i in range(cfg.nlayers):
        f_in, f_out, h = layer_dims(cfg, i)
        if cfg.is_v2:
            w = gini.xavier_normal(gen, (h, 2 * f_in, f_out), 2 * f_in + f_out)
            a = gini.xavier_normal(gen, (h, f_out), f_out + 1)
        else:
            w = gini.xavier_normal(gen, (h, f_in, f_out), f_in + f_out)
            a = gini.xavier_normal(gen, (h, 2 * f_out), 2 * f_out + 1)
        skip = (gini.xavier_uniform(gen, (h, f_in, f_out), f_in + f_out)
                if cfg.skip_connection else None)
        params.append(cls(
            *(None if t is None else t.to(device).requires_grad_()
              for t in (w, a, skip))))
    return params


def parameters(params: list[V1Params | V2Params]) -> list[torch.Tensor]:
    """The parameter tensors in a fixed order (layer by layer, W, a, skip)."""
    return [t for p in params for t in p if t is not None]


def apply_gat(
    params: list[V1Params | V2Params],
    cfg: GATConfig,
    x: torch.Tensor,  # [N_pad, F0]
    graph: Graph,
    gen: torch.Generator | None,
    *,
    train: bool,
    plans: BandPlan | None = None,
) -> torch.Tensor:
    """Forward pass; returns raw per-node outputs [N_pad, n_classes] (the
    final layer has no activation; the transductive loss head adds ELU +
    log_softmax). ``gen`` draws the dropout masks and is unused unless
    training with dropout. ``plans`` (a band plan of ``graph``, see
    :func:`~pygat_tpu_torch.ops.banded.maybe_plan_large`) runs every layer's
    attention over the banded order."""
    _check_ported(cfg)
    heads_fn = gat_v2_sparse_heads if cfg.is_v2 else gat_v1_sparse_heads
    h = x
    for i, layer_params in enumerate(params):
        h = heads_fn(
            layer_params, h, graph, gen,
            alpha=cfg.alpha, drop=cfg.dropout,
            concat=i < cfg.nlayers - 1, train=train, plan=plans,
        )
    return h
