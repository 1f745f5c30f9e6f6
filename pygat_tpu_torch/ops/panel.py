"""Panel-gather SpMM for large clustered graphs (port of
``pygat_tpu/ops/panel.py``).

For each 128-row output tile of the receiver stream, the host collects the
distinct 128-row sender tiles its edges touch, busiest first: the tile's
``P`` panels (:func:`build_panel_layout`). A slot then names its sender by
``g_idx = p * 128 + sender % 128``, the row within panel ``p`` of its output
tile. The JAX package built this so that its TPU kernel could load each
output tile's panels into VMEM once and select rows from them with a
one-hot matmul; on a clustered graph a tile has a few panels. Edges whose
sender tile is not among the ``p_max`` panels of their tile overflow to a
second pass.

Three parts:

* the host half in numpy, field for field the reference's:
  :class:`PanelLayout`, :func:`build_panel_layout`;
* :func:`panel_weighted_sum`, the SpMM over the slots that fit their
  panels: on a CUDA tensor it launches the hand-written kernel
  ``csrc/panel_spmm.cu`` (replaces ``pygat_tpu/ops/panel.py::
  _make_spmm_kernel``), on a CPU tensor it runs
  :func:`panel_weighted_sum_plain`, the plain PyTorch version that is also
  the kernel's oracle;
* the differentiable ops :func:`panel_spmm` and :func:`panel_spmm_graph`:
  the kernel, then the overflow slots by ``index_select`` and
  ``index_add_`` (the reference does that pass in XLA, outside its kernel);
  the backward is the SpMM's (row gathers and ``index_add_``, the
  reference's ``_panel_bwd``) or, with ``plans=``, the gather-free one over
  the corner plans (:func:`~pygat_tpu_torch.ops.large.gather_corner` and
  :func:`~pygat_tpu_torch.ops.large.corner_spmm_backward`).

The port has only the reference's ``high`` contract (f32 sums): the ops
default to ``precision="high"`` where the reference defaults to
``"fastest"``, and ``"fastest"`` raises (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.large import (
    CscCsrPlans,
    corner_spmm_backward,
    gather_corner,
)
from pygat_tpu_torch.ops.spmm import spmm_backward
from pygat_tpu_torch.ops.stream import (
    DEAD,
    EC,
    TILE,
    require_high,
    stream_scatter_plain,
)

_LANE = 128
_MODES = ("onehot", "take")


class PanelLayout(NamedTuple):
    """Host-built panel decomposition of a stream-aligned graph's receiver
    order. The tensors live on the graph's device."""

    panel_tiles: torch.Tensor  # [T, P] int32 sender tile per panel (0 pad)
    g_idx: torch.Tensor  # [E_s] int32: p * 128 + sender % 128; P * 128 = dead
    overflow_edges: torch.Tensor  # [V] int32 edge ids (padded with e_dead)
    n_panels: int  # P
    n_overflow: int  # real overflow edge count

    @property
    def overflow_frac(self) -> float:
        return self.n_overflow / max(self.g_idx.shape[0], 1)

    def to(self, device) -> "PanelLayout":
        """The same layout with its tensors on ``device``."""
        return self._replace(**{f: getattr(self, f).to(device)
                                for f in ("panel_tiles", "g_idx",
                                          "overflow_edges")})


def build_panel_layout(graph, p_max: int | None = None) -> PanelLayout:
    """Collect each output tile's sender-tile panels (numpy, once per
    graph), busiest first; ``p_max`` caps the panel count, and the slots
    beyond it overflow. Equal to the reference's layout field for field.

    The reference masks all E_s slots once per tile; here each tile's slots
    are its chunks, one contiguous range (``r_chunk`` is non-decreasing), so
    the build is linear in E_s. The tile, edge and stream fields are read
    back to the host once."""
    if graph.r_local is None:
        raise ValueError("panel layout needs a stream-aligned graph")
    senders = graph.senders.cpu().numpy().astype(np.int64)
    r_local = graph.r_local.cpu().numpy()
    chunk_tile = graph.r_chunk.cpu().numpy()
    e_s = senders.shape[0]
    n_tiles = graph.num_nodes_padded // TILE

    live = r_local < DEAD
    gtile = senders // TILE
    # chunks [bounds[t], bounds[t + 1]) write tile t
    bounds = np.searchsorted(chunk_tile, np.arange(n_tiles + 1))
    p_slot = np.full(e_s, -1, dtype=np.int64)  # panel index per slot
    panels_per_tile: list[np.ndarray] = []
    for t in range(n_tiles):
        lo = bounds[t] * EC
        idx = lo + np.nonzero(live[lo:bounds[t + 1] * EC])[0]
        tiles_t, inverse, counts = np.unique(gtile[idx], return_inverse=True,
                                             return_counts=True)
        order = np.argsort(-counts)  # the reference's ranking, ties included
        rank = np.empty(tiles_t.shape[0], dtype=np.int64)
        rank[order] = np.arange(tiles_t.shape[0])
        if p_max is not None:
            order = order[:p_max]
            rank[rank >= p_max] = -1
        panels_per_tile.append(tiles_t[order])
        p_slot[idx] = rank[inverse.reshape(-1)]

    p = max((pt.shape[0] for pt in panels_per_tile), default=1) or 1
    panel_tiles = np.zeros((n_tiles, p), dtype=np.int32)
    for t, pt in enumerate(panels_per_tile):
        panel_tiles[t, : pt.shape[0]] = pt

    fits = live & (p_slot >= 0)
    g_idx = np.where(fits, p_slot * TILE + senders % TILE, p * TILE).astype(
        np.int32)
    overflow = np.nonzero(live & (p_slot < 0))[0]
    n_ov = overflow.shape[0]
    # pad the overflow list with a dead slot id (weight 0 there)
    dead_slots = np.nonzero(~live)[0]
    e_dead = int(dead_slots[0]) if dead_slots.size else 0
    v = max(-(-n_ov // _LANE) * _LANE, _LANE)
    overflow_p = np.full(v, e_dead, dtype=np.int32)
    overflow_p[:n_ov] = overflow

    device = graph.senders.device
    return PanelLayout(
        panel_tiles=torch.from_numpy(panel_tiles).to(device),
        g_idx=torch.from_numpy(g_idx).to(device),
        overflow_edges=torch.from_numpy(overflow_p).to(device),
        n_panels=p,
        n_overflow=n_ov,
    )


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------


def _check_args(values, x, panel_tiles, g_idx, edge_mask, r_local, r_chunk):
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] % TILE:
        raise ValueError(f"panel_spmm: x must be [N_pad, L] float32 on "
                         f"128-row tiles, got {x.dtype} {tuple(x.shape)}")
    n_pad, e_s = x.shape[0], r_chunk.shape[0] * EC
    if panel_tiles.dim() != 2 or panel_tiles.shape[0] != n_pad // TILE:
        raise ValueError(f"panel_spmm: panel_tiles must be [{n_pad // TILE}, "
                         f"P], got {tuple(panel_tiles.shape)}")
    for name, t in (("g_idx", g_idx), ("r_local", r_local),
                    ("values", values), ("edge_mask", edge_mask)):
        if tuple(t.shape) != (e_s,):
            raise ValueError(f"panel_spmm: {name} must hold EC slots per "
                             f"chunk of r_chunk ({e_s}), got "
                             f"{tuple(t.shape)}")
    for name, t in (("panel_tiles", panel_tiles), ("g_idx", g_idx),
                    ("r_local", r_local), ("r_chunk", r_chunk)):
        if t.dtype != torch.int32:
            raise ValueError(f"panel_spmm: {name} must be int32, got {t.dtype}")
    if values.dtype != torch.float32 or edge_mask.dtype != torch.bool:
        raise ValueError("panel_spmm: values must be float32 and edge_mask "
                         "bool")


def panel_weighted_sum_plain(values, x, panel_tiles, g_idx, edge_mask,
                             r_local, r_chunk) -> torch.Tensor:
    """Plain PyTorch version of :func:`panel_weighted_sum`: the panel row
    of every slot that fits, a row gather, and ``index_add_``."""
    _check_args(values, x, panel_tiles, g_idx, edge_mask, r_local, r_chunk)
    p = panel_tiles.shape[1]
    take = (g_idx >= 0) & (g_idx < p * TILE) & (r_local < TILE)
    gi = torch.where(take, g_idx, 0).long()
    tile = r_chunk.long().repeat_interleave(EC)
    rows = panel_tiles[tile, gi // TILE].long() * TILE + gi % TILE
    w = torch.where(edge_mask, values, 0.0)
    msgs = torch.where(take[:, None], w[:, None] * x[rows], 0.0)
    return stream_scatter_plain(msgs, r_local, r_chunk, x.shape[0])


@build.counted(kernel="panel_spmm")
def panel_weighted_sum(values, x, panel_tiles, g_idx, edge_mask, r_local,
                       r_chunk) -> torch.Tensor:
    """[N_pad, L] f32: over the receiver stream, the sum per receiver of
    ``values[k] * x[panel_tiles[r_chunk[k // EC], g // 128] * 128 + g %
    128]`` for the slots ``k`` whose ``g = g_idx[k]`` is below ``P * 128``
    and whose ``edge_mask`` is true; dead and overflow slots add nothing.
    On a CUDA tensor this launches ``csrc/panel_spmm.cu`` (counted in
    ``panel_weighted_sum.launches``); on a CPU tensor it runs
    :func:`panel_weighted_sum_plain`. Not differentiable."""
    if x.device.type == "cpu":
        return panel_weighted_sum_plain(values, x, panel_tiles, g_idx,
                                        edge_mask, r_local, r_chunk)
    if x.device.type != "cuda":
        raise ValueError(f"panel_spmm: unsupported device {x.device}")
    _check_args(values, x, panel_tiles, g_idx, edge_mask, r_local, r_chunk)
    n_pad, width = x.shape
    out = torch.empty(n_pad, width, dtype=torch.float32, device=x.device)
    build.launch(panel_weighted_sum, values, edge_mask, x, panel_tiles, g_idx,
                 r_local, r_chunk, r_chunk.shape[0], n_pad // TILE,
                 panel_tiles.shape[1], width, out)
    return out


# ---------------------------------------------------------------------------
# Differentiable ops
# ---------------------------------------------------------------------------


def _panel_fwd(values, dense, panel_tiles, g_idx, overflow_edges, senders,
               receivers, edge_mask, r_local, r_chunk):
    """The kernel over the slots that fit their panels, then the overflow
    slots ``overflow_edges`` (entries on a dead slot add zero) by a row
    gather and ``index_add_``; an empty overflow list adds nothing."""
    out = panel_weighted_sum(values, dense, panel_tiles, g_idx, edge_mask,
                             r_local, r_chunk)
    if overflow_edges.numel():
        ov = overflow_edges.long()
        w_ov = torch.where(edge_mask[ov], values[ov], 0.0)
        out.index_add_(0, receivers[ov].long(),
                       w_ov[:, None] * dense[senders[ov].long()])
    return out


class _PanelSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, dense, panel_tiles, g_idx, overflow_edges,
                senders, receivers, edge_mask, r_local, r_chunk):
        values, dense = values.contiguous(), dense.contiguous()
        ctx.save_for_backward(values, dense, senders, receivers, edge_mask)
        return _panel_fwd(values, dense, panel_tiles, g_idx, overflow_edges,
                          senders, receivers, edge_mask, r_local, r_chunk)

    @staticmethod
    def backward(ctx, g):
        return spmm_backward(g, *ctx.saved_tensors) + (None,) * 8


class _PanelSpmmCorner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, dense, graph, layout, overflow_edges, plans):
        values, dense = values.contiguous(), dense.contiguous()
        ctx.save_for_backward(values, dense)
        ctx.graph, ctx.plans = graph, plans
        return _panel_fwd(values, dense, layout.panel_tiles, layout.g_idx,
                          overflow_edges, graph.senders, graph.receivers,
                          graph.edge_mask, graph.r_local, graph.r_chunk)

    @staticmethod
    def backward(ctx, g):
        values, dense = ctx.saved_tensors
        graph, plans = ctx.graph, ctx.plans
        rows = gather_corner(dense, graph, plans.fwd)  # dense[senders]
        v = torch.where(graph.edge_mask, values, 0.0)
        return corner_spmm_backward(g, v, rows, graph,
                                    plans.inv) + (None,) * 4


def _check_options(what: str, precision: str, mode: str) -> None:
    require_high(what, precision)
    if mode not in _MODES:
        raise ValueError(f"{what}: unknown mode {mode!r}")


def panel_spmm(values, dense, panel_tiles, g_idx, overflow_edges, senders,
               receivers, edge_mask, r_local, r_chunk, p: int | None = None,
               precision: str = "high", mode: str = "onehot"):
    """``out[N_pad, L]``: the receiver segment sum of ``values *
    dense[senders]`` through the panels (``values`` [E_s] f32 in the
    graph's stream edge order; padding edges weigh 0 through
    ``edge_mask``), the overflow slots ``overflow_edges`` added after.
    Differentiable in ``values`` and ``dense`` (the SpMM backward: row
    gathers and ``index_add_``). ``p`` must be ``panel_tiles.shape[1]``
    when given. ``mode`` (the reference's one-hot or take select) has no
    counterpart: the kernel reads rows natively and computes the same sum
    either way. ``precision``: 'high' only (the reference defaults to
    'fastest', which is not ported: ROADMAP Queue 1, item 9)."""
    _check_options("panel_spmm", precision, mode)
    if p is not None and p != panel_tiles.shape[1]:
        raise ValueError(f"panel_spmm: p={p} but panel_tiles has "
                         f"{panel_tiles.shape[1]} panels")
    return _PanelSpmm.apply(values, dense, panel_tiles, g_idx, overflow_edges,
                            senders, receivers, edge_mask, r_local, r_chunk)


def panel_spmm_graph(values, dense, graph, layout: PanelLayout, *,
                     plans: CscCsrPlans | None = None,
                     precision: str = "high", mode: str = "onehot"):
    """Graph-level :func:`panel_spmm` (``values`` in the graph's stream edge
    order); only the layout's ``n_overflow`` real overflow slots are
    added, so a layout without overflow runs the kernel alone. ``plans``
    swaps the backward for the gather-free one over the corner plans (same
    forward): ``expand`` of the cotangent, the sender rows by
    :func:`~pygat_tpu_torch.ops.large.gather_corner` and the sender sum by
    :func:`~pygat_tpu_torch.ops.large.scatter_corner`. ``mode`` and
    ``precision`` as :func:`panel_spmm` ('high' by default, where the
    reference defaults to 'fastest')."""
    _check_options("panel_spmm_graph", precision, mode)
    overflow = layout.overflow_edges[:layout.n_overflow]
    if plans is not None:
        return _PanelSpmmCorner.apply(values, dense, graph, layout, overflow,
                                      plans)
    return _PanelSpmm.apply(values, dense, layout.panel_tiles, layout.g_idx,
                            overflow, graph.senders, graph.receivers,
                            graph.edge_mask, graph.r_local, graph.r_chunk)
