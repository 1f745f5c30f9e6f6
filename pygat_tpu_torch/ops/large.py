"""Expand and the CSC-to-CSR corner plans (port of the expand kernel and
the corner half of ``pygat_tpu/ops/large.py``).

:func:`expand` gives slot ``k`` the row ``x[chunk_tile[k // EC] * 128 +
local[k]]`` and zeros at dead slots (``local == 128``), bit-exact. On a CUDA
tensor it launches the hand-written kernel ``csrc/expand.cu``, which
replaces the TPU kernel ``pygat_tpu/ops/large.py::_make_expand_kernel``; on
a CPU tensor it runs :func:`expand_plain`, the plain PyTorch version that is
also the kernel's oracle. The banded backward (:mod:`.banded`) reads its
receiver-side operands this way, and the corner path (:mod:`.fused_corner`)
its sender rows in CSC order as well. :func:`stream_expand` is its
differentiable form (the reference's), whose gradient is the stream
segment sum on the same side.

:func:`plan_csc_to_csr` builds the corner plans of a graph: the permutation
from its CSC stream slots to its receiver-stream (CSR) slots and back.
:func:`set_corner` / :func:`maybe_plan_corner` select them with the JAX
package's knobs ``PYGAT_CORNER`` (auto/on/off) and ``PYGAT_CORNER_N``, read
at import; 'auto' keeps the reference's threshold of 2^62 padded nodes, so
only 'on' plans.

Over the plans, :func:`gather_corner` gives ``x[senders]`` in receiver-stream
order (the CSC expand, whose chunks each read one 128-row tile of ``x``,
then the forward corner-turn passes) and :func:`scatter_corner` sums
receiver-stream rows per sender (the inverse passes, then the CSC stream
segment sum), neither with a row gather by edge index. The corner SpMM
:func:`spmm_corner_graph` is built from them: ``stream_scatter(v *
gather_corner(x))`` forward, and ``expand`` of the cotangent and
:func:`scatter_corner` backward.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.corner import (
    _P_MAX,
    CornerPlan,
    apply_passes,
    plan_corner_turn,
)
from pygat_tpu_torch.ops.stream import (
    DEAD,
    EC,
    TILE,
    require_high,
    stream_scatter,
)


def _check_args(x, local, chunk_tile):
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] % TILE:
        raise ValueError(f"expand: x must be [N_pad, L] float32 on 128-row "
                         f"tiles, got {x.dtype} {tuple(x.shape)}")
    if local.dim() != 1 or local.shape[0] != chunk_tile.shape[0] * EC:
        raise ValueError("expand: local must hold EC slots per chunk of "
                         "chunk_tile")
    for t in (local, chunk_tile):
        if t.dtype != torch.int32:
            raise ValueError(f"expand takes int32 indices, got {t.dtype}")


def expand_plain(x: torch.Tensor, local: torch.Tensor,
                 chunk_tile: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand` (a row gather)."""
    _check_args(x, local, chunk_tile)
    live = local < TILE
    rows = chunk_tile.long().repeat_interleave(EC) * TILE + local.long()
    rows = torch.where(live, rows, 0)
    return torch.where(live[:, None], x[rows], 0.0)


@build.counted
def expand(x: torch.Tensor, local: torch.Tensor,
           chunk_tile: torch.Tensor) -> torch.Tensor:
    """[C * EC, L] rows of ``x`` [N_pad, L] f32 in stream order: slot ``k``
    gets ``x[chunk_tile[k // EC] * 128 + local[k]]``, zeros where
    ``local[k] == 128``. On a CUDA tensor this launches ``csrc/expand.cu``
    (counted in ``expand.launches``); on a CPU tensor it runs
    :func:`expand_plain`. Not differentiable: :func:`stream_expand` is."""
    if x.device.type == "cpu":
        return expand_plain(x, local, chunk_tile)
    if x.device.type != "cuda":
        raise ValueError(f"expand: unsupported device {x.device}")
    _check_args(x, local, chunk_tile)
    out = torch.empty(local.shape[0], x.shape[1], dtype=torch.float32,
                      device=x.device)
    build.launch(expand, x, local, chunk_tile, chunk_tile.shape[0],
                 x.shape[1], out)
    return out


class _StreamExpand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, local, chunk_tile, n_pad, walk):
        ctx.save_for_backward(local, chunk_tile)
        ctx.n_pad, ctx.walk = n_pad, walk
        return expand(x.contiguous(), local, chunk_tile)

    @staticmethod
    def backward(ctx, g):
        local, chunk_tile = ctx.saved_tensors
        dx = stream_scatter(g.contiguous(), local, chunk_tile, ctx.n_pad,
                            walk=ctx.walk)
        return dx, None, None, None, None


def stream_expand(x: torch.Tensor, local: torch.Tensor,
                  chunk_tile: torch.Tensor, n_pad: int, *,
                  walk=None) -> torch.Tensor:
    """Differentiable :func:`expand` over one stream side (port of the
    reference's ``stream_expand``): the forward is :func:`expand`, the
    gradient the stream segment sum :func:`stream_scatter` on the same
    side, with no permutation and no gather. ``walk`` is that side's walk
    (``graph.stream_walk`` for ``r_local`` / ``r_chunk``,
    ``graph.sender_walk`` for ``c_local`` / ``c_chunk``), which the
    backward needs on a CUDA tensor. The reference's ``precision`` has no
    counterpart: the sums are f32 (``high``)."""
    return _StreamExpand.apply(x, local, chunk_tile, n_pad, walk)


# ---------------------------------------------------------------------------
# CSC -> CSR corner plans and their selection
# ---------------------------------------------------------------------------


class CscCsrPlans(NamedTuple):
    fwd: CornerPlan  # CSC stream order -> CSR (receiver stream) order
    inv: CornerPlan

    def to(self, device) -> "CscCsrPlans":
        """The same plans with their tensors on ``device``."""
        return CscCsrPlans(self.fwd.to(device), self.inv.to(device))


def plan_csc_to_csr(graph, p_cap: int | None = None) -> CscCsrPlans:
    """The bijection from CSC stream slots to CSR edge positions: live slot
    k holds edge ``c_slot[k]``; the dead slots fill the CSR dead positions
    and the length difference (E_s2 >= E_s) in order. ``p_cap`` overrides
    the window-span cap (tests force multi-pass plans on small graphs). The
    plans' tensors go to the graph's device; building them reads ``c_slot``
    and ``c_local`` back to the host once."""
    if graph.c_slot is None:
        raise ValueError("needs a stream-aligned graph")
    c_slot = graph.c_slot.cpu().numpy().astype(np.int64)
    c_local = graph.c_local.cpu().numpy()
    e_s2 = c_slot.shape[0]
    live = c_local < DEAD
    dest = np.full(e_s2, -1, dtype=np.int64)
    dest[live] = c_slot[live]
    used = np.zeros(e_s2, dtype=bool)
    used[c_slot[live]] = True
    dest[~live] = np.nonzero(~used)[0]
    # don't-care rows (unspecified finite outputs): the scattered dead-slot
    # destinations would otherwise widen the window spans. Forward: dead
    # CSC slots land on dead or extension CSR positions (their local row
    # kills them). Inverse: CSR rows whose destination is a dead CSC slot
    # (c_local == DEAD kills them in the CSC-side scatter).
    cap = _P_MAX if p_cap is None else p_cap
    fwd = plan_corner_turn(dest, cap, care=live)
    inv_perm = np.empty(e_s2, dtype=np.int64)
    inv_perm[dest] = np.arange(e_s2)
    inv = plan_corner_turn(inv_perm, cap, care=live[inv_perm])
    return CscCsrPlans(fwd=fwd, inv=inv).to(graph.c_slot.device)


_CORNER_MODE = os.environ.get("PYGAT_CORNER", "auto")
# the reference's node count past which 'auto' plans: 2^62, because on its
# TPU the corner path never beat the row gather; the port keeps the switch
# so that both packages take the same path on the same graph. Whether the
# corner path pays on the H100 is measured by chip_smoke.py (PERF.md).
_CORNER_N = int(os.environ.get("PYGAT_CORNER_N", str(2 ** 62)))


def set_corner(mode: str) -> None:
    """'auto' (N_pad >= PYGAT_CORNER_N), 'on' or 'off': whether the fused
    attention layers build their sender windows by CSC expand and
    corner-turn."""
    global _CORNER_MODE
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown corner mode: {mode!r}")
    _CORNER_MODE = mode


def maybe_plan_corner(graph) -> CscCsrPlans | None:
    """CscCsrPlans when the fused layers should run over the corner plans,
    else None (the receiver stream)."""
    if graph.c_slot is None or _CORNER_MODE == "off":
        return None
    if _CORNER_MODE == "auto" and graph.num_nodes_padded < _CORNER_N:
        return None
    return plan_csc_to_csr(graph)


# ---------------------------------------------------------------------------
# Moves over the corner plans, and the corner SpMM
# ---------------------------------------------------------------------------


def gather_corner(x: torch.Tensor, graph, plan_fwd: CornerPlan) -> torch.Tensor:
    """``x[senders]`` [E_s, L] in receiver-stream order without a row gather
    by edge index: the CSC expand (one node tile per chunk) and the forward
    corner-turn passes. A contiguous view of the last pass's first E_s
    rows."""
    ex = expand(x, graph.c_local, graph.c_chunk)  # [E_s2, L], CSC order
    return apply_passes(ex, plan_fwd)[:graph.num_edges_padded]


def scatter_corner(g_e: torch.Tensor, graph, plan_inv: CornerPlan,
                   precision: str = "high") -> torch.Tensor:
    """Per-sender segment sum [N_pad, L] of receiver-stream-ordered ``g_e``
    [E_s, L]: padded to E_s2 rows, the inverse passes to CSC order (exact
    f32 moves), and the stream segment sum at ``precision`` over the CSC
    stream, whose dead slots drop the rows that land on them."""
    e_s2 = graph.c_local.shape[0]
    g_p = F.pad(g_e, (0, 0, 0, e_s2 - g_e.shape[0]))
    return stream_scatter(apply_passes(g_p, plan_inv), graph.c_local,
                          graph.c_chunk, graph.num_nodes_padded,
                          walk=graph.sender_walk, precision=precision)


def corner_spmm_backward(g, v, rows, graph, plan_inv: CornerPlan):
    """(d values, d x) of ``out = stream_scatter(v * rows)`` over the corner
    plans for the cotangent ``g`` [N_pad, L]: ``rows`` [E_s, L] are the
    sender rows in receiver-stream order, ``v`` the masked values. The
    cotangent per edge comes from one expand, the sender sum from
    :func:`scatter_corner`: no row gather by edge index."""
    g_e = expand(g.contiguous(), graph.r_local, graph.r_chunk)
    dvalues = torch.where(graph.edge_mask, (g_e * rows).sum(-1), 0.0)
    return dvalues, scatter_corner(v[:, None] * g_e, graph, plan_inv)


class _SpmmCorner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, x, graph, plans):
        turned = gather_corner(x.contiguous(), graph, plans.fwd)
        v = torch.where(graph.edge_mask, values, 0.0)
        out = stream_scatter(v[:, None] * turned, graph.r_local,
                             graph.r_chunk, graph.num_nodes_padded,
                             walk=graph.stream_walk)
        ctx.save_for_backward(v, turned)
        ctx.graph, ctx.plans = graph, plans
        return out

    @staticmethod
    def backward(ctx, g):
        v, turned = ctx.saved_tensors
        return corner_spmm_backward(g, v, turned, ctx.graph,
                                    ctx.plans.inv) + (None, None)


def spmm_corner_graph(values: torch.Tensor, x: torch.Tensor, graph,
                      plans: CscCsrPlans, *, mode: str | None = None,
                      precision: str = "high") -> torch.Tensor:
    """``out[N_pad, L]``: the receiver segment sum of ``values * x[senders]``
    (``values`` [E_s] f32 in the graph's edge order, zero where
    ``edge_mask`` is false) through the CSC expand, the forward corner-turn
    passes and the stream segment sum; the backward runs ``expand`` of the
    cotangent, the inverse passes and the CSC stream segment sum, with no
    row gather by edge index either way. The sender rows are kept for the
    backward, one [E_s, L] array, as the reference keeps them.

    ``mode`` (the reference's permute select, 'onehot' or 'take') has no
    counterpart: the kernel copies rows exactly either way. ``precision``
    is 'high', as the reference's default here; 'fastest' is not ported
    (ROADMAP Queue 1, item 9)."""
    require_high("spmm_corner_graph", precision)
    if mode not in (None, "onehot", "take"):
        raise ValueError(f"spmm_corner_graph: unknown mode {mode!r}")
    return _SpmmCorner.apply(values, x, graph, plans)
