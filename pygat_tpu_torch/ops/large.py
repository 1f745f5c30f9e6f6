"""Expand and the CSC-to-CSR corner plans (port of the expand kernel and
the corner half of ``pygat_tpu/ops/large.py``).

:func:`expand` gives slot ``k`` the row ``x[chunk_tile[k // EC] * 128 +
local[k]]`` and zeros at dead slots (``local == 128``), bit-exact. On a CUDA
tensor it launches the hand-written kernel ``csrc/expand.cu``, which
replaces the TPU kernel ``pygat_tpu/ops/large.py::_make_expand_kernel``; on
a CPU tensor it runs :func:`expand_plain`, the plain PyTorch version that is
also the kernel's oracle. The banded backward (:mod:`.banded`) reads its
receiver-side operands this way, and the corner path (:mod:`.fused_corner`)
its sender rows in CSC order as well.

:func:`plan_csc_to_csr` builds the corner plans of a graph: the permutation
from its CSC stream slots to its receiver-stream (CSR) slots and back.
:func:`set_corner` / :func:`maybe_plan_corner` select them with the JAX
package's knobs ``PYGAT_CORNER`` (auto/on/off) and ``PYGAT_CORNER_N``, read
at import; 'auto' keeps the reference's threshold of 2^62 padded nodes, so
only 'on' plans. The panel path's use of expand and the corner SpMM
(``spmm_corner_graph``) are not ported.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.corner import _P_MAX, CornerPlan, plan_corner_turn
from pygat_tpu_torch.ops.stream import DEAD, EC, TILE


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
    :func:`expand_plain`. Not differentiable."""
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
