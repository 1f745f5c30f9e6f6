"""Fused sparse GAT attention over the corner plans, with no row gather by
edge index (port of ``pygat_tpu/ops/fused_corner.py``).

The receiver-stream ops (:mod:`.fused_stream`) gather sender rows by edge
index: the fused kernels read ``wh[senders[k]]`` and the backward gathers
``wh[senders]`` and ``g_out[receivers]`` in PyTorch. Over the corner plans
(:func:`~pygat_tpu_torch.ops.large.plan_csc_to_csr`) every such move is a
kernel over a static layout:

* sender windows: :func:`~pygat_tpu_torch.ops.large.expand` over the CSC
  (sender-sorted) stream, whose chunks each read one 128-row tile of the
  node table, then the forward corner-turn passes
  (:func:`~pygat_tpu_torch.ops.corner.apply_passes`) from CSC to
  receiver-stream order (:func:`~pygat_tpu_torch.ops.large.gather_corner`);
* the fused forward over that pre-built window: :func:`fused_v1_window`
  and :func:`fused_v2_window`, which launch ``csrc/fused_v1_window.cu`` and
  ``csrc/fused_v2_window.cu`` (rows 2 and 3's kernels of
  ``pygat_tpu/ops/fused_stream.py``, ``_make_v1_kernel`` and
  ``_make_v2_kernel``, on the tile-owner body ``csrc/tile_fused.cuh``
  walking the receiver stream by the graph's walk and reading slot k's
  sender row from row k of the window) on a CUDA tensor, and their plain
  versions on a CPU tensor;
* in the backward, the receiver-side operands by one expand over the
  receiver stream, and the sender-side reductions by the inverse passes
  back to CSC order and the stream segment sum
  (:func:`~pygat_tpu_torch.ops.large.scatter_corner`).

The backward recomputes the window, as the reference's does, and is the
math of its ``_v1_bwd_body`` / ``_v2_bwd_body``.
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.fused_stream import (
    _block_diag_a,
    _check_args,
    _expand_bd,
    launch_tile_fused,
    leaky_relu,
    stream_walk_arg,
    v1_plain_core,
    v2_plain_core,
)
from pygat_tpu_torch.ops.large import (
    CscCsrPlans,
    expand,
    gather_corner,
    scatter_corner,
)
from pygat_tpu_torch.ops.stream import TILE, StreamWalk, stream_scatter


# ---------------------------------------------------------------------------
# The fused forward over a pre-built window: kernels and plain versions
# ---------------------------------------------------------------------------


def _check_window(what: str, win: torch.Tensor, cols: int, r_local) -> None:
    e = r_local.shape[0]
    if win.dim() != 2 or win.dtype != torch.float32 or tuple(win.shape) != (e, cols):
        raise ValueError(f"{what}: the window must be [{e}, {cols}] float32, "
                         f"got {win.dtype} {tuple(win.shape)}")


def fused_v1_window_plain(win, f_dst, bound, a_src, keepq, r_local, r_chunk,
                          alpha: float, *, f64: bool = False):
    """Plain PyTorch version of :func:`fused_v1_window` (``f64`` as
    :func:`~pygat_tpu_torch.ops.fused_stream.v1_plain_core`)."""
    _check_args("fused_v1_window", (), (f_dst, bound), a_src, keepq, None,
                r_local, r_chunk)
    _check_window("fused_v1_window", win, a_src.numel(), r_local)
    return v1_plain_core(win, f_dst, bound, a_src, keepq, r_local, r_chunk,
                         alpha, f64)


@build.counted
def fused_v1_window(win, f_dst, bound, a_src, keepq, r_local, r_chunk,
                    alpha: float, *, walk: StreamWalk | None = None):
    """(out [N, HF], den [N, H]) of the fused GATv1 forward over the
    receiver stream, slot k's sender row being row k of ``win`` [E_s, HF]
    (:func:`gather_corner` of wh). Other arguments as
    :func:`~pygat_tpu_torch.ops.fused_stream.fused_v1`. On a CUDA tensor
    this launches ``csrc/fused_v1_window.cu`` (counted in
    ``fused_v1_window.launches``), whose result is the same bit for bit
    from call to call, and raises without a walk; on a CPU tensor it runs
    :func:`fused_v1_window_plain`."""
    if win.device.type == "cpu":
        return fused_v1_window_plain(win, f_dst, bound, a_src, keepq, r_local,
                                     r_chunk, alpha)
    if win.device.type != "cuda":
        raise ValueError(f"fused_v1_window: unsupported device {win.device}")
    _check_args("fused_v1_window", (), (f_dst, bound), a_src, keepq, None,
                r_local, r_chunk)
    _check_window("fused_v1_window", win, a_src.numel(), r_local)
    n_pad = f_dst.shape[0]
    walk = stream_walk_arg("fused_v1_window", walk, n_pad, r_chunk)
    return launch_tile_fused(fused_v1_window, (win, f_dst, bound, a_src,
                                               keepq), a_src, n_pad, *walk,
                             alpha)


def fused_v2_window_plain(whi, win, ub, a, keepq, r_local, r_chunk,
                          alpha: float, *, f64: bool = False):
    """Plain PyTorch version of :func:`fused_v2_window` (``f64`` as
    :func:`~pygat_tpu_torch.ops.fused_stream.v1_plain_core`)."""
    _check_args("fused_v2_window", (whi,), (ub,), a, keepq, None, r_local,
                r_chunk)
    hf = a.numel()
    _check_window("fused_v2_window", win, 2 * hf, r_local)
    return v2_plain_core(win[:, :hf], win[:, hf:], whi, ub, a, keepq, r_local,
                         r_chunk, alpha, f64)


@build.counted
def fused_v2_window(whi, win, ub, a, keepq, r_local, r_chunk, alpha: float,
                    *, walk: StreamWalk | None = None):
    """(out [N, HF], den [N, H]) of the fused GATv2 forward over the
    receiver stream, slot k's sender rows being row k of ``win`` [E_s, 2HF]:
    ``whj`` of the sender in columns [0, HF), ``whi`` in [HF, 2HF)
    (:func:`gather_corner` of ``[whj | whi]``). Other arguments as
    :func:`~pygat_tpu_torch.ops.fused_stream.fused_v2`. On a CUDA tensor
    this launches ``csrc/fused_v2_window.cu`` (counted in
    ``fused_v2_window.launches``), whose result is the same bit for bit
    from call to call, and raises without a walk; on a CPU tensor it runs
    :func:`fused_v2_window_plain`."""
    if win.device.type == "cpu":
        return fused_v2_window_plain(whi, win, ub, a, keepq, r_local, r_chunk,
                                     alpha)
    if win.device.type != "cuda":
        raise ValueError(f"fused_v2_window: unsupported device {win.device}")
    _check_args("fused_v2_window", (whi,), (ub,), a, keepq, None, r_local,
                r_chunk)
    _check_window("fused_v2_window", win, 2 * a.numel(), r_local)
    n_pad = whi.shape[0]
    walk = stream_walk_arg("fused_v2_window", walk, n_pad, r_chunk)
    return launch_tile_fused(fused_v2_window, (whi, win, ub, a, keepq), a,
                             n_pad, *walk, alpha)


# ---------------------------------------------------------------------------
# Differentiable fused attention over the corner plans
# ---------------------------------------------------------------------------


class _FusedV1AttentionCorner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wh, f_dst, bound, a_src, keepq, graph, plans, alpha):
        wh, f_dst, bound, a_src, keepq = (
            t.contiguous() for t in (wh, f_dst, bound, a_src, keepq))
        win = gather_corner(wh, graph, plans.fwd)
        out, den = fused_v1_window(win, f_dst, bound, a_src, keepq,
                                   graph.r_local, graph.r_chunk, alpha,
                                   walk=graph.stream_walk)
        ctx.save_for_backward(wh, f_dst, bound, a_src, keepq)
        ctx.graph, ctx.plans, ctx.alpha = graph, plans, alpha
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        wh, f_dst, bound, a_src, keepq = ctx.saved_tensors
        graph, plans, alpha = ctx.graph, ctx.plans, ctx.alpha
        h, f = a_src.shape
        hf = h * f

        # recompute the per-slot pipeline in receiver-stream order,
        # lane-minor: the sender rows by expand + corner-turn, the four
        # receiver-side operands by one expand
        g_w = gather_corner(wh, graph, plans.fwd)  # [E_s, HF]
        abd = _block_diag_a(a_src)  # [HF, H]
        exp_bd = _expand_bd(h, f, device=wh.device)  # [H, HF]
        eall = expand(torch.cat([f_dst, bound, g_out, g_den], dim=1),
                      graph.r_local, graph.r_chunk)  # [E_s, 3H + HF]
        fde, bnd, dmsg, dden = eall.split([h, h, hf, h], dim=1)
        raw = fde + g_w @ abd
        live = (graph.r_local < TILE)[:, None]
        num = torch.where(live, torch.exp(leaky_relu(raw, alpha) - bnd), 0.0)
        qnum = num * keepq

        dqnum = (dmsg * g_w) @ exp_bd.T  # per-head sums over F
        draw = (dqnum * keepq + dden) * num * torch.where(raw >= 0, 1.0, alpha)
        df_dst = stream_scatter(draw, graph.r_local, graph.r_chunk,
                                graph.num_nodes_padded)
        dgathered = dmsg * (qnum @ exp_bd) + draw @ abd.T  # [E_s, HF]
        dwh = scatter_corner(dgathered, graph, plans.inv)
        da = (g_w * (draw @ exp_bd)).sum(0).reshape(h, f)
        return dwh, df_dst, None, da, None, None, None, None


def fused_v1_attention_corner(wh, f_dst, bound, a_src, keepq, graph,
                              plans: CscCsrPlans, alpha: float):
    """Differentiable fused GATv1 attention over the corner plans of
    ``graph``: (out [N, HF], den [N, H]), the function of
    :func:`~pygat_tpu_torch.ops.fused_stream.fused_v1_attention` with no
    row gather by edge index, forward or backward. ``keepq`` is [E_s, H]
    over the receiver stream's slots; ``bound`` must be detached. Gradients
    flow to ``wh``, ``f_dst`` and ``a_src``."""
    return _FusedV1AttentionCorner.apply(wh, f_dst, bound, a_src, keepq, graph,
                                         plans, alpha)


class _FusedV2AttentionCorner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, whi, whj, ub, a, keepq, graph, plans, alpha):
        whi, whj, ub, a, keepq = (
            t.contiguous() for t in (whi, whj, ub, a, keepq))
        # one expand and one turn for both sender windows (2HF columns)
        win = gather_corner(torch.cat([whj, whi], dim=1), graph, plans.fwd)
        out, den = fused_v2_window(whi, win, ub, a, keepq, graph.r_local,
                                   graph.r_chunk, alpha,
                                   walk=graph.stream_walk)
        ctx.save_for_backward(whi, whj, ub, a, keepq)
        ctx.graph, ctx.plans, ctx.alpha = graph, plans, alpha
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        whi, whj, ub, a, keepq = ctx.saved_tensors
        graph, plans, alpha = ctx.graph, ctx.plans, ctx.alpha
        h, f = a.shape
        hf = h * f

        gj, gi = gather_corner(torch.cat([whj, whi], dim=1), graph,
                               plans.fwd).split(hf, 1)
        eall = expand(torch.cat([whi, ub, g_out, g_den], dim=1),
                      graph.r_local, graph.r_chunk)  # [E_s, 2HF + 2H]
        wi_e, ub_e, dmsg, dden = eall.split([hf, h, hf, h], dim=1)
        raw = wi_e + gj
        pre = leaky_relu(raw, alpha)
        abd = _block_diag_a(a)  # [HF, H]
        exp_bd = _expand_bd(h, f, device=whi.device)  # [H, HF]
        live = (graph.r_local < TILE)[:, None]
        num = torch.where(live, torch.exp(pre @ abd - ub_e), 0.0)
        qnum = num * keepq

        dqnum = (dmsg * gi) @ exp_bd.T  # per-head sums over F
        dlogits = (dqnum * keepq + dden) * num  # [E_s, H]
        dpre = (dlogits @ abd.T) * torch.where(raw >= 0, 1.0, alpha)

        # receiver side: dwhi from the logit path; sender side: one inverse
        # turn and sum for dwhj (logit path) and the message half of dwhi
        dwhi_e = stream_scatter(dpre, graph.r_local, graph.r_chunk,
                                graph.num_nodes_padded)
        red = scatter_corner(torch.cat([dpre, dmsg * (qnum @ exp_bd)], 1),
                             graph, plans.inv)
        da = (pre * (dlogits @ exp_bd)).sum(0).reshape(h, f)
        return (dwhi_e + red[:, hf:], red[:, :hf], None, da, None, None, None,
                None)


def fused_v2_attention_corner(whi, whj, ub, a, keepq, graph,
                              plans: CscCsrPlans, alpha: float):
    """Differentiable fused GATv2 attention over the corner plans of
    ``graph``: (out [N, HF], den [N, H]), the function of
    :func:`~pygat_tpu_torch.ops.fused_stream.fused_v2_attention` with no
    row gather by edge index, forward or backward. ``keepq`` is [E_s, H];
    ``ub`` must be detached. Gradients flow to ``whi``, ``whj`` and ``a``."""
    return _FusedV2AttentionCorner.apply(whi, whj, ub, a, keepq, graph, plans,
                                         alpha)
