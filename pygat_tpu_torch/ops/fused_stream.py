"""Fused sparse GAT attention (port of ``pygat_tpu/ops/fused_stream.py``).

:func:`fused_v1` (GATv1) and :func:`fused_v2` (GATv2) compute, per live
stream slot, the logit, the bound-shifted exp, the attention keep factor
and the message, and scatter the aggregated numerator ``out [N, HF]`` and
the pre-dropout denominator ``den [N, H]``. On a CUDA tensor they launch the
hand-written kernels ``csrc/fused_v1.cu`` and ``csrc/fused_v2.cu``, which
replace the TPU kernels ``pygat_tpu/ops/fused_stream.py::_make_v1_kernel``
and ``_make_v2_kernel``: tile-owner kernels (``csrc/tile_fused.cuh``, which
notes what bounds them and how they are laid out) that walk the stream by
the graph's walk (:attr:`~pygat_tpu_torch.graph.Graph.stream_walk`, built
with the graph; a CUDA call without it raises); on a CPU tensor they run
:func:`fused_v1_plain` and :func:`fused_v2_plain`, the plain PyTorch
versions that are also the kernels' oracles.

:func:`fused_v1_attention` and :func:`fused_v2_attention` are the
differentiable ops, the counterparts of the reference's custom VJPs: the
forward is the kernel, and the backward is the math of ``_v1_bwd`` /
``_v2_bwd`` in PyTorch, recomputing the per-edge pipeline lane-minor and
reducing through the stream segment sums (once per receiver, once per
sender). The reference's ``combined``/``split`` sender-window switch has no
counterpart: it exists because Mosaic cannot gather rows, and the CUDA
kernel gathers ``whj[s]`` and ``whi[s]`` itself.
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.stream import (
    EC,
    TILE,
    StreamWalk,
    stream_segment_sum,
    stream_sender_segment_sum,
)

MAX_F = 256  # widest head of the fused kernels (tile_fused.cuh)


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _expand_bd(h: int, f: int, dtype=torch.float32, device=None):
    """[H, H*F] head->lane one-hot: x[:, h] lands on lanes h*F..h*F+F-1."""
    return torch.eye(h, dtype=dtype, device=device).repeat_interleave(f, dim=1)


def _block_diag_a(a: torch.Tensor) -> torch.Tensor:
    """[H, F] attention vectors -> block-diagonal [H*F, H] projector."""
    h, f = a.shape
    eye = torch.eye(h, dtype=a.dtype, device=a.device)
    return torch.einsum("hf,hk->hfk", a, eye).reshape(h * f, h)


def _check_args(what, wide, narrow, a, keepq, senders, r_local, r_chunk):
    """Shapes and types of a fused forward: ``wide`` tensors are [N, HF]
    (none over a sender window), ``narrow`` ones [N, H], ``a`` is [H, F],
    the rest cover the stream (``senders`` None over a sender window)."""
    first = (*wide, *narrow)[0]
    n_pad = first.shape[0]
    h, f = a.shape
    hf = h * f
    e = r_local.shape[0]
    if n_pad % TILE or (wide and wide[0].shape[1] != hf):
        raise ValueError(f"{what}: node table {tuple(first.shape)} does not "
                         f"match a {tuple(a.shape)} on 128-row tiles")
    if any(t.shape != (n_pad, hf) for t in wide):
        raise ValueError(f"{what}: the node tables must be [N, HF]")
    if any(t.shape != (n_pad, h) for t in narrow):
        raise ValueError(f"{what}: the per-node head terms must be [N, H]")
    if (keepq.shape != (e, h) or r_local.dim() != 1
            or e != r_chunk.shape[0] * EC
            or (senders is not None and senders.shape != (e,))):
        raise ValueError("keepq, senders and r_local must cover the stream")
    for t in (*wide, *narrow, a, keepq):
        if t.dtype != torch.float32:
            raise ValueError(f"{what} takes float32, got {t.dtype}")
    for t in (senders, r_local, r_chunk):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{what} takes int32 indices, got {t.dtype}")


def stream_walk_arg(what: str, walk: StreamWalk | None, n_pad: int,
                    r_chunk) -> StreamWalk:
    """``walk``, checked to be a receiver stream's walk over ``n_pad``
    nodes on ``r_chunk``'s device; raises without one (a CUDA call needs
    the graph's :attr:`~pygat_tpu_torch.graph.Graph.stream_walk`)."""
    if walk is None:
        raise ValueError(f"{what}: a CUDA call needs the receiver stream's "
                         "walk (walk=graph.stream_walk, built with the graph)")
    n_tiles = n_pad // TILE
    if (walk.row_ptr.shape != (n_tiles * (TILE + 1) + 1,)
            or walk.tile_ptr.shape != (n_tiles + 1,)
            or walk.row_ptr.device != r_chunk.device):
        raise ValueError(f"{what}: the walk does not match the stream's "
                         f"{n_tiles} tiles on {r_chunk.device}")
    return walk


def launch_tile_fused(wrapper, tensors, a, n_pad: int, row_ptr, tile_ptr,
                      split_at, max_run: int, alpha: float):
    """Launch ``wrapper``'s tile-owner kernel (``csrc/tile_fused.cuh``) on
    the current stream and count the launch. ``tensors`` are the kernel's
    array arguments before ``row_ptr`` (the tables, the per-node head terms,
    ``a``, ``keepq`` and the walk's words by position, if any); ``row_ptr``,
    ``tile_ptr``, ``split_at`` and ``max_run`` are the walk's (a
    :class:`StreamWalk` unpacked, or a band plan's). Returns the new (out
    [N, HF], den [N, H])."""
    h, f = a.shape
    if f > MAX_F:
        raise ValueError(f"{wrapper.kernel}: head width {f} exceeds {MAX_F}")
    dev, n_split = a.device, split_at.shape[0]
    out = torch.empty(n_pad, h * f, dtype=torch.float32, device=dev)
    den = torch.empty(n_pad, h, dtype=torch.float32, device=dev)
    part_out = part_den = None
    if n_split:
        part_out = torch.empty(n_split, TILE, h * f, dtype=torch.float32,
                               device=dev)
        part_den = torch.empty(n_split, TILE, h, dtype=torch.float32,
                               device=dev)
    build.launch(wrapper, *tensors, row_ptr, tile_ptr, split_at,
                 n_pad // TILE, n_split, max_run, h, f, float(alpha), out,
                 den, part_out, part_den)
    return out, den


def stream_receivers(r_local: torch.Tensor,
                     r_chunk: torch.Tensor) -> torch.Tensor:
    """[E] int64 receiver of every slot of a receiver stream, as the kernel
    works it out: tile ``r_chunk[k // EC]``, row ``r_local[k]``; a dead slot
    (``r_local == TILE``) takes its tile's last row, as the graph's padding
    edges do."""
    tile = r_chunk.long().repeat_interleave(EC)
    return tile * TILE + r_local.long().clamp(max=TILE - 1)


def v1_plain_core(g_w, f_dst, bound, a_src, keepq, r_local, r_chunk,
                  alpha: float, f64: bool = False):
    """The fused GATv1 forward in plain PyTorch from the sender rows
    ``g_w`` [E, HF] of every slot (gathers + ``index_add_``). ``f64=True`` evaluates in float64 and returns float32: the kernels'
    oracle where a row sums thousands of terms, whose float32 sum by
    ``index_add_`` (atomics on the card, in an order that changes from call
    to call) is itself off by up to about 1e-5 of the row."""
    if f64:
        return tuple(t.float() for t in v1_plain_core(
            *(t.double() for t in (g_w, f_dst, bound, a_src, keepq)),
            r_local, r_chunk, alpha))
    n_pad, h = f_dst.shape
    f = a_src.shape[1]
    e = g_w.shape[0]
    rcv = stream_receivers(r_local, r_chunk)
    g = g_w.reshape(e, h, f)
    raw = f_dst[rcv] + (g * a_src).sum(-1)
    live = (r_local < TILE)[:, None]
    num = torch.where(live, torch.exp(leaky_relu(raw, alpha) - bound[rcv]), 0.0)
    msgs = (g * (num * keepq)[:, :, None]).view(e, h * f)
    out = torch.zeros(n_pad, h * f, dtype=g_w.dtype, device=g_w.device)
    den = torch.zeros(n_pad, h, dtype=g_w.dtype, device=g_w.device)
    return out.index_add_(0, rcv, msgs), den.index_add_(0, rcv, num)


def fused_v1_plain(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk,
                   alpha: float, *, f64: bool = False):
    """Plain PyTorch version of :func:`fused_v1` (gathers + ``index_add_``;
    ``f64`` as :func:`v1_plain_core`)."""
    _check_args("fused_v1", (wh,), (f_dst, bound), a_src, keepq, senders,
                r_local, r_chunk)
    return v1_plain_core(wh[senders.long()], f_dst, bound, a_src, keepq,
                         r_local, r_chunk, alpha, f64)


@build.counted
def fused_v1(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk,
             alpha: float, *, walk: StreamWalk | None = None):
    """(out [N, HF], den [N, H]) of the fused GATv1 forward.

    wh [N, HF], f_dst/bound [N, H], a_src [H, F], keepq [E, H] (keep/(1-p)
    factors, ones when not training); senders/r_local [E] and r_chunk
    [E / EC] int32 in receiver stream order, which give every slot its
    receiver (:func:`stream_receivers`); ``walk`` the stream's walk
    (``graph.stream_walk``). On a CUDA tensor this launches
    ``csrc/fused_v1.cu`` (counted in ``fused_v1.launches``), whose result
    is the same bit for bit from call to call, and raises without a walk;
    on a CPU tensor it runs :func:`fused_v1_plain`.
    """
    if wh.device.type == "cpu":
        return fused_v1_plain(wh, f_dst, bound, a_src, keepq, senders,
                              r_local, r_chunk, alpha)
    if wh.device.type != "cuda":
        raise ValueError(f"fused_v1: unsupported device {wh.device}")
    _check_args("fused_v1", (wh,), (f_dst, bound), a_src, keepq, senders,
                r_local, r_chunk)
    n_pad = wh.shape[0]
    walk = stream_walk_arg("fused_v1", walk, n_pad, r_chunk)
    return launch_tile_fused(fused_v1, (wh, f_dst, bound, a_src, keepq,
                                        senders), a_src, n_pad, *walk, alpha)


class _FusedV1Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wh, f_dst, bound, a_src, keepq, senders, receivers,
                r_local, r_chunk, c_slot, c_local, c_chunk, alpha, walk):
        wh, f_dst, bound, a_src, keepq = (
            t.contiguous() for t in (wh, f_dst, bound, a_src, keepq))
        out, den = fused_v1(wh, f_dst, bound, a_src, keepq, senders,
                            r_local, r_chunk, alpha, walk=walk)
        ctx.save_for_backward(wh, f_dst, bound, a_src, keepq, senders,
                              receivers, r_local, r_chunk, c_slot, c_local,
                              c_chunk)
        ctx.alpha = alpha
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        (wh, f_dst, bound, a_src, keepq, senders, receivers, r_local, r_chunk,
         c_slot, c_local, c_chunk) = ctx.saved_tensors
        alpha = ctx.alpha
        n_pad = wh.shape[0]
        h, f = a_src.shape
        snd, rcv = senders.long(), receivers.long()

        # recompute the per-edge pipeline, lane-minor ([E, H] / [E, HF])
        g_w = wh[snd]  # [E, HF]
        abd = _block_diag_a(a_src)  # [HF, H]
        exp_bd = _expand_bd(h, f, device=wh.device)  # [H, HF]
        raw = f_dst[rcv] + g_w @ abd
        live = (r_local < TILE)[:, None]  # dead stream slots contribute nothing
        num = torch.where(live, torch.exp(leaky_relu(raw, alpha) - bound[rcv]),
                          0.0)
        qnum = num * keepq

        dmsg = g_out[rcv]  # [E, HF]
        dden = g_den[rcv]  # [E, H]
        dqnum = (dmsg * g_w) @ exp_bd.T  # per-head sums over F
        dnum = dqnum * keepq + dden
        draw = dnum * num * torch.where(raw >= 0, 1.0, alpha)  # [E, H]

        # df_dst: per-receiver reduction (data already in stream order)
        df_dst = stream_segment_sum(draw, receivers, r_local, r_chunk, n_pad)
        # dwh: one per-sender reduction of the message and logit cotangents
        dgathered = dmsg * (qnum @ exp_bd) + draw @ abd.T  # [E, HF]
        dwh = stream_sender_segment_sum(dgathered, senders, c_slot, c_local,
                                        c_chunk, n_pad)
        da = (g_w * (draw @ exp_bd)).sum(0).reshape(h, f)
        return (dwh, df_dst, None, da) + (None,) * 10


def fused_v1_attention(wh, f_dst, bound, a_src, keepq, senders, receivers,
                       r_local, r_chunk, c_slot, c_local, c_chunk,
                       alpha: float, walk: StreamWalk | None = None):
    """Differentiable fused GATv1 attention: (out [N, HF], den [N, H]).

    ``bound`` must already be detached (its true gradient is zero: the
    softmax is invariant to a per-receiver shift). Gradients flow to ``wh``,
    ``f_dst`` and ``a_src``. ``walk`` (``graph.stream_walk``) is the
    forward kernel's, needed on CUDA tensors.
    """
    return _FusedV1Attention.apply(wh, f_dst, bound, a_src, keepq, senders,
                                   receivers, r_local, r_chunk, c_slot,
                                   c_local, c_chunk, alpha, walk)


# ---------------------------------------------------------------------------
# v2 (GATv2: LeakyReLU before the a-projection; aggregates the LEFT
# projection gathered at senders, reference layers.py:278-296)
# ---------------------------------------------------------------------------


def v2_plain_core(gj, gi, whi, ub, a, keepq, r_local, r_chunk,
                  alpha: float, f64: bool = False):
    """The fused GATv2 forward in plain PyTorch from the sender rows of
    every slot, ``gj`` of whj and ``gi`` of whi, [E, HF] each (gathers +
    ``index_add_``). ``f64`` as :func:`v1_plain_core`."""
    if f64:
        return tuple(t.float() for t in v2_plain_core(
            *(t.double() for t in (gj, gi, whi, ub, a, keepq)), r_local,
            r_chunk, alpha))
    n_pad, hf = whi.shape
    h, f = a.shape
    e = gj.shape[0]
    rcv = stream_receivers(r_local, r_chunk)
    pre = leaky_relu(whi[rcv] + gj, alpha).view(e, h, f)
    logits = (pre * a).sum(-1)
    live = (r_local < TILE)[:, None]
    num = torch.where(live, torch.exp(logits - ub[rcv]), 0.0)
    msgs = (gi.reshape(e, h, f) * (num * keepq)[:, :, None]).view(e, hf)
    out = torch.zeros(n_pad, hf, dtype=whi.dtype, device=whi.device)
    den = torch.zeros(n_pad, h, dtype=whi.dtype, device=whi.device)
    return out.index_add_(0, rcv, msgs), den.index_add_(0, rcv, num)


def fused_v2_plain(whi, whj, ub, a, keepq, senders, r_local, r_chunk,
                   alpha: float, *, f64: bool = False):
    """Plain PyTorch version of :func:`fused_v2` (gathers + ``index_add_``;
    ``f64`` as :func:`v1_plain_core`)."""
    _check_args("fused_v2", (whi, whj), (ub,), a, keepq, senders, r_local,
                r_chunk)
    snd = senders.long()
    return v2_plain_core(whj[snd], whi[snd], whi, ub, a, keepq, r_local,
                         r_chunk, alpha, f64)


@build.counted
def fused_v2(whi, whj, ub, a, keepq, senders, r_local, r_chunk, alpha: float,
             *, walk: StreamWalk | None = None):
    """(out [N, HF], den [N, H]) of the fused GATv2 forward.

    whi/whj [N, HF] (left and right projections), ub [N, H] (an upper bound
    of every logit of the row), a [H, F], keepq [E, H] (keep/(1-p) factors,
    ones when not training); senders/r_local [E] and r_chunk [E / EC] int32
    in receiver stream order; ``walk`` the stream's walk
    (``graph.stream_walk``). On a CUDA tensor this launches
    ``csrc/fused_v2.cu`` (counted in ``fused_v2.launches``), whose result
    is the same bit for bit from call to call, and raises without a walk;
    on a CPU tensor it runs :func:`fused_v2_plain`.
    """
    if whi.device.type == "cpu":
        return fused_v2_plain(whi, whj, ub, a, keepq, senders, r_local,
                              r_chunk, alpha)
    if whi.device.type != "cuda":
        raise ValueError(f"fused_v2: unsupported device {whi.device}")
    _check_args("fused_v2", (whi, whj), (ub,), a, keepq, senders, r_local,
                r_chunk)
    n_pad = whi.shape[0]
    walk = stream_walk_arg("fused_v2", walk, n_pad, r_chunk)
    return launch_tile_fused(fused_v2, (whi, whj, ub, a, keepq, senders), a,
                             n_pad, *walk, alpha)


class _FusedV2Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, whi, whj, ub, a, keepq, senders, receivers, r_local,
                r_chunk, c_slot, c_local, c_chunk, alpha, walk):
        whi, whj, ub, a, keepq = (
            t.contiguous() for t in (whi, whj, ub, a, keepq))
        out, den = fused_v2(whi, whj, ub, a, keepq, senders, r_local, r_chunk,
                            alpha, walk=walk)
        ctx.save_for_backward(whi, whj, ub, a, keepq, senders, receivers,
                              r_local, r_chunk, c_slot, c_local, c_chunk)
        ctx.alpha = alpha
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        (whi, whj, ub, a, keepq, senders, receivers, r_local, r_chunk,
         c_slot, c_local, c_chunk) = ctx.saved_tensors
        alpha = ctx.alpha
        n_pad, hf = whi.shape
        h, f = a.shape
        snd, rcv = senders.long(), receivers.long()

        # recompute the per-edge pipeline, lane-minor ([E, H] / [E, HF])
        gi = whi[snd]  # the message operand
        raw = whi[rcv] + whj[snd]  # [E, HF]
        pre = leaky_relu(raw, alpha)
        abd = _block_diag_a(a)  # [HF, H]
        exp_bd = _expand_bd(h, f, device=whi.device)  # [H, HF]
        live = (r_local < TILE)[:, None]  # dead stream slots contribute nothing
        num = torch.where(live, torch.exp(pre @ abd - ub[rcv]), 0.0)
        qnum = num * keepq

        dmsg = g_out[rcv]  # [E, HF]
        dden = g_den[rcv]  # [E, H]
        dqnum = (dmsg * gi) @ exp_bd.T  # per-head sums over F
        dlogits = (dqnum * keepq + dden) * num  # [E, H]
        dpre = (dlogits @ abd.T) * torch.where(raw >= 0, 1.0, alpha)  # [E, HF]

        # receiver side: dwhi from the logit path
        dwhi_e = stream_segment_sum(dpre, receivers, r_local, r_chunk, n_pad)
        # sender side: one reduction for dwhj (logit path) and the message
        # half of dwhi
        both = torch.cat([dpre, dmsg * (qnum @ exp_bd)], dim=1)  # [E, 2HF]
        red = stream_sender_segment_sum(both, senders, c_slot, c_local,
                                        c_chunk, n_pad)
        da = (pre * (dlogits @ exp_bd)).sum(0).reshape(h, f)
        return (dwhi_e + red[:, hf:], red[:, :hf], None, da) + (None,) * 10


def fused_v2_attention(whi, whj, ub, a, keepq, senders, receivers, r_local,
                       r_chunk, c_slot, c_local, c_chunk, alpha: float,
                       walk: StreamWalk | None = None):
    """Differentiable fused GATv2 attention: (out [N, HF], den [N, H]).

    ``ub`` must already be detached (its true gradient is zero: the softmax
    is invariant to a per-receiver shift). Gradients flow to ``whi``,
    ``whj`` and ``a``. ``walk`` (``graph.stream_walk``) is the forward
    kernel's, needed on CUDA tensors.
    """
    return _FusedV2Attention.apply(whi, whj, ub, a, keepq, senders, receivers,
                                   r_local, r_chunk, c_slot, c_local, c_chunk,
                                   alpha, walk)
