"""Fused sparse GAT attention (port of ``pygat_tpu/ops/fused_stream.py``).

:func:`fused_v1` (GATv1) and :func:`fused_v2` (GATv2) compute, per live
stream slot, the logit, the bound-shifted exp, the attention keep factor
and the message, and scatter the aggregated numerator ``out [N, HF]`` and
the pre-dropout denominator ``den [N, H]``. On a CUDA tensor they launch the
hand-written kernels ``csrc/fused_v1.cu`` and ``csrc/fused_v2.cu``, which
replace the TPU kernels ``pygat_tpu/ops/fused_stream.py::_make_v1_kernel``
and ``_make_v2_kernel`` (each source notes what bounds it and how it is
laid out); on a CPU tensor they run :func:`fused_v1_plain` and
:func:`fused_v2_plain`, the plain PyTorch versions that are also the
kernels' oracles.

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
    stream_segment_sum,
    stream_sender_segment_sum,
)

MAX_F = 256  # widest head the kernels take (csrc/fused_v1.cu, fused_v2.cu)


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
    """Shapes and types of a fused forward: ``wide`` tensors are [N, HF],
    ``narrow`` ones [N, H], ``a`` is [H, F], the rest cover the stream."""
    n_pad, hf = wide[0].shape
    h, f = a.shape
    e = senders.shape[0]
    if n_pad % TILE or h * f != hf:
        raise ValueError(f"{what}: node table {tuple(wide[0].shape)} does not "
                         f"match a {tuple(a.shape)} on 128-row tiles")
    if any(t.shape != (n_pad, hf) for t in wide):
        raise ValueError(f"{what}: the node tables must be [N, HF]")
    if any(t.shape != (n_pad, h) for t in narrow):
        raise ValueError(f"{what}: the per-node head terms must be [N, H]")
    if keepq.shape != (e, h) or r_local.shape != (e,) or e != r_chunk.shape[0] * EC:
        raise ValueError("keepq, senders and r_local must cover the stream")
    for t in (*wide, *narrow, a, keepq):
        if t.dtype != torch.float32:
            raise ValueError(f"{what} takes float32, got {t.dtype}")
    for t in (senders, r_local, r_chunk):
        if t.dtype != torch.int32:
            raise ValueError(f"{what} takes int32 indices, got {t.dtype}")


def _launch(wrapper, tensors, a, alpha: float, window=()):
    """Launch the kernel ``csrc/<wrapper.__name__>.cu`` on the current
    stream and count the launch on ``wrapper``. ``tensors`` are the kernel's
    array arguments in its order (the first is an [N, HF] table, the last
    is ``r_chunk``), ``window`` the band plan's window width for the banded
    kernels; returns the new (out [N, HF], den [N, H])."""
    h, f = a.shape
    if f > MAX_F:
        raise ValueError(f"{wrapper.__name__}: head width {f} exceeds {MAX_F}")
    first, r_chunk = tensors[0], tensors[-1]
    n_pad, hf = first.shape
    out = torch.empty(n_pad, hf, dtype=torch.float32, device=first.device)
    den = torch.empty(n_pad, h, dtype=torch.float32, device=first.device)
    build.launch(wrapper, *tensors, r_chunk.shape[0], n_pad // TILE, *window,
                 h, f, float(alpha), out, den)
    return out, den


def stream_receivers(r_local: torch.Tensor,
                     r_chunk: torch.Tensor) -> torch.Tensor:
    """[E] int64 receiver of every slot of a receiver stream, as the kernel
    works it out: tile ``r_chunk[k // EC]``, row ``r_local[k]``; a dead slot
    (``r_local == TILE``) takes its tile's last row, as the graph's padding
    edges do."""
    tile = r_chunk.long().repeat_interleave(EC)
    return tile * TILE + r_local.long().clamp(max=TILE - 1)


def fused_v1_plain(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk,
                   alpha: float):
    """Plain PyTorch version of :func:`fused_v1` (gathers + ``index_add_``)."""
    _check_args("fused_v1", (wh,), (f_dst, bound), a_src, keepq, senders,
                r_local, r_chunk)
    n_pad, hf = wh.shape
    h, f = a_src.shape
    e = senders.shape[0]
    snd, rcv = senders.long(), stream_receivers(r_local, r_chunk)
    g = wh[snd].view(e, h, f)
    raw = f_dst[rcv] + (g * a_src).sum(-1)
    live = (r_local < TILE)[:, None]
    num = torch.where(live, torch.exp(leaky_relu(raw, alpha) - bound[rcv]), 0.0)
    msgs = (g * (num * keepq)[:, :, None]).view(e, hf)
    out = torch.zeros(n_pad, hf, dtype=wh.dtype, device=wh.device)
    den = torch.zeros(n_pad, h, dtype=wh.dtype, device=wh.device)
    return out.index_add_(0, rcv, msgs), den.index_add_(0, rcv, num)


@build.counted
def fused_v1(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk,
             alpha: float):
    """(out [N, HF], den [N, H]) of the fused GATv1 forward.

    wh [N, HF], f_dst/bound [N, H], a_src [H, F], keepq [E, H] (keep/(1-p)
    factors, ones when not training); senders/r_local [E] and r_chunk
    [E / EC] int32 in receiver stream order, which give every slot its
    receiver (:func:`stream_receivers`). On a CUDA tensor this launches
    ``csrc/fused_v1.cu`` (counted in ``fused_v1.launches``), on a CPU
    tensor it runs :func:`fused_v1_plain`.
    """
    if wh.device.type == "cpu":
        return fused_v1_plain(wh, f_dst, bound, a_src, keepq, senders,
                              r_local, r_chunk, alpha)
    if wh.device.type != "cuda":
        raise ValueError(f"fused_v1: unsupported device {wh.device}")
    _check_args("fused_v1", (wh,), (f_dst, bound), a_src, keepq, senders,
                r_local, r_chunk)
    return _launch(fused_v1, (wh, f_dst, bound, a_src, keepq, senders,
                             r_local, r_chunk), a_src, alpha)


class _FusedV1Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wh, f_dst, bound, a_src, keepq, senders, receivers,
                r_local, r_chunk, c_slot, c_local, c_chunk, alpha):
        wh, f_dst, bound, a_src, keepq = (
            t.contiguous() for t in (wh, f_dst, bound, a_src, keepq))
        out, den = fused_v1(wh, f_dst, bound, a_src, keepq, senders,
                            r_local, r_chunk, alpha)
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
        return (dwh, df_dst, None, da) + (None,) * 9


def fused_v1_attention(wh, f_dst, bound, a_src, keepq, senders, receivers,
                       r_local, r_chunk, c_slot, c_local, c_chunk,
                       alpha: float):
    """Differentiable fused GATv1 attention: (out [N, HF], den [N, H]).

    ``bound`` must already be detached (its true gradient is zero: the
    softmax is invariant to a per-receiver shift). Gradients flow to ``wh``,
    ``f_dst`` and ``a_src``.
    """
    return _FusedV1Attention.apply(wh, f_dst, bound, a_src, keepq, senders,
                                   receivers, r_local, r_chunk, c_slot,
                                   c_local, c_chunk, alpha)


# ---------------------------------------------------------------------------
# v2 (GATv2: LeakyReLU before the a-projection; aggregates the LEFT
# projection gathered at senders, reference layers.py:278-296)
# ---------------------------------------------------------------------------


def fused_v2_plain(whi, whj, ub, a, keepq, senders, r_local, r_chunk,
                   alpha: float):
    """Plain PyTorch version of :func:`fused_v2` (gathers + ``index_add_``)."""
    _check_args("fused_v2", (whi, whj), (ub,), a, keepq, senders, r_local,
                r_chunk)
    n_pad, hf = whi.shape
    h, f = a.shape
    e = senders.shape[0]
    snd, rcv = senders.long(), stream_receivers(r_local, r_chunk)
    pre = leaky_relu(whi[rcv] + whj[snd], alpha).view(e, h, f)
    logits = (pre * a).sum(-1)
    live = (r_local < TILE)[:, None]
    num = torch.where(live, torch.exp(logits - ub[rcv]), 0.0)
    msgs = (whi[snd].view(e, h, f) * (num * keepq)[:, :, None]).view(e, hf)
    out = torch.zeros(n_pad, hf, dtype=whi.dtype, device=whi.device)
    den = torch.zeros(n_pad, h, dtype=whi.dtype, device=whi.device)
    return out.index_add_(0, rcv, msgs), den.index_add_(0, rcv, num)


@build.counted
def fused_v2(whi, whj, ub, a, keepq, senders, r_local, r_chunk, alpha: float):
    """(out [N, HF], den [N, H]) of the fused GATv2 forward.

    whi/whj [N, HF] (left and right projections), ub [N, H] (an upper bound
    of every logit of the row), a [H, F], keepq [E, H] (keep/(1-p) factors,
    ones when not training); senders/r_local [E] and r_chunk [E / EC] int32
    in receiver stream order. On a CUDA tensor this launches
    ``csrc/fused_v2.cu`` (counted in ``fused_v2.launches``), on a CPU tensor
    it runs :func:`fused_v2_plain`.
    """
    if whi.device.type == "cpu":
        return fused_v2_plain(whi, whj, ub, a, keepq, senders, r_local,
                              r_chunk, alpha)
    if whi.device.type != "cuda":
        raise ValueError(f"fused_v2: unsupported device {whi.device}")
    _check_args("fused_v2", (whi, whj), (ub,), a, keepq, senders, r_local,
                r_chunk)
    return _launch(fused_v2, (whi, whj, ub, a, keepq, senders, r_local,
                             r_chunk), a, alpha)


class _FusedV2Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, whi, whj, ub, a, keepq, senders, receivers, r_local,
                r_chunk, c_slot, c_local, c_chunk, alpha):
        whi, whj, ub, a, keepq = (
            t.contiguous() for t in (whi, whj, ub, a, keepq))
        out, den = fused_v2(whi, whj, ub, a, keepq, senders, r_local, r_chunk,
                            alpha)
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
        return (dwhi_e + red[:, hf:], red[:, :hf], None, da) + (None,) * 9


def fused_v2_attention(whi, whj, ub, a, keepq, senders, receivers, r_local,
                       r_chunk, c_slot, c_local, c_chunk, alpha: float):
    """Differentiable fused GATv2 attention: (out [N, HF], den [N, H]).

    ``ub`` must already be detached (its true gradient is zero: the softmax
    is invariant to a per-receiver shift). Gradients flow to ``whi``,
    ``whj`` and ``a``.
    """
    return _FusedV2Attention.apply(whi, whj, ub, a, keepq, senders, receivers,
                                   r_local, r_chunk, c_slot, c_local, c_chunk,
                                   alpha)
