"""Fused sparse GATv1 attention (port of the v1 half of
``pygat_tpu/ops/fused_stream.py``).

:func:`fused_v1` computes, per live stream slot, the logit, the
bound-shifted exp, the attention keep factor and the message, and scatters
the aggregated numerator ``out [N, HF]`` and the pre-dropout denominator
``den [N, H]``. On a CUDA tensor it launches the hand-written kernel
``csrc/fused_v1.cu``, which replaces the TPU kernel
``pygat_tpu/ops/fused_stream.py::_make_v1_kernel`` (the source notes what
bounds it and how it is laid out); on a CPU tensor it runs
:func:`fused_v1_plain`, the plain PyTorch version that is also the kernel's
oracle.

:func:`fused_v1_attention` is the differentiable op, the counterpart of the
reference's custom VJP: the forward is :func:`fused_v1`, and the backward
is the math of ``_v1_bwd`` in PyTorch, recomputing the per-edge pipeline
lane-minor and reducing through the stream segment sums (once per receiver
for ``df_dst``, once per sender for ``dwh``).
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

MAX_F = 256  # widest head the kernel takes (csrc/fused_v1.cu)


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


def _check_args(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk):
    n_pad, hf = wh.shape
    h, f = a_src.shape
    e = senders.shape[0]
    if n_pad % TILE or h * f != hf:
        raise ValueError(f"wh {tuple(wh.shape)} does not match a_src "
                         f"{tuple(a_src.shape)} on 128-row tiles")
    if f_dst.shape != (n_pad, h) or bound.shape != (n_pad, h):
        raise ValueError("f_dst and bound must be [N, H]")
    if keepq.shape != (e, h) or r_local.shape != (e,) or e != r_chunk.shape[0] * EC:
        raise ValueError("keepq, senders and r_local must cover the stream")
    for t in (wh, f_dst, bound, a_src, keepq):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_v1 takes float32, got {t.dtype}")
    for t in (senders, r_local, r_chunk):
        if t.dtype != torch.int32:
            raise ValueError(f"fused_v1 takes int32 indices, got {t.dtype}")


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
    _check_args(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk)
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
    _check_args(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk)
    args = (wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk)
    for t in args:
        if t.device != wh.device or not t.is_contiguous():
            raise ValueError("fused_v1: every tensor must be contiguous and "
                             "on the same device")
    h, f = a_src.shape
    if f > MAX_F:
        raise ValueError(f"fused_v1: head width {f} exceeds {MAX_F}")
    n_pad, hf = wh.shape
    out = torch.empty(n_pad, hf, dtype=torch.float32, device=wh.device)
    den = torch.empty(n_pad, h, dtype=torch.float32, device=wh.device)
    launch = build.kernel("fused_v1")
    with torch.cuda.device(wh.device):
        rc = launch(
            wh.data_ptr(), f_dst.data_ptr(), bound.data_ptr(),
            a_src.data_ptr(), keepq.data_ptr(), senders.data_ptr(),
            r_local.data_ptr(), r_chunk.data_ptr(), r_chunk.shape[0],
            n_pad // TILE, h, f, float(alpha), out.data_ptr(), den.data_ptr(),
            torch.cuda.current_stream(wh.device).cuda_stream)
    build.check(rc, "fused_v1")
    fused_v1.launches += 1
    return out, den


fused_v1.launches = 0


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
