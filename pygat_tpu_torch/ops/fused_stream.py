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
reducing through the stream segment sums (once per receiver over the
graph's walk, once per sender over its CSC walk,
:attr:`~pygat_tpu_torch.graph.Graph.sender_walk`). The reference's
``combined``/``split`` sender-window switch has no counterpart: it exists
because Mosaic cannot gather rows, and the CUDA kernel gathers ``whj[s]``
and ``whi[s]`` itself.

Every op takes the reference's ``precision``. ``'high'`` computes in f32.
``'fastest'`` is the reference's one bf16 limb as its interpret mode
computes it: the sender rows (``wh``; ``whj`` and ``whi`` at the sender)
and ``a`` enter as bf16 (to nearest, ties to even), GATv2's LeakyReLU'd
pre-sum is rounded to bf16 before its product with ``a``, and each message
is rounded to bf16 before its f32 sum; ``f_dst``, the bound, exp, the
numerator and the denominator stay f32. On a CUDA tensor the wrappers then
cast the sender tables to bf16 once a call and launch the one-limb kernels
``csrc/fused_v1_bf16.cu`` / ``csrc/fused_v2_bf16.cu`` (counted by
:func:`fused_v1_bf16`, :func:`fused_v2_bf16` and, for a ring hop,
:func:`fused_v1_parts_bf16`, :func:`fused_v2_parts_bf16`); the plain
versions round at the same points. The backward recomputes in f32 from the
unrounded operands and runs its two stream sums at the forward's
precision, as the reference's does.
"""

from __future__ import annotations

import os

import torch

from pygat_tpu_torch.ops import build, segment
from pygat_tpu_torch.ops.stream import (
    EC,
    TILE,
    StreamWalk,
    check_precision,
    stream_segment_sum,
    stream_sender_segment_sum,
    stream_walk_arg,
)

MAX_F = 256  # widest head of the fused kernels (tile_fused.cuh)

_FUSED = None  # resolved from PYGAT_FUSED_ATTENTION at first use


def _fused_mode() -> str:
    global _FUSED
    if _FUSED is None:
        _FUSED = os.environ.get("PYGAT_FUSED_ATTENTION", "auto")
    return _FUSED


def set_fused_attention(mode: str) -> None:
    """``'auto'`` (on whenever the stream segment sums are the active impl,
    :func:`~pygat_tpu_torch.ops.segment.set_segment_impl`), ``'on'`` or
    ``'off'``; the process default is ``PYGAT_FUSED_ATTENTION``, else
    ``'auto'``."""
    global _FUSED
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused-attention mode {mode!r}")
    _FUSED = mode


def fused_enabled(graph) -> bool:
    """Whether the sparse layers take the fused branch on ``graph``: it
    needs the graph's stream layout and, under ``'auto'``, the stream impl
    (a graph without the layout takes the unfused branch)."""
    if graph.r_local is None:
        return False
    mode = _fused_mode()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused-attention mode {mode!r} "
                         "(PYGAT_FUSED_ATTENTION)")
    if mode != "auto":
        return mode == "on"
    return segment.stream_enabled()


def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even), in its own type."""
    return x.to(torch.bfloat16).to(x.dtype)


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


def launch_tile_fused(wrapper, tensors, a, n_pad: int, walk: StreamWalk,
                      alpha: float):
    """Launch ``wrapper``'s tile-owner kernel (``csrc/tile_fused.cuh``) on
    the current stream and count the launch. ``tensors`` are the kernel's
    array arguments before the walk's ``row_ptr`` (the tables, the per-node
    head terms, ``a``, ``keepq`` and the walk's words by position, if any);
    ``walk`` gives ``row_ptr``, ``tile_ptr``, ``split_at`` and ``max_run``
    (the graph's, or a band plan's receiver walk). Returns the new (out
    [N, HF], den [N, H])."""
    h, f = a.shape
    if f > MAX_F:
        raise ValueError(f"{wrapper.kernel}: head width {f} exceeds {MAX_F}")
    dev, n_split = a.device, walk.split_at.shape[0]
    out = torch.empty(n_pad, h * f, dtype=torch.float32, device=dev)
    den = torch.empty(n_pad, h, dtype=torch.float32, device=dev)
    part_out = part_den = None
    if n_split:
        part_out = torch.empty(n_split, TILE, h * f, dtype=torch.float32,
                               device=dev)
        part_den = torch.empty(n_split, TILE, h, dtype=torch.float32,
                               device=dev)
    build.launch(wrapper, *tensors, walk.row_ptr, walk.tile_ptr,
                 walk.split_at, n_pad // TILE, n_split, walk.max_run, h, f,
                 float(alpha), out, den, part_out, part_den)
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
                  alpha: float, f64: bool = False, precision: str = "high",
                  magnitude: bool = False):
    """The fused GATv1 forward in plain PyTorch from the sender rows
    ``g_w`` [E, HF] of every slot (gathers + ``index_add_``). ``f64=True`` evaluates in float64 and returns float32: the kernels'
    oracle where a row sums thousands of terms, whose float32 sum by
    ``index_add_`` (atomics on the card, in an order that changes from call
    to call) is itself off by up to about 1e-5 of the row. ``precision``
    as the module docstring says (under ``f64`` the operands are rounded to
    bf16 first, the messages in f64). ``magnitude=True`` sums each
    message's magnitude in its place: the allowance of the one-limb
    kernels' oracle, since a message rounded from an f32 value that differs
    in its last bit may land on the neighbouring bf16 value, one bf16 step
    (at most 2^-7 of it) away."""
    one = check_precision("fused_v1", precision) == "fastest"
    if one:  # the one-limb operands
        g_w, a_src = _bf16(g_w), _bf16(a_src)
    if f64:
        return tuple(t.float() for t in v1_plain_core(
            *(t.double() for t in (g_w, f_dst, bound, a_src, keepq)),
            r_local, r_chunk, alpha, precision=precision,
            magnitude=magnitude))
    n_pad, h = f_dst.shape
    f = a_src.shape[1]
    e = g_w.shape[0]
    rcv = stream_receivers(r_local, r_chunk)
    g = g_w.reshape(e, h, f)
    raw = f_dst[rcv] + (g * a_src).sum(-1)
    live = (r_local < TILE)[:, None]
    num = torch.where(live, torch.exp(leaky_relu(raw, alpha) - bound[rcv]), 0.0)
    msgs = (g * (num * keepq)[:, :, None]).view(e, h * f)
    if one:
        msgs = _bf16(msgs)
    if magnitude:
        msgs = msgs.abs()
    out = torch.zeros(n_pad, h * f, dtype=g_w.dtype, device=g_w.device)
    den = torch.zeros(n_pad, h, dtype=g_w.dtype, device=g_w.device)
    return out.index_add_(0, rcv, msgs), den.index_add_(0, rcv, num)


def fused_v1_plain(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk,
                   alpha: float, *, f64: bool = False,
                   precision: str = "high", magnitude: bool = False):
    """Plain PyTorch version of :func:`fused_v1` (gathers + ``index_add_``;
    ``f64``, ``precision`` and ``magnitude`` as :func:`v1_plain_core`)."""
    _check_args("fused_v1", (wh,), (f_dst, bound), a_src, keepq, senders,
                r_local, r_chunk)
    return v1_plain_core(wh[senders.long()], f_dst, bound, a_src, keepq,
                         r_local, r_chunk, alpha, f64, precision, magnitude)


@build.counted
def fused_v1(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk,
             alpha: float, *, walk: StreamWalk | None = None,
             precision: str = "high"):
    """(out [N, HF], den [N, H]) of the fused GATv1 forward.

    wh [N, HF], f_dst/bound [N, H], a_src [H, F], keepq [E, H] (keep/(1-p)
    factors, ones when not training); senders/r_local [E] and r_chunk
    [E / EC] int32 in receiver stream order, which give every slot its
    receiver (:func:`stream_receivers`); ``walk`` the stream's walk
    (``graph.stream_walk``). On a CUDA tensor this launches
    ``csrc/fused_v1.cu`` (counted in ``fused_v1.launches``), or under
    ``precision='fastest'`` ``csrc/fused_v1_bf16.cu`` on a bf16 copy of
    ``wh`` (counted in ``fused_v1_bf16.launches``), whose result is the
    same bit for bit from call to call, and raises without a walk; on a
    CPU tensor it runs :func:`fused_v1_plain`.
    """
    check_precision("fused_v1", precision)
    if wh.device.type == "cpu":
        return fused_v1_plain(wh, f_dst, bound, a_src, keepq, senders,
                              r_local, r_chunk, alpha, precision=precision)
    if wh.device.type != "cuda":
        raise ValueError(f"fused_v1: unsupported device {wh.device}")
    _check_args("fused_v1", (wh,), (f_dst, bound), a_src, keepq, senders,
                r_local, r_chunk)
    n_pad = wh.shape[0]
    walk = stream_walk_arg("fused_v1", walk, n_pad, r_chunk)
    if precision == "fastest":
        return launch_tile_fused(fused_v1_bf16, (
            wh.to(torch.bfloat16), f_dst, bound, a_src, keepq, senders),
            a_src, n_pad, walk, alpha)
    return launch_tile_fused(fused_v1, (wh, f_dst, bound, a_src, keepq,
                                        senders), a_src, n_pad, walk, alpha)


@build.counted
def fused_v1_bf16(wh, f_dst, bound, a_src, keepq, senders, r_local, r_chunk,
                  alpha: float, *, walk: StreamWalk | None = None):
    """:func:`fused_v1` under ``precision='fastest'``, whose launches of the
    one-limb kernel ``csrc/fused_v1_bf16.cu`` (the TPU kernel's
    ``two_limb=False`` instantiation) this wrapper counts."""
    return fused_v1(wh, f_dst, bound, a_src, keepq, senders, r_local,
                    r_chunk, alpha, walk=walk, precision="fastest")


class _FusedV1Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wh, f_dst, bound, a_src, keepq, senders, receivers,
                r_local, r_chunk, c_slot, c_local, c_chunk, alpha, walk,
                sender_walk, precision):
        wh, f_dst, bound, a_src, keepq = (
            t.contiguous() for t in (wh, f_dst, bound, a_src, keepq))
        out, den = fused_v1(wh, f_dst, bound, a_src, keepq, senders,
                            r_local, r_chunk, alpha, walk=walk,
                            precision=precision)
        ctx.save_for_backward(wh, f_dst, bound, a_src, keepq, senders,
                              receivers, r_local, r_chunk, c_slot, c_local,
                              c_chunk)
        ctx.alpha, ctx.walks = alpha, (walk, sender_walk)
        ctx.precision = precision
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
        walk, sender_walk = ctx.walks
        df_dst = stream_segment_sum(draw, receivers, r_local, r_chunk, n_pad,
                                    walk, ctx.precision)
        # dwh: one per-sender reduction of the message and logit cotangents
        dgathered = dmsg * (qnum @ exp_bd) + draw @ abd.T  # [E, HF]
        dwh = stream_sender_segment_sum(dgathered, senders, c_slot, c_local,
                                        c_chunk, n_pad, sender_walk,
                                        ctx.precision)
        da = (g_w * (draw @ exp_bd)).sum(0).reshape(h, f)
        return (dwh, df_dst, None, da) + (None,) * 12


def fused_v1_attention(wh, f_dst, bound, a_src, keepq, senders, receivers,
                       r_local, r_chunk, c_slot, c_local, c_chunk,
                       alpha: float, walk: StreamWalk | None = None,
                       sender_walk: StreamWalk | None = None,
                       precision: str = "high"):
    """Differentiable fused GATv1 attention: (out [N, HF], den [N, H]).

    ``bound`` must already be detached (its true gradient is zero: the
    softmax is invariant to a per-receiver shift). Gradients flow to ``wh``,
    ``f_dst`` and ``a_src``. ``walk`` (``graph.stream_walk``) is the
    forward kernel's and the receiver sum's, ``sender_walk``
    (``graph.sender_walk``) the sender sum's, both needed on CUDA tensors.
    ``precision`` (module docstring) is the forward's and the backward's
    two stream sums'.
    """
    check_precision("fused_v1_attention", precision)
    return _FusedV1Attention.apply(wh, f_dst, bound, a_src, keepq, senders,
                                   receivers, r_local, r_chunk, c_slot,
                                   c_local, c_chunk, alpha, walk, sender_walk,
                                   precision)


# ---------------------------------------------------------------------------
# v2 (GATv2: LeakyReLU before the a-projection; aggregates the LEFT
# projection gathered at senders, reference layers.py:278-296)
# ---------------------------------------------------------------------------


def v2_plain_core(gj, gi, whi, ub, a, keepq, r_local, r_chunk,
                  alpha: float, f64: bool = False, precision: str = "high",
                  magnitude: bool = False):
    """The fused GATv2 forward in plain PyTorch from the sender rows of
    every slot, ``gj`` of whj and ``gi`` of whi, [E, HF] each (gathers +
    ``index_add_``). ``f64``, ``precision`` and ``magnitude`` as
    :func:`v1_plain_core` (``whi``, the receiver's, stays unrounded; under
    ``f64`` the LeakyReLU'd pre-sum is still rounded to bf16 from its
    value in the inputs' type, f32, as the kernel and the reference round
    it, so that the oracle's logit operands are the kernel's)."""
    one = check_precision("fused_v2", precision) == "fastest"
    n_pad, hf = whi.shape
    h, f = a.shape
    e = gj.shape[0]
    rcv = stream_receivers(r_local, r_chunk)
    dt = torch.float64 if f64 else whi.dtype
    if one:  # the one-limb operands
        pre = _bf16(leaky_relu(whi[rcv] + _bf16(gj), alpha)).to(dt)
        gi, a = _bf16(gi).to(dt), _bf16(a).to(dt)
    else:
        pre = leaky_relu(whi.to(dt)[rcv] + gj.to(dt), alpha)
        gi, a = gi.to(dt), a.to(dt)
    logits = (pre.view(e, h, f) * a).sum(-1)
    live = (r_local < TILE)[:, None]
    num = torch.where(live, torch.exp(logits - ub.to(dt)[rcv]), 0.0)
    msgs = (gi.reshape(e, h, f) * (num * keepq.to(dt))[:, :, None]).view(e, hf)
    if one:
        msgs = _bf16(msgs)
    if magnitude:
        msgs = msgs.abs()
    out = torch.zeros(n_pad, hf, dtype=dt, device=whi.device)
    den = torch.zeros(n_pad, h, dtype=dt, device=whi.device)
    out, den = out.index_add_(0, rcv, msgs), den.index_add_(0, rcv, num)
    return (out.float(), den.float()) if f64 else (out, den)


def fused_v2_plain(whi, whj, ub, a, keepq, senders, r_local, r_chunk,
                   alpha: float, *, f64: bool = False,
                   precision: str = "high", magnitude: bool = False):
    """Plain PyTorch version of :func:`fused_v2` (gathers + ``index_add_``;
    ``f64``, ``precision`` and ``magnitude`` as :func:`v2_plain_core`)."""
    _check_args("fused_v2", (whi, whj), (ub,), a, keepq, senders, r_local,
                r_chunk)
    snd = senders.long()
    return v2_plain_core(whj[snd], whi[snd], whi, ub, a, keepq, r_local,
                         r_chunk, alpha, f64, precision, magnitude)


@build.counted
def fused_v2(whi, whj, ub, a, keepq, senders, r_local, r_chunk, alpha: float,
             *, walk: StreamWalk | None = None, precision: str = "high"):
    """(out [N, HF], den [N, H]) of the fused GATv2 forward.

    whi/whj [N, HF] (left and right projections), ub [N, H] (an upper bound
    of every logit of the row), a [H, F], keepq [E, H] (keep/(1-p) factors,
    ones when not training); senders/r_local [E] and r_chunk [E / EC] int32
    in receiver stream order; ``walk`` the stream's walk
    (``graph.stream_walk``). On a CUDA tensor this launches
    ``csrc/fused_v2.cu`` (counted in ``fused_v2.launches``), or under
    ``precision='fastest'`` ``csrc/fused_v2_bf16.cu`` on bf16 copies of
    ``whj`` and ``whi`` for the sender's rows (counted in
    ``fused_v2_bf16.launches``), whose result is the same bit for bit from
    call to call, and raises without a walk; on a CPU tensor it runs
    :func:`fused_v2_plain`.
    """
    check_precision("fused_v2", precision)
    if whi.device.type == "cpu":
        return fused_v2_plain(whi, whj, ub, a, keepq, senders, r_local,
                              r_chunk, alpha, precision=precision)
    if whi.device.type != "cuda":
        raise ValueError(f"fused_v2: unsupported device {whi.device}")
    _check_args("fused_v2", (whi, whj), (ub,), a, keepq, senders, r_local,
                r_chunk)
    n_pad = whi.shape[0]
    walk = stream_walk_arg("fused_v2", walk, n_pad, r_chunk)
    if precision == "fastest":
        return launch_tile_fused(fused_v2_bf16, (
            whi, whi.to(torch.bfloat16), whj.to(torch.bfloat16), ub, a, keepq,
            senders), a, n_pad, walk, alpha)
    return launch_tile_fused(fused_v2, (whi, whi, whj, ub, a, keepq, senders),
                             a, n_pad, walk, alpha)


@build.counted
def fused_v2_bf16(whi, whj, ub, a, keepq, senders, r_local, r_chunk,
                  alpha: float, *, walk: StreamWalk | None = None):
    """:func:`fused_v2` under ``precision='fastest'``, whose launches of the
    one-limb kernel ``csrc/fused_v2_bf16.cu`` (the TPU kernel's
    ``two_limb=False`` instantiation) this wrapper counts."""
    return fused_v2(whi, whj, ub, a, keepq, senders, r_local, r_chunk, alpha,
                    walk=walk, precision="fastest")


class _FusedV2Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, whi, whj, ub, a, keepq, senders, receivers, r_local,
                r_chunk, c_slot, c_local, c_chunk, alpha, walk, sender_walk,
                precision):
        whi, whj, ub, a, keepq = (
            t.contiguous() for t in (whi, whj, ub, a, keepq))
        out, den = fused_v2(whi, whj, ub, a, keepq, senders, r_local, r_chunk,
                            alpha, walk=walk, precision=precision)
        ctx.save_for_backward(whi, whj, ub, a, keepq, senders, receivers,
                              r_local, r_chunk, c_slot, c_local, c_chunk)
        ctx.alpha, ctx.walks = alpha, (walk, sender_walk)
        ctx.precision = precision
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
        walk, sender_walk = ctx.walks
        dwhi_e = stream_segment_sum(dpre, receivers, r_local, r_chunk, n_pad,
                                    walk, ctx.precision)
        # sender side: one reduction for dwhj (logit path) and the message
        # half of dwhi
        both = torch.cat([dpre, dmsg * (qnum @ exp_bd)], dim=1)  # [E, 2HF]
        red = stream_sender_segment_sum(both, senders, c_slot, c_local,
                                        c_chunk, n_pad, sender_walk,
                                        ctx.precision)
        da = (pre * (dlogits @ exp_bd)).sum(0).reshape(h, f)
        return (dwhi_e + red[:, hf:], red[:, :hf], None, da) + (None,) * 12


def fused_v2_attention(whi, whj, ub, a, keepq, senders, receivers, r_local,
                       r_chunk, c_slot, c_local, c_chunk, alpha: float,
                       walk: StreamWalk | None = None,
                       sender_walk: StreamWalk | None = None,
                       precision: str = "high"):
    """Differentiable fused GATv2 attention: (out [N, HF], den [N, H]).

    ``ub`` must already be detached (its true gradient is zero: the softmax
    is invariant to a per-receiver shift). Gradients flow to ``whi``,
    ``whj`` and ``a``. ``walk``, ``sender_walk`` and ``precision`` as in
    :func:`fused_v1_attention`.
    """
    check_precision("fused_v2_attention", precision)
    return _FusedV2Attention.apply(whi, whj, ub, a, keepq, senders, receivers,
                                   r_local, r_chunk, c_slot, c_local, c_chunk,
                                   alpha, walk, sender_walk, precision)


# ---------------------------------------------------------------------------
# One hop of the ring (parallel/partition.py): the receiver side lives on
# this shard's node block [n_local, ...], the sender tables are a rotated
# shard or a halo buffer [n_buf, HF], and the edge order is one (dst, src)
# block's receiver stream. Port of fused_v1_attention_parts /
# fused_v2_attention_parts (pygat_tpu/ops/fused_stream.py:696, :589).
# ---------------------------------------------------------------------------


def _check_parts(what, bufs, local, narrow, a, keepq, senders, r_local,
                 r_chunk):
    """Shapes and types of a ring hop's forward: ``bufs`` are the sender
    tables [n_buf, HF] (one row count, any), ``local`` the receiver-side
    wide tables [n_local, HF] (v2's whi), ``narrow`` the receiver-side head
    terms [n_local, H]; the stream covers one block."""
    h, f = a.shape
    hf = h * f
    n_local = narrow[0].shape[0]
    n_buf = bufs[0].shape[0]
    if n_local % TILE:
        raise ValueError(f"{what}: the receiver block has {n_local} rows, "
                         f"not a multiple of {TILE}")
    if any(t.shape != (n_buf, hf) for t in bufs):
        raise ValueError(f"{what}: the sender tables must be [n_buf, HF] "
                         f"with HF = {hf}")
    if any(t.shape != (n_local, hf) for t in local):
        raise ValueError(f"{what}: the receiver tables must be [n_local, HF]")
    if any(t.shape != (n_local, h) for t in narrow):
        raise ValueError(f"{what}: the per-node head terms must be "
                         "[n_local, H]")
    e = r_local.shape[0]
    if (keepq.shape != (e, h) or r_local.dim() != 1 or senders.shape != (e,)
            or e != r_chunk.shape[0] * EC):
        raise ValueError("keepq, senders and r_local must cover the stream")
    for t in (*bufs, *local, *narrow, a, keepq):
        if t.dtype != torch.float32:
            raise ValueError(f"{what} takes float32, got {t.dtype}")
    for t in (senders, r_local, r_chunk):
        if t.dtype != torch.int32:
            raise ValueError(f"{what} takes int32 indices, got {t.dtype}")


def fused_v1_parts_plain(w_buf, f_dst, bound, a_src, keepq, senders, r_local,
                         r_chunk, alpha: float, *, f64: bool = False,
                         precision: str = "high", magnitude: bool = False):
    """Plain PyTorch version of :func:`fused_v1_parts` (gathers +
    ``index_add_``; ``f64``, ``precision`` and ``magnitude`` as
    :func:`v1_plain_core`)."""
    _check_parts("fused_v1_parts", (w_buf,), (), (f_dst, bound), a_src, keepq,
                 senders, r_local, r_chunk)
    return v1_plain_core(w_buf[senders.long()], f_dst, bound, a_src, keepq,
                         r_local, r_chunk, alpha, f64, precision, magnitude)


@build.counted(source="fused_v1")
def fused_v1_parts(w_buf, f_dst, bound, a_src, keepq, senders, r_local,
                   r_chunk, alpha: float, *, walk: StreamWalk | None = None,
                   precision: str = "high"):
    """(out [n_local, HF], den [n_local, H]) of the fused GATv1 forward over
    one ring hop: ``f_dst``/``bound`` [n_local, H] of this shard's rows,
    the sender table ``w_buf`` [n_buf, HF] (a rotated shard or a halo
    buffer), and one (dst, src) block's receiver stream (``senders`` index
    ``w_buf``, ``walk`` the block's receiver walk over n_local rows). On a
    CUDA tensor this launches ``csrc/fused_v1.cu``, whose sender table may
    have another row count than the receiver side (counted in
    ``fused_v1_parts.launches``, apart from :func:`fused_v1`'s; under
    ``precision='fastest'`` ``csrc/fused_v1_bf16.cu`` on a bf16 copy of
    ``w_buf``, counted in ``fused_v1_parts_bf16.launches``), and raises
    without a walk; on a CPU tensor it runs :func:`fused_v1_parts_plain`."""
    check_precision("fused_v1_parts", precision)
    if w_buf.device.type == "cpu":
        return fused_v1_parts_plain(w_buf, f_dst, bound, a_src, keepq,
                                    senders, r_local, r_chunk, alpha,
                                    precision=precision)
    if w_buf.device.type != "cuda":
        raise ValueError(f"fused_v1_parts: unsupported device {w_buf.device}")
    _check_parts("fused_v1_parts", (w_buf,), (), (f_dst, bound), a_src, keepq,
                 senders, r_local, r_chunk)
    n_local = f_dst.shape[0]
    walk = stream_walk_arg("fused_v1_parts", walk, n_local, r_chunk)
    if precision == "fastest":
        return launch_tile_fused(fused_v1_parts_bf16, (
            w_buf.to(torch.bfloat16), f_dst, bound, a_src, keepq, senders),
            a_src, n_local, walk, alpha)
    return launch_tile_fused(fused_v1_parts, (w_buf, f_dst, bound, a_src,
                                              keepq, senders),
                             a_src, n_local, walk, alpha)


@build.counted(source="fused_v1_bf16")
def fused_v1_parts_bf16(w_buf, f_dst, bound, a_src, keepq, senders, r_local,
                        r_chunk, alpha: float, *,
                        walk: StreamWalk | None = None):
    """:func:`fused_v1_parts` under ``precision='fastest'``, whose launches
    of ``csrc/fused_v1_bf16.cu`` this wrapper counts, apart from
    :func:`fused_v1_bf16`'s."""
    return fused_v1_parts(w_buf, f_dst, bound, a_src, keepq, senders,
                          r_local, r_chunk, alpha, walk=walk,
                          precision="fastest")


class _FusedV1Parts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f_dst, bound, w_buf, a_src, keepq, senders, receivers,
                r_local, r_chunk, c_slot, c_local, c_chunk, alpha, walk,
                sender_walk, precision):
        f_dst, bound, w_buf, a_src, keepq = (
            t.contiguous() for t in (f_dst, bound, w_buf, a_src, keepq))
        out, den = fused_v1_parts(w_buf, f_dst, bound, a_src, keepq, senders,
                                  r_local, r_chunk, alpha, walk=walk,
                                  precision=precision)
        ctx.save_for_backward(f_dst, bound, w_buf, a_src, keepq, senders,
                              receivers, r_local, c_slot, c_local, c_chunk,
                              r_chunk)
        ctx.alpha, ctx.walks = alpha, (walk, sender_walk)
        ctx.precision = precision
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        (f_dst, bound, w_buf, a_src, keepq, senders, receivers, r_local,
         c_slot, c_local, c_chunk, r_chunk) = ctx.saved_tensors
        alpha = ctx.alpha
        n_local = f_dst.shape[0]
        n_buf = w_buf.shape[0]
        h, f = a_src.shape
        snd, rcv = senders.long(), receivers.long()

        # recompute the per-edge pipeline, as _FusedV1Attention's backward
        g_w = w_buf[snd]  # [E, HF]
        abd = _block_diag_a(a_src)
        exp_bd = _expand_bd(h, f, device=w_buf.device)
        raw = f_dst[rcv] + g_w @ abd
        live = (r_local < TILE)[:, None]
        num = torch.where(live, torch.exp(leaky_relu(raw, alpha) - bound[rcv]),
                          0.0)
        qnum = num * keepq
        dmsg = g_out[rcv]
        dnum = ((dmsg * g_w) @ exp_bd.T) * keepq + g_den[rcv]
        draw = dnum * num * torch.where(raw >= 0, 1.0, alpha)  # [E, H]

        walk, sender_walk = ctx.walks
        # receiver side over this shard's n_local rows, sender side over
        # the buffer's n_buf rows (the block's sender view)
        df_dst = stream_segment_sum(draw, receivers, r_local, r_chunk,
                                    n_local, walk, ctx.precision)
        dgathered = dmsg * (qnum @ exp_bd) + draw @ abd.T  # [E, HF]
        dw_buf = stream_sender_segment_sum(dgathered, senders, c_slot, c_local,
                                           c_chunk, n_buf, sender_walk,
                                           ctx.precision)
        da = (g_w * (draw @ exp_bd)).sum(0).reshape(h, f)
        return (df_dst, None, dw_buf, da) + (None,) * 12


def fused_v1_attention_parts(f_dst, bound, w_buf, a_src, keepq, senders,
                             receivers, r_local, r_chunk, c_slot, c_local,
                             c_chunk, alpha: float,
                             walk: StreamWalk | None = None,
                             sender_walk: StreamWalk | None = None,
                             precision: str = "high"):
    """Differentiable GATv1 attention over one ring hop: (out [n_local,
    HF], den [n_local, H]). ``f_dst``/``bound`` are this shard's
    [n_local, H] (``bound`` detached), ``w_buf`` [n_buf, HF] the sender
    table; ``senders``, ``receivers`` and the stream fields are one (dst,
    src) block's, and ``c_slot``/``c_local``/``c_chunk`` its sender view
    over n_buf rows. ``walk`` is the block's receiver walk (n_local rows),
    ``sender_walk`` its sender view's (n_buf rows), both needed on CUDA
    tensors. Gradients flow to ``f_dst``, ``w_buf`` and ``a_src``: the
    JAX package's ``_v1p_bwd`` in PyTorch, through row 1's two sums.
    ``precision`` as :func:`fused_v1_attention`."""
    check_precision("fused_v1_attention_parts", precision)
    return _FusedV1Parts.apply(f_dst, bound, w_buf, a_src, keepq, senders,
                               receivers, r_local, r_chunk, c_slot, c_local,
                               c_chunk, alpha, walk, sender_walk, precision)


def fused_v2_parts_plain(wi_local, ub, wi_buf, wj_buf, a, keepq, senders,
                         r_local, r_chunk, alpha: float, *, f64: bool = False,
                         precision: str = "high", magnitude: bool = False):
    """Plain PyTorch version of :func:`fused_v2_parts` (gathers +
    ``index_add_``; ``f64``, ``precision`` and ``magnitude`` as
    :func:`v2_plain_core`)."""
    _check_parts("fused_v2_parts", (wi_buf, wj_buf), (wi_local,), (ub,), a,
                 keepq, senders, r_local, r_chunk)
    snd = senders.long()
    return v2_plain_core(wj_buf[snd], wi_buf[snd], wi_local, ub, a, keepq,
                         r_local, r_chunk, alpha, f64, precision, magnitude)


@build.counted(source="fused_v2")
def fused_v2_parts(wi_local, ub, wi_buf, wj_buf, a, keepq, senders, r_local,
                   r_chunk, alpha: float, *, walk: StreamWalk | None = None,
                   precision: str = "high"):
    """(out [n_local, HF], den [n_local, H]) of the fused GATv2 forward over
    one ring hop: ``wi_local`` [n_local, HF] and ``ub`` [n_local, H] of this
    shard's rows (the receiver's whi in the logit), the sender tables
    ``wi_buf`` (the message's whi) and ``wj_buf`` (the logit's whj)
    [n_buf, HF], and one block's receiver stream and walk, as
    :func:`fused_v1_parts`. On a CUDA tensor this launches
    ``csrc/fused_v2.cu`` with the receiver-side and the sender-side whi
    apart (counted in ``fused_v2_parts.launches``, apart from
    :func:`fused_v2`'s; under ``precision='fastest'``
    ``csrc/fused_v2_bf16.cu`` on bf16 copies of the sender tables, counted
    in ``fused_v2_parts_bf16.launches``) and raises without a walk; on a
    CPU tensor it runs :func:`fused_v2_parts_plain`."""
    check_precision("fused_v2_parts", precision)
    if wi_local.device.type == "cpu":
        return fused_v2_parts_plain(wi_local, ub, wi_buf, wj_buf, a, keepq,
                                    senders, r_local, r_chunk, alpha,
                                    precision=precision)
    if wi_local.device.type != "cuda":
        raise ValueError(f"fused_v2_parts: unsupported device "
                         f"{wi_local.device}")
    _check_parts("fused_v2_parts", (wi_buf, wj_buf), (wi_local,), (ub,), a,
                 keepq, senders, r_local, r_chunk)
    n_local = wi_local.shape[0]
    walk = stream_walk_arg("fused_v2_parts", walk, n_local, r_chunk)
    if precision == "fastest":
        return launch_tile_fused(fused_v2_parts_bf16, (
            wi_local, wi_buf.to(torch.bfloat16), wj_buf.to(torch.bfloat16),
            ub, a, keepq, senders), a, n_local, walk, alpha)
    return launch_tile_fused(fused_v2_parts, (wi_local, wi_buf, wj_buf, ub, a,
                                              keepq, senders),
                             a, n_local, walk, alpha)


@build.counted(source="fused_v2_bf16")
def fused_v2_parts_bf16(wi_local, ub, wi_buf, wj_buf, a, keepq, senders,
                        r_local, r_chunk, alpha: float, *,
                        walk: StreamWalk | None = None):
    """:func:`fused_v2_parts` under ``precision='fastest'``, whose launches
    of ``csrc/fused_v2_bf16.cu`` this wrapper counts, apart from
    :func:`fused_v2_bf16`'s."""
    return fused_v2_parts(wi_local, ub, wi_buf, wj_buf, a, keepq, senders,
                          r_local, r_chunk, alpha, walk=walk,
                          precision="fastest")


class _FusedV2Parts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wi_local, ub, wi_buf, wj_buf, a, keepq, senders,
                receivers, r_local, r_chunk, c_slot, c_local, c_chunk, alpha,
                walk, sender_walk, precision):
        wi_local, ub, wi_buf, wj_buf, a, keepq = (
            t.contiguous() for t in (wi_local, ub, wi_buf, wj_buf, a, keepq))
        out, den = fused_v2_parts(wi_local, ub, wi_buf, wj_buf, a, keepq,
                                  senders, r_local, r_chunk, alpha, walk=walk,
                                  precision=precision)
        ctx.save_for_backward(wi_local, ub, wi_buf, wj_buf, a, keepq, senders,
                              receivers, r_local, r_chunk, c_slot, c_local,
                              c_chunk)
        ctx.alpha, ctx.walks = alpha, (walk, sender_walk)
        ctx.precision = precision
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        (wi_local, ub, wi_buf, wj_buf, a, keepq, senders, receivers, r_local,
         r_chunk, c_slot, c_local, c_chunk) = ctx.saved_tensors
        alpha = ctx.alpha
        n_local, hf = wi_local.shape
        n_buf = wi_buf.shape[0]
        h, f = a.shape
        snd, rcv = senders.long(), receivers.long()

        # recompute the per-edge pipeline, as _FusedV2Attention's backward
        gi = wi_buf[snd]
        raw = wi_local[rcv] + wj_buf[snd]
        pre = leaky_relu(raw, alpha)
        abd = _block_diag_a(a)
        exp_bd = _expand_bd(h, f, device=wi_local.device)
        live = (r_local < TILE)[:, None]
        num = torch.where(live, torch.exp(pre @ abd - ub[rcv]), 0.0)
        qnum = num * keepq
        dmsg = g_out[rcv]
        dlogits = (((dmsg * gi) @ exp_bd.T) * keepq + g_den[rcv]) * num
        dpre = (dlogits @ abd.T) * torch.where(raw >= 0, 1.0, alpha)

        walk, sender_walk = ctx.walks
        # receiver side: d wi_local from the logit path; sender side: one
        # sum of [dpre | the message cotangent] split to the two buffers
        dwi_local = stream_segment_sum(dpre, receivers, r_local, r_chunk,
                                       n_local, walk, ctx.precision)
        both = torch.cat([dpre, dmsg * (qnum @ exp_bd)], dim=1)  # [E, 2HF]
        red = stream_sender_segment_sum(both, senders, c_slot, c_local,
                                        c_chunk, n_buf, sender_walk,
                                        ctx.precision)
        da = (pre * (dlogits @ exp_bd)).sum(0).reshape(h, f)
        return (dwi_local, None, red[:, hf:], red[:, :hf], da) + (None,) * 12


def fused_v2_attention_parts(wi_local, ub, wi_buf, wj_buf, a, keepq, senders,
                             receivers, r_local, r_chunk, c_slot, c_local,
                             c_chunk, alpha: float,
                             walk: StreamWalk | None = None,
                             sender_walk: StreamWalk | None = None,
                             precision: str = "high"):
    """Differentiable GATv2 attention over one ring hop: (out [n_local,
    HF], den [n_local, H]). ``wi_local``/``ub`` are this shard's (``ub``
    detached), ``wi_buf``/``wj_buf`` [n_buf, HF] the sender tables; the
    block fields, walks and ``precision`` as
    :func:`fused_v1_attention_parts`. Gradients flow to ``wi_local``,
    ``wi_buf``, ``wj_buf`` and ``a``: the JAX package's ``_v2p_bwd`` in
    PyTorch, through row 1's two sums."""
    check_precision("fused_v2_attention_parts", precision)
    return _FusedV2Parts.apply(wi_local, ub, wi_buf, wj_buf, a, keepq,
                               senders, receivers, r_local, r_chunk, c_slot,
                               c_local, c_chunk, alpha, walk, sender_walk,
                               precision)
