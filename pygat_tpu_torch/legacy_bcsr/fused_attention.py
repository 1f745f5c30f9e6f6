"""Fused sparse attention forward over the BCSR tiling (port of the JAX
package's ``tests/legacy_bcsr/fused_attention.py``).

One op replaces the whole sparse GATv1 attention pipeline (per-edge
logits, the segment max, exp, the two aggregations, the division), for all
heads:

    l[e, h]      = leaky_relu(f_dst[h, recv_e] + f_src[h, send_e])
    num[e, h]    = exp(l[e, h] - max of l over recv_e's edges)
    out[h, i, :] = sum_e num[e, h] * drop[e] * wh[h, send_e, :] / sum_e num[e, h]

On CUDA tensors :func:`bcsr_attention` launches the hand-written kernel
``csrc/bcsr_attention.cu`` over the tiling's walk
(:attr:`~.tiles.TiledGraph.walk`, built on the host by
:func:`~.tiles.tile_graph`), which replaces the TPU kernel ``_make_kernel``
(the source says how and what bounds it); on CPU tensors it runs
:func:`bcsr_attention_plain`, the plain PyTorch version over the flat
slots, which evaluated in float64 (``f64=True``) is also the kernel's
oracle. Both also return the per-(head, receiver) max and denominator,
which the analytic backward of :mod:`.sparse_attention` reuses.

``precision`` takes the reference's ``"default"`` and ``"highest"``, and
both compute in f32. The TPU's ``"default"`` is bf16-class (its one-hot
matmuls at the MXU's default precision); the port has no such mode here.
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.legacy_bcsr.tiles import EDGE_CHUNK, TILE, TiledGraph
from pygat_tpu_torch.ops import build

LANE = 128
PRECISIONS = ("default", "highest")


def head_feature_pad(n_heads: int, f: int) -> int:
    """Smallest f_pad >= f with n_heads * f_pad a multiple of the lane
    width (the TPU kernel's padding, kept for parity; the CUDA kernel does
    not pad)."""
    f_pad = f
    while (n_heads * f_pad) % LANE:
        f_pad += 1
    return f_pad


def _check_args(f_dst, f_src, wh, tiles: TiledGraph, drop, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; the BCSR "
                         f"attention takes {PRECISIONS}")
    if f_dst.dim() != 2 or f_src.shape != f_dst.shape:
        raise ValueError("f_dst and f_src must both be [H, N_pad]")
    h, n_pad = f_dst.shape
    if wh.dim() != 3 or wh.shape[:2] != (h, n_pad):
        raise ValueError(f"wh must be [H, N_pad, F] = [{h}, {n_pad}, F]")
    if n_pad != tiles.n_tiles * TILE:
        raise ValueError(f"N_pad={n_pad} inconsistent with {tiles.n_tiles} "
                         "tiles")
    if drop is not None and drop.shape != tiles.valid.shape:
        raise ValueError("drop must be [C, EDGE_CHUNK], as tiles.valid")
    for t in (f_dst, f_src, wh, tiles.valid, drop):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"the BCSR attention takes float32, got {t.dtype}")
    for t in (tiles.chunk_row, tiles.chunk_col, tiles.recv_local,
              tiles.send_local):
        if t.dtype != torch.int32:
            raise ValueError(f"the BCSR attention takes int32 indices, got "
                             f"{t.dtype}")


def bcsr_attention_plain(f_dst, f_src, wh, tiles: TiledGraph, alpha: float,
                         drop=None, precision: str = "default", *,
                         f64: bool = False):
    """Plain PyTorch version of :func:`bcsr_attention` over the flat slots:
    a gather, the segment max (``scatter_reduce``), exp, and two
    ``index_add_`` calls. Invalid slots go to a scratch row past the
    outputs, so nothing depends on the data's shape and nothing syncs.
    ``f64=True`` computes in float64 and returns float32: the kernel's
    oracle, since the float32 sums of a hub's row (``index_add_``'s atomics
    on the card, in an order that changes from call to call) are as noisy
    as the tolerance."""
    _check_args(f_dst, f_src, wh, tiles, drop, precision)
    if f64:
        f_dst, f_src, wh = (t.double() for t in (f_dst, f_src, wh))
        drop = None if drop is None else drop.double()
    h, n_pad = f_dst.shape
    valid = tiles.valid.reshape(-1) > 0
    rcv = (tiles.chunk_row.long().repeat_interleave(EDGE_CHUNK) * TILE
           + tiles.recv_local.reshape(-1).long())
    rcv = torch.where(valid, rcv, n_pad)
    snd = (tiles.chunk_col.long().repeat_interleave(EDGE_CHUNK) * TILE
           + tiles.send_local.reshape(-1).long())
    pre = f_dst[:, rcv.clamp(max=n_pad - 1)] + f_src[:, snd]  # [H, slots]
    logit = torch.where(pre >= 0, pre, alpha * pre)
    idx = rcv.expand(h, -1)
    m = torch.full((h, n_pad + 1), -torch.inf, dtype=f_dst.dtype,
                   device=f_dst.device)
    m = m.scatter_reduce(1, idx, logit, "amax", include_self=False)
    num = torch.where(valid, torch.exp(logit - m.gather(1, idx)), 0.0)
    den = torch.zeros_like(m).index_add_(1, rcv, num)
    q = num if drop is None else num * drop.reshape(-1)
    msgs = wh[:, snd, :] * q[:, :, None]
    acc = torch.zeros(h, n_pad + 1, wh.shape[2], dtype=wh.dtype,
                      device=wh.device).index_add_(1, rcv, msgs)
    m, den, acc = m[:, :n_pad], den[:, :n_pad], acc[:, :n_pad]
    has = den > 0
    out = acc / torch.where(has, den, 1.0)[:, :, None]
    res = (out, torch.where(has, m, 0.0), den)
    return tuple(t.float() for t in res) if f64 else res


@build.counted
def bcsr_attention(f_dst, f_src, wh, tiles: TiledGraph, alpha: float,
                   drop=None, precision: str = "default"):
    """(out [H, N_pad, F], m [H, N_pad], den [H, N_pad]) of the fused
    attention over ``tiles``: ``m`` is each receiver's max logit and
    ``den`` its softmax denominator (both 0 for a receiver with no valid
    slot, whose ``out`` row is 0).

    f_dst / f_src [H, N_pad], wh [H, N_pad, F] float32; ``drop`` [C,
    EDGE_CHUNK] the numerators' keep factors per slot, or None. On a CUDA
    tensor this launches ``csrc/bcsr_attention.cu`` over the tiling's walk
    (:attr:`~.tiles.TiledGraph.walk`; it raises when there is none, and
    never builds one), counted in ``bcsr_attention.launches``; on a CPU
    tensor it runs :func:`bcsr_attention_plain`.
    """
    if f_dst.device.type == "cpu":
        return bcsr_attention_plain(f_dst, f_src, wh, tiles, alpha, drop,
                                    precision)
    if f_dst.device.type != "cuda":
        raise ValueError(f"bcsr_attention: unsupported device {f_dst.device}")
    _check_args(f_dst, f_src, wh, tiles, drop, precision)
    walk = tiles.walk
    if walk is None:
        raise ValueError("bcsr_attention: a CUDA call needs the tiling's walk "
                         "(TiledGraph.walk, built by tile_graph, or by "
                         "attach_walk outside any CUDA-graph capture)")
    h, n_pad = f_dst.shape
    f = wh.shape[2]
    n_split = walk.stream.split_at.shape[0]
    kw = dict(dtype=torch.float32, device=wh.device)
    # the kernel's outputs, a cut tile's pieces, and its node-major copy of
    # f_src (scratch)
    out = torch.empty(h, n_pad, f, **kw)
    m = torch.empty(h, n_pad, **kw)
    den = torch.empty_like(m)
    parts = ((torch.empty(n_split, h, TILE, f, **kw),
              torch.empty(n_split, h, TILE, **kw),
              torch.empty(n_split, h, TILE, **kw)) if n_split
             else (None, None, None))
    st = walk.stream
    build.launch(bcsr_attention, f_dst, f_src, wh,
                 None if drop is None else drop.reshape(-1), walk.rows,
                 st.order, st.row_ptr, st.tile_ptr, st.split_at, tiles.n_tiles,
                 n_split, st.max_run, h, f, float(alpha), out, m, den, *parts,
                 torch.empty(n_pad, h, **kw))
    return out, m, den


def fused_gat_attention_fwd(f_dst, f_src, wh, tiles: TiledGraph, *,
                            alpha: float, drop=None,
                            precision: str = "default") -> torch.Tensor:
    """[H, N_pad, F]: the attention-softmax-weighted neighbour aggregation
    (GATv1) over ``tiles``. ``drop`` [C, EDGE_CHUNK] multiplies the
    numerators (the reference's ``drop8``, unpacked; None: no dropout).
    Launches the kernel on CUDA tensors (:func:`bcsr_attention`) and runs
    :func:`fused_gat_attention_fwd_plain` on CPU tensors."""
    return bcsr_attention(f_dst, f_src, wh, tiles, alpha, drop, precision)[0]


def fused_gat_attention_fwd_plain(f_dst, f_src, wh, tiles: TiledGraph, *,
                                  alpha: float, drop=None,
                                  precision: str = "default") -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_gat_attention_fwd`."""
    return bcsr_attention_plain(f_dst, f_src, wh, tiles, alpha, drop,
                                precision)[0]
