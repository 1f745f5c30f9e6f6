"""Fused sparse attention forward over the BCSR tiling (port of the JAX
package's ``tests/legacy_bcsr/fused_attention.py``).

One op replaces the whole sparse GATv1 attention pipeline (per-edge
logits, the segment max, exp, the two aggregations, the division), for all
heads:

    l[e, h]      = leaky_relu(f_dst[h, recv_e] + f_src[h, send_e])
    num[e, h]    = exp(l[e, h] - max of l over recv_e's edges)
    out[h, i, :] = sum_e num[e, h] * drop[e] * wh[h, send_e, :] / sum_e num[e, h]

On CUDA tensors :func:`bcsr_attention` launches the hand-written kernel
``csrc/bcsr_attention.cu``, which replaces the TPU kernel ``_make_kernel``
(the source says how and what bounds it); on CPU tensors it runs
:func:`bcsr_attention_plain`, the plain PyTorch version over the flat
slots, which is also the kernel's oracle. Both also return the per-(head,
receiver) max and denominator, which the analytic backward of
:mod:`.sparse_attention` reuses.

``precision`` takes the reference's ``"default"`` and ``"highest"``, and
both compute in f32. The TPU's ``"default"`` is bf16-class (its one-hot
matmuls at the MXU's default precision); the port has no such mode here.
"""

from __future__ import annotations

import weakref

import numpy as np
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


# chunk offsets of each row tile, by id of the TiledGraph's chunk_row
_TILE_PTR: dict = {}


def tile_ptr(tiles: TiledGraph) -> torch.Tensor:
    """[n_tiles + 1] int32 on the tiles' device: row tile I owns chunks
    ``tile_ptr[I]`` to ``tile_ptr[I + 1]``. Derived on the host once per
    TiledGraph (chunk_row is sorted) and kept while its chunk_row lives."""
    key = id(tiles.chunk_row)
    ptr = _TILE_PTR.get(key)
    if ptr is None:
        rows = tiles.chunk_row.cpu().numpy()
        if rows.size and (np.any(np.diff(rows) < 0) or rows[0] < 0
                          or rows[-1] >= tiles.n_tiles):
            raise ValueError("chunk_row must be sorted row tiles in "
                             f"[0, {tiles.n_tiles})")
        host = np.searchsorted(rows, np.arange(tiles.n_tiles + 1), "left")
        ptr = torch.from_numpy(host.astype(np.int32)).to(tiles.chunk_row.device)
        _TILE_PTR[key] = ptr
        weakref.finalize(tiles.chunk_row, _TILE_PTR.pop, key, None)
    return ptr


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
                         drop=None, precision: str = "default"):
    """Plain PyTorch version of :func:`bcsr_attention` over the flat slots:
    a gather, the segment max (``scatter_reduce``), exp, and two
    ``index_add_`` calls. Invalid slots go to a scratch row past the
    outputs, so nothing depends on the data's shape and nothing syncs."""
    _check_args(f_dst, f_src, wh, tiles, drop, precision)
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
    return out, torch.where(has, m, 0.0), den


@build.counted
def bcsr_attention(f_dst, f_src, wh, tiles: TiledGraph, alpha: float,
                   drop=None, precision: str = "default"):
    """(out [H, N_pad, F], m [H, N_pad], den [H, N_pad]) of the fused
    attention over ``tiles``: ``m`` is each receiver's max logit and
    ``den`` its softmax denominator (both 0 for a receiver with no valid
    slot, whose ``out`` row is 0).

    f_dst / f_src [H, N_pad], wh [H, N_pad, F] float32; ``drop`` [C,
    EDGE_CHUNK] the numerators' keep factors per slot, or None. On a CUDA
    tensor this launches ``csrc/bcsr_attention.cu`` (counted in
    ``bcsr_attention.launches``); on a CPU tensor it runs
    :func:`bcsr_attention_plain`.
    """
    if f_dst.device.type == "cpu":
        return bcsr_attention_plain(f_dst, f_src, wh, tiles, alpha, drop,
                                    precision)
    if f_dst.device.type != "cuda":
        raise ValueError(f"bcsr_attention: unsupported device {f_dst.device}")
    _check_args(f_dst, f_src, wh, tiles, drop, precision)
    h, n_pad = f_dst.shape
    f = wh.shape[2]
    out = torch.empty(h, n_pad, f, dtype=torch.float32, device=wh.device)
    m = torch.empty(h, n_pad, dtype=torch.float32, device=wh.device)
    den = torch.empty_like(m)
    build.launch(bcsr_attention, f_dst, f_src, wh, tiles.chunk_col,
                 tiles.recv_local, tiles.send_local, tiles.valid, drop,
                 tile_ptr(tiles), tiles.n_tiles, h, f, float(alpha), out, m,
                 den)
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
