"""Stream segment sum (port of ``pygat_tpu/ops/stream.py``).

Three parts:

* the host layout (``EC``, ``TILE``, ``DEAD``, ``StreamLayout``,
  ``stream_length``, ``build_stream_layout``), in numpy and identical to the
  reference's;
* :func:`stream_scatter`, the segment sum of stream-ordered edge data into
  128-row output tiles: on a CUDA tensor it launches the hand-written kernel
  ``csrc/stream_scatter.cu`` (which replaces the TPU kernel
  ``pygat_tpu/ops/stream.py::_make_kernel``; the source notes what bounds it
  and how it is laid out), on a CPU tensor it runs
  :func:`stream_scatter_plain`, the plain PyTorch version that is also the
  kernel's oracle;
* the autograd Functions :func:`stream_segment_sum` and
  :func:`stream_sender_segment_sum`, whose backward is a gather, as in the
  reference's custom VJPs.

The kernel accumulates in f32 (the reference's ``high`` contract). The
reference's ``fastest`` mode (one bf16 limb) is not ported: the ops that
take a ``precision`` check it with :func:`require_high`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.ops import build

EC = 256  # edges per chunk
TILE = 128  # output row tile
DEAD = TILE  # chunk-local row id marking a padding slot
_ALIGN = 8 * EC  # stream length granularity


class StreamLayout(NamedTuple):
    """Host-built chunking of one sorted edge order (numpy).

    ``slot[k]``: edge index occupying stream position ``k`` (-1 padding);
    ``local[k]``: output row within the chunk's 128-row tile (DEAD = drop);
    ``chunk_tile[c]``: output tile of chunk ``c`` (non-decreasing).
    """

    slot: np.ndarray  # [E_s] int64
    local: np.ndarray  # [E_s] int32
    chunk_tile: np.ndarray  # [C] int32


def stream_length(e_pad: int, n_pad: int) -> int:
    """Stream-length upper bound for ``e_pad`` edge slots over ``n_pad``
    nodes, whatever the degree distribution: each non-empty tile wastes at
    most EC-1 alignment slots and each empty tile costs one dead chunk."""
    n_tiles = n_pad // TILE
    return -(-(e_pad + n_tiles * EC) // _ALIGN) * _ALIGN


def build_stream_layout(
    ptr: np.ndarray,  # [N_pad + 1] CSR/CSC offsets over the sorted edge order
    order: np.ndarray | None = None,  # edge idx per sorted position (CSC perm)
    *,
    stream_pad: int | None = None,  # force E_s (static-shape bucketing)
) -> StreamLayout:
    """Chunk a sorted edge order so every EC-chunk writes one 128-row tile.

    Alignment padding sits only at tile boundaries (at most EC-1 dead slots
    per non-empty tile), and every tile gets at least one chunk, so every
    output row is written. ``order=None`` means the sorted order is the
    edge-array order (receiver side); the CSC side passes ``col_perm``.
    """
    ptr = np.asarray(ptr, dtype=np.int64)
    n_pad = ptr.shape[0] - 1
    if n_pad % TILE:
        raise ValueError(f"N_pad={n_pad} must be a multiple of {TILE}")
    n_tiles = n_pad // TILE
    e_pad = int(ptr[-1])

    tile_ptr = ptr[::TILE]
    if tile_ptr.shape[0] != n_tiles + 1:
        tile_ptr = np.append(tile_ptr, ptr[-1])
    tile_counts = np.diff(tile_ptr)
    chunks_per_tile = np.maximum(-(-tile_counts // EC), 1)
    c_real = int(chunks_per_tile.sum())
    e_s_real = c_real * EC
    if stream_pad is not None:
        if stream_pad % _ALIGN:
            raise ValueError(f"stream_pad must be a multiple of {_ALIGN}")
        if stream_pad < e_s_real:
            raise ValueError(f"stream_pad={stream_pad} < required {e_s_real}")
        e_s = stream_pad
    else:
        e_s = max(-(-e_s_real // _ALIGN) * _ALIGN, _ALIGN)

    slot = np.full(e_s, -1, dtype=np.int64)
    local = np.full(e_s, DEAD, dtype=np.int32)
    # trailing padding chunks carry the last tile and are all dead
    chunk_tile = np.full(e_s // EC, max(n_tiles - 1, 0), dtype=np.int32)

    # edge at sorted position p of tile t -> stream slot
    # chunk_base[t] * EC + (p - tile_ptr[t])
    chunk_base = np.concatenate([[0], np.cumsum(chunks_per_tile)[:-1]])
    pos = np.arange(e_pad, dtype=np.int64)
    t_of_pos = np.repeat(np.arange(n_tiles, dtype=np.int64), tile_counts)
    stream_pos = chunk_base[t_of_pos] * EC + (pos - tile_ptr[t_of_pos])
    slot[stream_pos] = pos if order is None else np.asarray(order, np.int64)[pos]
    row_of_pos = np.repeat(np.arange(n_pad, dtype=np.int64), np.diff(ptr))
    local[stream_pos] = (row_of_pos - t_of_pos * TILE).astype(np.int32)

    chunk_tile[:c_real] = np.repeat(
        np.arange(n_tiles, dtype=np.int32), chunks_per_tile
    )
    return StreamLayout(slot=slot, local=local, chunk_tile=chunk_tile)


def require_high(what: str, precision: str) -> None:
    """Raise unless ``precision`` is ``'high'``, the one precision the port
    has (f32 sums; the reference's two bf16 limbs, about 1e-5)."""
    if precision == "fastest":
        raise NotImplementedError(
            f"{what}: precision='fastest' (one bf16 limb) is not ported yet "
            "(ROADMAP Queue 1, item 9: the fastest precision mode); use "
            "'high'")
    if precision != "high":
        raise ValueError(f"{what}: unknown precision {precision!r}")


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------


def _check_args(data, local, chunk_tile, n_pad, slot):
    if n_pad % TILE:
        raise ValueError(f"n_pad={n_pad} must be a multiple of {TILE}")
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"data must be 2-D float32, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if local.dim() != 1 or local.shape[0] != chunk_tile.shape[0] * EC:
        raise ValueError("local must hold EC slots per chunk of chunk_tile")
    if slot is None:
        if data.shape[0] != local.shape[0]:
            raise ValueError("data must be in stream order (one row per slot)"
                             " when no slot map is given")
    elif slot.shape != local.shape:
        raise ValueError("slot and local must have the same shape")
    for name, t in (("local", local), ("chunk_tile", chunk_tile),
                    ("slot", slot)):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")


def stream_scatter_plain(
    data: torch.Tensor,
    local: torch.Tensor,
    chunk_tile: torch.Tensor,
    n_pad: int,
    *,
    slot: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_scatter` (``index_add_``).

    Dead slots add into a scratch row past the output, so the function has
    no data-dependent shape and runs without a host sync."""
    _check_args(data, local, chunk_tile, n_pad, slot)
    rows = chunk_tile.long().repeat_interleave(EC) * TILE + local.long()
    rows = torch.where(local < TILE, rows, n_pad)
    src = data if slot is None else data[slot.long()]
    out = torch.zeros(n_pad + 1, data.shape[1], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, rows, src)[:n_pad]


@build.counted
def stream_scatter(
    data: torch.Tensor,  # [E_s, L] f32 in stream order, or [E, L] with slot
    local: torch.Tensor,  # [E_s] int32 chunk-local rows (DEAD = drop)
    chunk_tile: torch.Tensor,  # [C] int32, non-decreasing
    n_pad: int,
    *,
    slot: torch.Tensor | None = None,  # [E_s] int32 data row per slot
) -> torch.Tensor:
    """Segment-sum stream-ordered ``data`` into ``[n_pad, L]`` f32.

    On a CUDA tensor this launches ``csrc/stream_scatter.cu`` (and counts
    the launch in ``stream_scatter.launches``); on a CPU tensor it runs
    :func:`stream_scatter_plain`. Not differentiable: use the autograd
    Functions below.
    """
    if data.device.type == "cpu":
        return stream_scatter_plain(data, local, chunk_tile, n_pad, slot=slot)
    if data.device.type != "cuda":
        raise ValueError(f"stream_scatter: unsupported device {data.device}")
    _check_args(data, local, chunk_tile, n_pad, slot)
    out = torch.empty(n_pad, data.shape[1], dtype=torch.float32,
                      device=data.device)
    build.launch(stream_scatter, data, slot, local, chunk_tile,
                 chunk_tile.shape[0], n_pad // TILE, data.shape[1], out)
    return out


# ---------------------------------------------------------------------------
# Differentiable wrappers (the gradient of a segment sum is a gather)
# ---------------------------------------------------------------------------


class _StreamSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, local, chunk_tile, n_pad):
        ctx.save_for_backward(segment_ids)
        return stream_scatter(data.contiguous(), local, chunk_tile, n_pad)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return g[segment_ids.long()], None, None, None, None


def stream_segment_sum(data, segment_ids, local, chunk_tile, n_pad: int):
    """Receiver-side segment sum of stream-ordered ``data`` [E_s, L].

    ``segment_ids`` (the padded receivers) are used only by the backward
    gather; the forward trusts the stream layout.
    """
    return _StreamSegmentSum.apply(data, segment_ids, local, chunk_tile, n_pad)


class _StreamSenderSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, senders, c_slot, c_local, c_chunk_tile, n_pad):
        ctx.save_for_backward(senders)
        return stream_scatter(data.contiguous(), c_local, c_chunk_tile, n_pad,
                              slot=c_slot)

    @staticmethod
    def backward(ctx, g):
        (senders,) = ctx.saved_tensors
        return g[senders.long()], None, None, None, None, None


def stream_sender_segment_sum(data, senders, c_slot, c_local, c_chunk_tile,
                              n_pad: int):
    """Per-sender segment sum of edge ``data`` [E_pad, L].

    ``c_slot`` maps sender-sorted stream positions to edge indices (clipped
    to >= 0; dead slots are killed by ``c_local == DEAD``). The kernel reads
    ``data[c_slot[k]]`` itself, so no stream-ordered copy is made. The
    gradient with respect to ``data`` is ``g[senders]``.
    """
    return _StreamSenderSegmentSum.apply(data, senders, c_slot, c_local,
                                         c_chunk_tile, n_pad)
