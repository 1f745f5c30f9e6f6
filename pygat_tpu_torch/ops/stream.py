"""Stream segment sum (port of ``pygat_tpu/ops/stream.py``).

Three parts:

* the host layout (``EC``, ``TILE``, ``DEAD``, ``StreamLayout``,
  ``stream_length``, ``build_stream_layout``), in numpy and identical to the
  reference's, and the port's own :func:`tile_ranges` (each output tile's
  chunk range, for the tile-owner kernels) and :func:`build_stream_walk`
  (a stream's walk for the tile-owner kernels: the receiver stream's and
  the CSC stream's, built with the graph, and a band plan's sender walk);
* :func:`stream_scatter`, the segment sum of stream-ordered edge data into
  128-row output tiles: on a CUDA tensor it launches the hand-written kernel
  ``csrc/stream_scatter.cu`` over the stream's walk (``walk=``; the kernel
  replaces the TPU kernel ``pygat_tpu/ops/stream.py::_make_kernel``, and
  its body ``csrc/tile_sum.cuh`` notes what bounds it and how it is laid
  out), on a CPU tensor it runs :func:`stream_scatter_plain`, the plain
  PyTorch version that is also the kernel's oracle;
* the autograd Functions :func:`stream_segment_sum` and
  :func:`stream_sender_segment_sum`, whose backward is a gather, as in the
  reference's custom VJPs.

The stream ops take the reference's two precisions (:func:`check_precision`):
``'high'`` sums the f32 data in f32 (the reference's two bf16 limbs carry
about 16 mantissa bits; the port keeps all 24), and ``'fastest'``, the
reference's one bf16 limb, rounds each value to bf16 (to nearest, ties to
even, as the reference's producer does) and sums the rounded values in
f32: on a CUDA tensor through the one-limb kernel
``csrc/stream_scatter_bf16.cu``, which reads the bf16 copy the wrapper
makes, counted by :func:`stream_scatter_bf16`. The ops whose one-limb
kernels are not ported yet (the band plan's, the corner path's, the SpMM
ops') check their ``precision`` with :func:`require_high`.
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
# the tile-owner SpMM kernels (csrc/tile_spmm.cuh): a block of SPMM_WARPS
# warps walks one output tile's chunks, warp w adding the slots of the tile
# rows r with r % SPMM_WARPS == w; a tile whose block would walk more than
# HEAVY_CHUNKS chunks, or whose busiest warp would add more than WARP_SLOTS
# live slots (a hub's), is cut into pieces walked by a block each. A piece
# of 256 slots on one warp takes about as long as an unsplit 524k tile's
# block (1,280 live slots over 8 warps). SPMM_WARPS is the kernels'
# TS_WARPS, checked when their libraries load (build.kernel).
SPMM_WARPS = 8
HEAVY_CHUNKS = 16
WARP_SLOTS = 256


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


def tile_ranges(chunk_tile: np.ndarray, local: np.ndarray,
                n_tiles: int) -> tuple[np.ndarray, np.ndarray]:
    """``(tile_ptr, split_at)`` of a chunked edge order, int32, derived on
    the host once per layout or plan from its chunk-to-tile map
    (non-decreasing) and its slots' local rows (``DEAD`` for a dead slot):
    output tile ``t`` owns the chunks ``tile_ptr[t]`` to ``tile_ptr[t + 1]
    - 1`` (an empty range if it owns none), and ``split_at`` lists, in
    order, the chunks at which the tile-owner SpMM kernels cut a tile into
    pieces: a tile of ``n`` chunks whose busiest warp has ``s`` live slots
    is cut into ``max(ceil(n / HEAVY_CHUNKS), ceil(s / WARP_SLOTS))``
    pieces of equal chunk counts (at most ``n``)."""
    chunk_tile = np.asarray(chunk_tile)
    local = np.asarray(local)
    if chunk_tile.size and (np.any(np.diff(chunk_tile) < 0)
                            or chunk_tile[0] < 0
                            or chunk_tile[-1] >= n_tiles):
        raise ValueError(f"chunk tiles must be sorted tiles in [0, {n_tiles})")
    if local.shape != (chunk_tile.shape[0] * EC,):
        raise ValueError(f"local must hold {EC} slots per chunk")
    tile_ptr = np.searchsorted(chunk_tile, np.arange(n_tiles + 1))
    counts = np.diff(tile_ptr)
    live = local < TILE
    owner = (np.repeat(chunk_tile.astype(np.int64), EC)[live] * SPMM_WARPS
             + local[live] % SPMM_WARPS)
    busiest = np.bincount(owner, minlength=n_tiles * SPMM_WARPS).reshape(
        n_tiles, SPMM_WARPS).max(axis=1)
    pieces = np.maximum(-(-counts // HEAVY_CHUNKS), -(-busiest // WARP_SLOTS))
    pieces = np.clip(pieces, 1, np.maximum(counts, 1))
    extra = pieces - 1
    tile = np.repeat(np.arange(n_tiles), extra)
    j = np.arange(extra.sum()) - np.repeat(np.cumsum(extra) - extra, extra) + 1
    split_at = tile_ptr[tile] + j * counts[tile] // pieces[tile]
    return tile_ptr.astype(np.int32), split_at.astype(np.int32)


class StreamWalk(NamedTuple):
    """An edge order as the tile-owner kernels walk it
    (``csrc/tile_fused.cuh``, ``csrc/tile_sum.cuh``): positions in which
    each output tile owns a range of whole chunks and its slots are sorted
    by output row. A stream (the receiver stream, the CSC stream) is
    tile-major and row-sorted with its padding at each tile's end, so the
    key ``t * (TILE + 1) + local`` (``DEAD`` counting as ``TILE``) never
    decreases along it, and the stream is its own walk (``order`` None):
    row ``l`` of tile ``t`` runs over positions ``row_ptr[key] ..
    row_ptr[key + 1] - 1`` with ``key = t * (TILE + 1) + l``, and key ``t *
    (TILE + 1) + TILE`` starts the tile's dead slots, which are never read.
    A band plan's walks re-sort its slots (the receiver walk,
    ``BandPlan.spmm_walk``) or lay its live slots out as a stream by sender
    (``BandPlan.sender_walk``); their ``order`` gives the plan's slot at
    each position. ``tile_ptr`` and ``split_at`` are :func:`tile_ranges`
    of the chunks up to the last one holding a live slot (the trailing
    all-dead chunks of alignment and bucketing are left out); ``max_run``
    is the most live slots of one row (its degree), past which the kernels
    cut a run into segments."""

    row_ptr: torch.Tensor  # [n_tiles * (TILE + 1) + 1] int32
    tile_ptr: torch.Tensor  # [n_tiles + 1] int32
    split_at: torch.Tensor  # [n_split] int32
    max_run: int
    order: torch.Tensor | None = None  # [positions] int32 slot by position

    def to(self, device) -> "StreamWalk":
        return self._replace(
            row_ptr=self.row_ptr.to(device),
            tile_ptr=self.tile_ptr.to(device),
            split_at=self.split_at.to(device),
            order=None if self.order is None else self.order.to(device))


def build_stream_walk(local: np.ndarray, chunk_tile: np.ndarray,
                      n_tiles: int, device=None,
                      order: np.ndarray | None = None) -> StreamWalk:
    """The :class:`StreamWalk` of a stream (its slots' local rows and its
    chunk-to-tile map, numpy; ``order``: the slot each position stands
    for, if the stream is laid out over another order's slots), built on
    the host once per graph or plan and put on ``device``."""
    local = np.asarray(local, np.int64)
    chunk_tile = np.asarray(chunk_tile, np.int64)
    key = np.repeat(chunk_tile, EC) * (TILE + 1) + np.minimum(local, TILE)
    if key.size and np.any(np.diff(key) < 0):
        raise ValueError("the stream is not tile-major and receiver-sorted")
    live = local < TILE
    n_chunks = int(np.flatnonzero(live)[-1]) // EC + 1 if live.any() else 0
    row_ptr = np.searchsorted(key, np.arange(n_tiles * (TILE + 1) + 1))
    tile_ptr, split_at = tile_ranges(chunk_tile[:n_chunks],
                                     local[:n_chunks * EC], n_tiles)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return StreamWalk(row_ptr=dev(row_ptr), tile_ptr=dev(tile_ptr),
                      split_at=dev(split_at),
                      max_run=int(np.bincount(key[live]).max(initial=0)),
                      order=None if order is None else dev(order))


def stream_walk_arg(what: str, walk: StreamWalk | None, n_pad: int,
                    on) -> StreamWalk:
    """``walk``, checked to be a walk over ``n_pad`` nodes on the device of
    the tensor ``on``; raises without one (a CUDA call needs the graph's
    :attr:`~pygat_tpu_torch.graph.Graph.stream_walk` or
    :attr:`~pygat_tpu_torch.graph.Graph.sender_walk`, or a band plan's)."""
    if walk is None:
        raise ValueError(f"{what}: a CUDA call needs the edge order's walk "
                         "(walk=graph.stream_walk or graph.sender_walk, "
                         "built with the graph)")
    n_tiles = n_pad // TILE
    if (walk.row_ptr.shape != (n_tiles * (TILE + 1) + 1,)
            or walk.tile_ptr.shape != (n_tiles + 1,)
            or walk.row_ptr.device != on.device):
        raise ValueError(f"{what}: the walk does not match the stream's "
                         f"{n_tiles} tiles on {on.device}")
    return walk


def launch_tile_sum(wrapper, data: torch.Tensor, rows, walk: StreamWalk,
                    n_pad: int) -> torch.Tensor:
    """Launch ``wrapper``'s tile-owner segment sum (``csrc/tile_sum.cuh``)
    on the current stream and count the launch: position ``k`` of ``walk``
    adds ``data[rows[k]]`` (``rows`` None: ``data[k]``) into its row.
    Returns the new [n_pad, L] sums."""
    width, n_split = data.shape[1], walk.split_at.shape[0]
    out = torch.empty(n_pad, width, dtype=torch.float32, device=data.device)
    part = (torch.empty(n_split, TILE, width, dtype=torch.float32,
                        device=data.device) if n_split else None)
    build.launch(wrapper, data, rows, walk.row_ptr, walk.tile_ptr,
                 walk.split_at, n_pad // TILE, n_split, walk.max_run, width,
                 out, part)
    return out


PRECISIONS = ("high", "fastest")


def check_precision(what: str, precision: str) -> str:
    """``precision`` if it is one of the stream ops' two, ``'high'`` (f32
    sums) or ``'fastest'`` (one bf16 limb); raises ``ValueError`` on any
    other."""
    if precision not in PRECISIONS:
        raise ValueError(f"{what}: unknown precision {precision!r} (one of "
                         f"{', '.join(map(repr, PRECISIONS))})")
    return precision


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
    f64: bool = False,
    precision: str = "high",
) -> torch.Tensor:
    """Plain PyTorch version of :func:`stream_scatter` (``index_add_``).

    Dead slots add into a scratch row past the output, so the function has
    no data-dependent shape and runs without a host sync. ``f64=True``
    sums in float64 and returns float32: the kernel's oracle, since
    ``index_add_``'s own float32 sum of a hub's row (atomics on the card,
    in an order that changes from call to call) is off by up to about 1e-5
    of it. Under ``precision='fastest'`` the data are rounded to bf16
    first, then summed in f32 (or f64)."""
    check_precision("stream_scatter", precision)
    _check_args(data, local, chunk_tile, n_pad, slot)
    rows = chunk_tile.long().repeat_interleave(EC) * TILE + local.long()
    rows = torch.where(local < TILE, rows, n_pad)
    src = data if slot is None else data[slot.long()]
    if precision == "fastest":
        src = src.to(torch.bfloat16)
    dtype = torch.float64 if f64 else torch.float32
    out = torch.zeros(n_pad + 1, data.shape[1], dtype=dtype,
                      device=data.device)
    return out.index_add_(0, rows, src.to(dtype))[:n_pad].to(torch.float32)


@build.counted
def stream_scatter(
    data: torch.Tensor,  # [E_s, L] f32 in stream order, or [E, L] with slot
    local: torch.Tensor,  # [E_s] int32 chunk-local rows (DEAD = drop)
    chunk_tile: torch.Tensor,  # [C] int32, non-decreasing
    n_pad: int,
    *,
    slot: torch.Tensor | None = None,  # [E_s] int32 data row per slot
    walk: StreamWalk | None = None,
    precision: str = "high",
) -> torch.Tensor:
    """Segment-sum stream-ordered ``data`` into ``[n_pad, L]`` f32.

    ``walk`` is the walk of the order ``local`` and ``chunk_tile`` describe:
    ``graph.stream_walk`` for the receiver stream, ``graph.sender_walk``
    for the CSC stream, a band plan's receiver walk for its banded order.
    On a CUDA tensor this launches ``csrc/stream_scatter.cu`` over the walk
    (and counts the launch in ``stream_scatter.launches``), or under
    ``precision='fastest'`` ``csrc/stream_scatter_bf16.cu`` on a bf16 copy
    of ``data`` (counted in ``stream_scatter_bf16.launches``), whose result
    is the same bit for bit from call to call, and raises without a walk;
    on a CPU tensor it runs :func:`stream_scatter_plain`. Not
    differentiable: use the autograd Functions below.
    """
    check_precision("stream_scatter", precision)
    if data.device.type == "cpu":
        return stream_scatter_plain(data, local, chunk_tile, n_pad, slot=slot,
                                    precision=precision)
    if data.device.type != "cuda":
        raise ValueError(f"stream_scatter: unsupported device {data.device}")
    _check_args(data, local, chunk_tile, n_pad, slot)
    walk = stream_walk_arg("stream_scatter", walk, n_pad, chunk_tile)
    if walk.order is not None and slot is not None:
        raise ValueError("stream_scatter: a walk with its own order takes no "
                         "slot map")
    rows = slot if walk.order is None else walk.order
    if precision == "fastest":
        return launch_tile_sum(stream_scatter_bf16, data.to(torch.bfloat16),
                               rows, walk, n_pad)
    return launch_tile_sum(stream_scatter, data, rows, walk, n_pad)


@build.counted
def stream_scatter_bf16(data, local, chunk_tile, n_pad: int, *,
                        slot: torch.Tensor | None = None,
                        walk: StreamWalk | None = None) -> torch.Tensor:
    """:func:`stream_scatter` under ``precision='fastest'``, whose launches
    of the one-limb kernel ``csrc/stream_scatter_bf16.cu`` (the TPU
    kernel's ``two_limb=False`` instantiation) this wrapper counts."""
    return stream_scatter(data, local, chunk_tile, n_pad, slot=slot,
                          walk=walk, precision="fastest")


# ---------------------------------------------------------------------------
# Differentiable wrappers (the gradient of a segment sum is a gather)
# ---------------------------------------------------------------------------


class _StreamSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, local, chunk_tile, n_pad, walk,
                precision):
        ctx.save_for_backward(segment_ids)
        return stream_scatter(data.contiguous(), local, chunk_tile, n_pad,
                              walk=walk, precision=precision)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return (g[segment_ids.long()],) + (None,) * 6


def stream_segment_sum(data, segment_ids, local, chunk_tile, n_pad: int,
                       walk: StreamWalk | None = None,
                       precision: str = "high"):
    """Receiver-side segment sum of stream-ordered ``data`` [E_s, L].

    ``segment_ids`` (the padded receivers) are used only by the backward
    gather; the forward trusts the stream layout. ``walk``
    (``graph.stream_walk``) is the kernel's, needed on CUDA tensors;
    ``precision`` as :func:`stream_scatter` (the backward, a gather, is
    exact either way).
    """
    return _StreamSegmentSum.apply(data, segment_ids, local, chunk_tile, n_pad,
                                   walk, precision)


class _StreamSenderSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, senders, c_slot, c_local, c_chunk_tile, n_pad,
                walk, precision):
        ctx.save_for_backward(senders)
        return stream_scatter(data.contiguous(), c_local, c_chunk_tile, n_pad,
                              slot=c_slot, walk=walk, precision=precision)

    @staticmethod
    def backward(ctx, g):
        (senders,) = ctx.saved_tensors
        return (g[senders.long()],) + (None,) * 7


def stream_sender_segment_sum(data, senders, c_slot, c_local, c_chunk_tile,
                              n_pad: int, walk: StreamWalk | None = None,
                              precision: str = "high"):
    """Per-sender segment sum of edge ``data`` [E_pad, L].

    ``c_slot`` maps sender-sorted stream positions to edge indices (clipped
    to >= 0; dead slots are killed by ``c_local == DEAD``). The kernel reads
    ``data[c_slot[k]]`` itself, so no stream-ordered copy is made. ``walk``
    (``graph.sender_walk``, the CSC stream's) is the kernel's, needed on
    CUDA tensors; ``precision`` as :func:`stream_scatter`. The gradient
    with respect to ``data`` is ``g[senders]``.
    """
    return _StreamSenderSegmentSum.apply(data, senders, c_slot, c_local,
                                         c_chunk_tile, n_pad, walk, precision)
