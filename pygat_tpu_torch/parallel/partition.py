"""Edge-partitioned attention with a ring exchange (port of
``pygat_tpu/parallel/partition.py``).

The nodes are cut into ``D`` contiguous shards, one a rank; a rank owns its
shard's rows and every edge into them. Remote sender rows arrive over the
ring, hop by hop, while the softmax numerator and denominator of this
shard's rows accumulate:

    bound[i] = leaky(f_dst[i] + max_j f_src[j])      # one all-reduce max
    for k in 0 .. D-1:
        take the edges whose senders live on shard (me - k) % D
        acc += their per-receiver sums of exp(logit - bound) * message
        rotate the sender table one rank on (or receive a halo buffer)

The bound is the single-device layers' monotone bound (models/layers.py),
so every hop is a plain sum: no running max, no rescaling.

Host side, :func:`partition_edges` lays each (destination shard, source
shard) block of edges out as a receiver stream over the shard's
``n_local`` rows, with a sender-sorted view for the backward and, for a
halo exchange, the sender rows each block needs; its arrays equal the JAX
package's, array for array. :func:`shard_blocks` puts one destination
shard's blocks on its rank's device, with every block's walks
(:class:`~pygat_tpu_torch.ops.stream.StreamWalk`: the receiver stream's
over ``n_local`` rows, the sender view's over ``n_local`` rows and the
halo view's over ``h_rows``), built once with the partition.

Device side, :func:`ring_gat_attention` and :func:`ring_gat_attention_v2`
are the per-rank bodies of the JAX package's ``shard_map``: this rank's
node rows in, its rows of the attention out, the sender tables received
through :mod:`~pygat_tpu_torch.parallel.collectives` (a full rotation, or
with ``halo`` a direct exchange of the rows each block references). A hop
(:func:`ring_hop_v1`, :func:`ring_hop_v2`) does no communication and takes
one of two forms: fused, one launch of kernel row 2 or 3 over the block
(:func:`~pygat_tpu_torch.ops.fused_stream.fused_v1_attention_parts`,
``..._v2_...``), or unfused, the block gathers and sums below over row 1
(``PYGAT_FUSED_ATTENTION=off``, or the ``scatter`` impl, under which the
sums are ``index_add_``). Autograd through the ring is the distributed
backward: a received buffer's gradient goes back by the opposite shift.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.graph import Graph, host_edges
from pygat_tpu_torch.models.layers import softmax_div
from pygat_tpu_torch.ops import fused_stream, segment
from pygat_tpu_torch.ops.fused_stream import (
    fused_v1_attention_parts,
    fused_v2_attention_parts,
    leaky_relu,
)
from pygat_tpu_torch.ops.stream import (
    _ALIGN,
    EC,
    TILE,
    StreamWalk,
    build_stream_layout,
    build_stream_walk,
    stream_scatter,
)
from pygat_tpu_torch.parallel import collectives as col
from pygat_tpu_torch.utils.padding import round_up


class EdgePartition(NamedTuple):
    """Ring-partitioned edge layout (numpy; the JAX package's fields).

    For destination shard d and source shard s, edges land in block
    ``[d, s, :]``: ``recv_local`` is the receiver relative to shard d's node
    range, ``send_local`` the sender relative to shard s's. When ``n_local``
    is a multiple of 128 the blocks are stream-aligned: every 256-slot chunk
    of a block writes one 128-row tile of the shard (``local``, ``chunk``;
    dead slots carry sender 0, receiver ``tile * 128 + 127`` and ``local ==
    128``), ``s_slot``/``s_local``/``s_chunk`` are a sender-sorted view of
    the block's live slots over ``n_local`` rows, and (with ``D > 1``) the
    halo fields list, for each (src, dst) pair, the sender rows the block
    references (``halo_idx[s, d]``, padded with ``n_local - 1`` to
    ``h_rows``), the block's senders in those positions (``h_send``) and a
    sender-sorted view over ``h_rows`` rows. Otherwise these are None (the
    legacy dense-packed blocks, which the port's ring does not take).
    """

    recv_local: np.ndarray  # [D, D, E_blk] int32
    send_local: np.ndarray  # [D, D, E_blk] int32
    edge_mask: np.ndarray  # [D, D, E_blk] bool
    node_mask: np.ndarray  # [D, n_local] bool
    n_shards: int
    n_local: int
    local: np.ndarray | None = None  # [D, D, E_blk] int32 (128 = dead)
    chunk: np.ndarray | None = None  # [D, D, E_blk / 256] int32
    s_slot: np.ndarray | None = None  # [D, D, E_s2] int32
    s_local: np.ndarray | None = None  # [D, D, E_s2] int32
    s_chunk: np.ndarray | None = None  # [D, D, E_s2 / 256] int32
    halo_idx: np.ndarray | None = None  # [D(src), D(dst), h_rows] int32
    h_send: np.ndarray | None = None  # [D(dst), D(src), E_blk] int32
    h_slot: np.ndarray | None = None  # [D, D, E_s2h] int32
    h_local: np.ndarray | None = None  # [D, D, E_s2h] int32
    h_chunk: np.ndarray | None = None  # [D, D, E_s2h / 256] int32
    h_rows: int = 0

    @property
    def block_edges(self) -> int:
        return self.recv_local.shape[-1]

    @property
    def has_stream(self) -> bool:
        return self.local is not None

    @property
    def has_halo(self) -> bool:
        return self.halo_idx is not None


def _edges(graph: Graph):
    host = host_edges(graph)
    if host is None:
        host = tuple(t.cpu().numpy() for t in (graph.senders, graph.receivers,
                                               graph.edge_weight,
                                               graph.edge_mask))
    send, recv, _, mask = host
    return (np.asarray(send)[mask].astype(np.int64),
            np.asarray(recv)[mask].astype(np.int64),
            graph.node_mask.cpu().numpy())


def partition_edges(graph: Graph, n_shards: int) -> EdgePartition:
    """The ring partition of ``graph``'s real edges over ``n_shards`` node
    shards (``N_pad`` must divide), built on the host; the same arrays as
    ``pygat_tpu.parallel.partition.partition_edges``."""
    n_pad = graph.num_nodes_padded
    if n_pad % n_shards:
        raise ValueError(f"N_pad={n_pad} not divisible by {n_shards} shards")
    n_local = n_pad // n_shards
    send, recv, node_mask = _edges(graph)
    dsh = recv // n_local
    ssh = send // n_local

    counts = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(counts, (dsh, ssh), 1)
    e_raw = round_up(max(int(counts.max()), 1), 8)

    order = np.lexsort((recv, ssh, dsh))
    send, recv, dsh, ssh = send[order], recv[order], dsh[order], ssh[order]
    key = dsh * n_shards + ssh
    starts = np.searchsorted(key, np.arange(n_shards * n_shards))
    pos = np.arange(len(send)) - starts[key]
    rl_all = (recv - dsh * n_local).astype(np.int32)
    sl_all = (send - ssh * n_local).astype(np.int32)
    node_mask = node_mask.reshape(n_shards, n_local)

    if n_local % TILE:
        # dense-packed blocks: padding slots fill the tail with receiver
        # n_local - 1 so per-block ids stay sorted
        recv_l = np.full((n_shards, n_shards, e_raw), n_local - 1, np.int32)
        send_l = np.zeros((n_shards, n_shards, e_raw), np.int32)
        msk = np.zeros((n_shards, n_shards, e_raw), bool)
        recv_l[dsh, ssh, pos] = rl_all
        send_l[dsh, ssh, pos] = sl_all
        msk[dsh, ssh, pos] = True
        return EdgePartition(recv_l, send_l, msk, node_mask, n_shards,
                             n_local)

    d = n_shards
    n_tiles = n_local // TILE

    def chunks_needed(local_ids: np.ndarray) -> int:
        # the exact stream length of the longest block: ceil(count / EC)
        # chunks a tile, at least one (every tile's rows are written)
        key2 = (dsh * d + ssh) * n_tiles + local_ids // TILE
        per_tile = np.bincount(key2, minlength=d * d * n_tiles)
        per_tile = per_tile.reshape(d * d, n_tiles)
        return int(np.maximum(-(-per_tile // EC), 1).sum(axis=1).max())

    e_blk = -(-chunks_needed(rl_all) * EC // _ALIGN) * _ALIGN
    e_s2 = -(-chunks_needed(sl_all) * EC // _ALIGN) * _ALIGN
    recv_l = np.zeros((d, d, e_blk), np.int32)
    send_l = np.zeros((d, d, e_blk), np.int32)
    msk = np.zeros((d, d, e_blk), bool)
    loc = np.full((d, d, e_blk), TILE, np.int32)
    chk = np.zeros((d, d, e_blk // EC), np.int32)
    s_slot = np.zeros((d, d, e_s2), np.int32)
    s_loc = np.full((d, d, e_s2), TILE, np.int32)
    s_chk = np.zeros((d, d, e_s2 // EC), np.int32)

    for di in range(d):
        for si in range(d):
            b = starts[di * d + si]
            c = int(counts[di, si])
            rl_b = rl_all[b:b + c]
            sl_b = sl_all[b:b + c]
            ptr = np.zeros(n_local + 1, np.int64)
            np.cumsum(np.bincount(rl_b, minlength=n_local), out=ptr[1:])
            lay = build_stream_layout(ptr, stream_pad=e_blk)
            live = lay.slot >= 0
            src = np.maximum(lay.slot, 0)
            # dead slots keep receivers sorted (their tile's last row)
            tile_of = lay.chunk_tile[np.arange(e_blk) // EC].astype(np.int64)
            if c:
                recv_l[di, si] = np.where(live, rl_b[src],
                                          tile_of * TILE + TILE - 1)
                send_l[di, si] = np.where(live, sl_b[src], 0)
            else:  # an empty block: all-dead chunks
                recv_l[di, si] = tile_of * TILE + TILE - 1
            msk[di, si] = live
            loc[di, si] = lay.local
            chk[di, si] = lay.chunk_tile
            # the sender-sorted view over the block's live slots
            live_idx = np.flatnonzero(live)
            sb = send_l[di, si][live_idx]
            rb = recv_l[di, si][live_idx]
            o2 = np.lexsort((rb, sb))
            ptr2 = np.zeros(n_local + 1, np.int64)
            np.cumsum(np.bincount(sb, minlength=n_local), out=ptr2[1:])
            lay2 = build_stream_layout(ptr2, order=live_idx[o2],
                                       stream_pad=e_s2)
            s_slot[di, si] = np.maximum(lay2.slot, 0).astype(np.int32)
            s_loc[di, si] = lay2.local
            s_chk[di, si] = lay2.chunk_tile

    halo_fields: dict = {}
    if d > 1:
        # the unique sender rows of each off-diagonal block, padded to one
        # 128-aligned h_rows, and each block's senders and sender view in
        # halo positions
        uniq: dict = {}
        hmax = 1
        for di in range(d):
            for si in range(d):
                if di == si:
                    continue
                b = starts[di * d + si]
                c = int(counts[di, si])
                u = np.unique(sl_all[b:b + c]) if c else np.zeros(0, np.int64)
                uniq[(di, si)] = u
                hmax = max(hmax, len(u))
        h_rows = round_up(hmax, TILE)
        h_tiles = h_rows // TILE
        max_chunks = h_tiles
        for (di, si), u in uniq.items():
            c = int(counts[di, si])
            if not c:
                continue
            b = starts[di * d + si]
            hb = np.searchsorted(u, sl_all[b:b + c])
            per_tile = np.bincount(hb // TILE, minlength=h_tiles)
            max_chunks = max(max_chunks,
                             int(np.maximum(-(-per_tile // EC), 1).sum()))
        e_s2h = -(-max_chunks * EC // _ALIGN) * _ALIGN
        halo_idx = np.full((d, d, h_rows), n_local - 1, np.int32)
        h_send = np.zeros((d, d, e_blk), np.int32)
        h_slot = np.zeros((d, d, e_s2h), np.int32)
        h_loc = np.full((d, d, e_s2h), TILE, np.int32)
        h_chk = np.zeros((d, d, e_s2h // EC), np.int32)
        dead_chk = np.minimum(np.arange(e_s2h // EC, dtype=np.int32),
                              h_tiles - 1)
        for di in range(d):
            for si in range(d):
                if di == si:
                    continue
                u = uniq[(di, si)]
                halo_idx[si, di, :len(u)] = u
                live_idx = np.flatnonzero(msk[di, si])
                if not len(live_idx):
                    h_chk[di, si] = dead_chk
                    continue
                hb = np.searchsorted(u, send_l[di, si][live_idx])
                h_send[di, si][live_idx] = hb.astype(np.int32)
                rb = recv_l[di, si][live_idx]
                o2 = np.lexsort((rb, hb))
                ptr2 = np.zeros(h_rows + 1, np.int64)
                np.cumsum(np.bincount(hb, minlength=h_rows), out=ptr2[1:])
                lay2 = build_stream_layout(ptr2, order=live_idx[o2],
                                           stream_pad=e_s2h)
                h_slot[di, si] = np.maximum(lay2.slot, 0).astype(np.int32)
                h_loc[di, si] = lay2.local
                h_chk[di, si] = lay2.chunk_tile
        halo_fields = dict(halo_idx=halo_idx, h_send=h_send, h_slot=h_slot,
                           h_local=h_loc, h_chunk=h_chk, h_rows=h_rows)

    return EdgePartition(
        recv_local=recv_l, send_local=send_l, edge_mask=msk,
        node_mask=node_mask, n_shards=n_shards, n_local=n_local, local=loc,
        chunk=chk, s_slot=s_slot, s_local=s_loc, s_chunk=s_chk,
        **halo_fields)


# ---------------------------------------------------------------------------
# One destination shard's blocks on its device
# ---------------------------------------------------------------------------


class Block(NamedTuple):
    """The fields of one hop: a (dst, src) block's receiver stream, its
    senders (positions in the sender table: a full shard's rows, or the
    halo buffer's), the sender view over that table's ``n_rows`` rows, and
    the walks of both."""

    recv: torch.Tensor  # [E_blk] int32 receiver row in the shard
    senders: torch.Tensor  # [E_blk] int32 row of the sender table
    mask: torch.Tensor  # [E_blk] bool live slots
    local: torch.Tensor  # [E_blk] int32
    chunk: torch.Tensor  # [E_blk / 256] int32
    s_slot: torch.Tensor  # sender view: block position per view slot
    s_local: torch.Tensor
    s_chunk: torch.Tensor
    n_local: int  # rows of the shard (the receiver side)
    n_rows: int  # rows of the sender table
    walk: StreamWalk  # the receiver stream's, over n_local rows
    sender_walk: StreamWalk  # the sender view's, over n_rows rows


class ShardBlocks(NamedTuple):
    """Destination shard ``dst``'s row of the partition on one device:
    ``[D(src), ...]`` tensors of its blocks, its rows of the sender tables
    to send in a halo hop (``halo_idx[d]``: the rows of this shard that
    shard ``d`` references), its real-row mask, and every block's walks
    (built on the host once, with the partition)."""

    dst: int
    n_shards: int
    n_local: int
    h_rows: int
    node_mask: torch.Tensor  # [n_local] bool
    recv_local: torch.Tensor  # [D, E_blk] int32
    send_local: torch.Tensor
    edge_mask: torch.Tensor
    local: torch.Tensor
    chunk: torch.Tensor  # [D, E_blk / 256]
    s_slot: torch.Tensor  # [D, E_s2]
    s_local: torch.Tensor
    s_chunk: torch.Tensor
    halo_idx: torch.Tensor | None  # [D(dst), h_rows] rows of THIS shard
    h_send: torch.Tensor | None  # [D, E_blk]
    h_slot: torch.Tensor | None  # [D, E_s2h]
    h_local: torch.Tensor | None
    h_chunk: torch.Tensor | None
    recv_walks: tuple  # per src shard, over n_local rows
    send_walks: tuple  # per src shard, the sender view over n_local rows
    halo_walks: tuple  # per src shard over h_rows rows (None on the diagonal)
    group: Any = None  # the ring's process group (None: every rank)

    @property
    def block_edges(self) -> int:
        return self.recv_local.shape[-1]

    @property
    def has_halo(self) -> bool:
        return self.halo_idx is not None

    def block(self, src: int, halo: bool = False) -> Block:
        """The fields of block (dst, ``src``), its senders in the full
        shard's rows or, with ``halo`` (``src != dst``), in the halo
        buffer's."""
        if halo:
            return Block(self.recv_local[src], self.h_send[src],
                         self.edge_mask[src], self.local[src],
                         self.chunk[src], self.h_slot[src],
                         self.h_local[src], self.h_chunk[src], self.n_local,
                         self.h_rows, self.recv_walks[src],
                         self.halo_walks[src])
        return Block(self.recv_local[src], self.send_local[src],
                     self.edge_mask[src], self.local[src], self.chunk[src],
                     self.s_slot[src], self.s_local[src], self.s_chunk[src],
                     self.n_local, self.n_local, self.recv_walks[src],
                     self.send_walks[src])


def shard_blocks(part: EdgePartition, dst: int, device,
                 group=None) -> ShardBlocks:
    """Shard ``dst``'s blocks of a stream-aligned ``part`` on ``device``,
    with their walks; the ring runs over ``group`` (a mesh's data group;
    None: every rank), whose rank ``dst`` holds them."""
    if not part.has_stream:
        raise ValueError("the ring needs a stream-aligned partition "
                         "(n_local a multiple of 128; see repad_citation)")
    d, n_tiles = part.n_shards, part.n_local // TILE

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    recv_walks = tuple(build_stream_walk(part.local[dst, s],
                                         part.chunk[dst, s], n_tiles, device)
                       for s in range(d))
    send_walks = tuple(build_stream_walk(part.s_local[dst, s],
                                         part.s_chunk[dst, s], n_tiles,
                                         device)
                       for s in range(d))
    halo = {}
    halo_walks = (None,) * d
    if part.has_halo:
        h_tiles = part.h_rows // TILE
        halo_walks = tuple(
            None if s == dst else build_stream_walk(
                part.h_local[dst, s], part.h_chunk[dst, s], h_tiles, device)
            for s in range(d))
        halo = dict(halo_idx=dev(part.halo_idx[dst]),
                    h_send=dev(part.h_send[dst]), h_slot=dev(part.h_slot[dst]),
                    h_local=dev(part.h_local[dst]),
                    h_chunk=dev(part.h_chunk[dst]))
    else:
        halo = dict.fromkeys(("halo_idx", "h_send", "h_slot", "h_local",
                              "h_chunk"))
    return ShardBlocks(
        dst=dst, n_shards=d, n_local=part.n_local, h_rows=part.h_rows,
        node_mask=dev(part.node_mask[dst]),
        recv_local=dev(part.recv_local[dst]),
        send_local=dev(part.send_local[dst]),
        edge_mask=dev(part.edge_mask[dst]), local=dev(part.local[dst]),
        chunk=dev(part.chunk[dst]), s_slot=dev(part.s_slot[dst]),
        s_local=dev(part.s_local[dst]), s_chunk=dev(part.s_chunk[dst]),
        recv_walks=recv_walks, send_walks=send_walks, halo_walks=halo_walks,
        group=group, **halo)


# ---------------------------------------------------------------------------
# Per-block gathers and sums (the unfused hop). Their data and cotangents on
# dead slots must be zero; the hops guarantee it by masking the numerator.
# ---------------------------------------------------------------------------


def _sum_rows(data, rows, n_rows):
    out = torch.zeros(n_rows, data.shape[1], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, rows.long(), data)


class _BlockRecvReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, blk, stream, precision):
        ctx.blk = blk
        if stream:
            return stream_scatter(data.contiguous(), blk.local, blk.chunk,
                                  blk.n_local, walk=blk.walk,
                                  precision=precision)
        return _sum_rows(data, blk.recv, blk.n_local)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.blk.recv.long()], None, None, None


def block_recv_reduce(data: torch.Tensor, blk: Block, stream: bool,
                      precision: str | None = None) -> torch.Tensor:
    """Per-receiver sum of block ``data`` [E_blk, L] into [n_local, L]:
    row 1 over the block's receiver walk with ``stream`` (at ``precision``,
    by default the stream sums' module default, as the reference's
    ``_stream_args``), else ``index_add_``. Its gradient is the gather at
    the receivers."""
    return _BlockRecvReduce.apply(data, blk, stream,
                                  segment.stream_precision(precision))


class _BlockTakeReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blk, stream):
        ctx.blk, ctx.stream = blk, stream
        ctx.precision = segment.stream_precision()
        return x[blk.recv.long()]

    @staticmethod
    def backward(ctx, g):
        return (block_recv_reduce(g, ctx.blk, ctx.stream, ctx.precision),
                None, None)


def block_take_receivers(x: torch.Tensor, blk: Block,
                         stream: bool) -> torch.Tensor:
    """``x[recv]`` whose gradient is :func:`block_recv_reduce`."""
    return _BlockTakeReceivers.apply(x, blk, stream)


class _BlockTakeSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blk, stream):
        ctx.blk, ctx.stream = blk, stream
        ctx.precision = segment.stream_precision()
        return x[blk.senders.long()]

    @staticmethod
    def backward(ctx, g):
        blk = ctx.blk
        if ctx.stream:
            dx = stream_scatter(g.contiguous(), blk.s_local, blk.s_chunk,
                                blk.n_rows, slot=blk.s_slot,
                                walk=blk.sender_walk,
                                precision=ctx.precision)
        else:
            dx = _sum_rows(g, blk.senders, blk.n_rows)
        return dx, None, None


def block_take_senders(x: torch.Tensor, blk: Block,
                       stream: bool) -> torch.Tensor:
    """``x[senders]`` (x: the sender table, [n_rows, L]) whose gradient is
    the per-sender sum: row 1 over the block's sender view with
    ``stream``, else ``index_add_``."""
    return _BlockTakeSenders.apply(x, blk, stream)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


def hop_forms() -> tuple[bool, bool]:
    """(fused, stream) of the hops under the current switches: fused unless
    ``PYGAT_FUSED_ATTENTION`` is ``off`` (or ``auto`` under the ``scatter``
    / ``scan`` impl), the block sums on row 1 under the stream impls."""
    stream = segment.stream_enabled()
    mode = fused_stream._fused_mode()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused-attention mode {mode!r} "
                         "(PYGAT_FUSED_ATTENTION)")
    return (stream if mode == "auto" else mode == "on"), stream


def _keep(keep, src, e, h, device):
    """Hop ``src``'s keep factors [E_blk, H] (ones without dropout)."""
    if keep is None:
        return torch.ones(e, h, dtype=torch.float32, device=device)
    return keep[src]


def ring_hop_v1(acc, w_buf, k: int, blocks: ShardBlocks, f_dst, bound,
                a_src, keep=None, *, alpha: float, halo: bool = False):
    """``acc`` [n_local, HF + H] plus hop ``k``'s GATv1 sums (the edges
    from shard ``(dst - k) % D``), with ``w_buf`` that shard's rows of the
    projected features (``halo``: its halo buffer for this shard).
    ``f_dst``/``bound`` [n_local, H] are this shard's, ``keep`` [D, E_blk,
    H] the attention keep factors or None. No communication."""
    src = (blocks.dst - k) % blocks.n_shards
    blk = blocks.block(src, halo and src != blocks.dst)
    h, f = a_src.shape
    hf = h * f
    keep_k = _keep(keep, src, blk.recv.shape[0], h, w_buf.device)
    fused, stream = hop_forms()
    if fused:
        agg, den = fused_v1_attention_parts(
            f_dst, bound, w_buf, a_src, keep_k, blk.senders, blk.recv,
            blk.local, blk.chunk, blk.s_slot, blk.s_local, blk.s_chunk,
            alpha, blk.walk, blk.sender_walk, segment.stream_precision())
        return acc + torch.cat([agg, den], dim=1)
    w_g = block_take_senders(w_buf, blk, stream)  # [E, HF]
    l_src = (w_g.view(-1, h, f) * a_src).sum(-1)
    fb_e = block_take_receivers(torch.cat([f_dst, bound], dim=1), blk,
                                stream)  # [E, 2H]
    logits = leaky_relu(fb_e[:, :h] + l_src, alpha)
    num = torch.where(blk.mask[:, None], torch.exp(logits - fb_e[:, h:]),
                      0.0)
    msgs = torch.cat([(w_g.view(-1, h, f)
                       * (num * keep_k)[:, :, None]).reshape(-1, hf), num],
                     dim=1)
    return acc + block_recv_reduce(msgs, blk, stream)


def ring_hop_v2(acc, wi_buf, wj_buf, k: int, blocks: ShardBlocks, wi_local,
                ub, a, keep=None, *, alpha: float, halo: bool = False):
    """``acc`` plus hop ``k``'s GATv2 sums, as :func:`ring_hop_v1`, with the
    sender tables ``wi_buf`` (messages) and ``wj_buf`` (logits) and this
    shard's ``wi_local`` [n_local, HF] and ``ub`` [n_local, H]."""
    src = (blocks.dst - k) % blocks.n_shards
    blk = blocks.block(src, halo and src != blocks.dst)
    h, f = a.shape
    hf = h * f
    keep_k = _keep(keep, src, blk.recv.shape[0], h, wi_buf.device)
    fused, stream = hop_forms()
    if fused:
        agg, den = fused_v2_attention_parts(
            wi_local, ub, wi_buf, wj_buf, a, keep_k, blk.senders, blk.recv,
            blk.local, blk.chunk, blk.s_slot, blk.s_local, blk.s_chunk,
            alpha, blk.walk, blk.sender_walk, segment.stream_precision())
        return acc + torch.cat([agg, den], dim=1)
    wj_g = block_take_senders(wj_buf, blk, stream)
    wiub_e = block_take_receivers(torch.cat([wi_local, ub], dim=1), blk,
                                  stream)  # [E, HF + H]
    pre = leaky_relu(wiub_e[:, :hf] + wj_g, alpha)
    logits = (pre.view(-1, h, f) * a).sum(-1)
    num = torch.where(blk.mask[:, None], torch.exp(logits - wiub_e[:, hf:]),
                      0.0)
    wi_g = block_take_senders(wi_buf, blk, stream)
    msgs = torch.cat([(wi_g.view(-1, h, f)
                       * (num * keep_k)[:, :, None]).reshape(-1, hf), num],
                     dim=1)
    return acc + block_recv_reduce(msgs, blk, stream)


def _check_group(blocks: ShardBlocks) -> None:
    size, me = col.axis_size(blocks.group), col.axis_index(blocks.group)
    if size != blocks.n_shards or me != blocks.dst:
        raise ValueError(f"blocks of shard {blocks.dst} of {blocks.n_shards} "
                         f"on rank {me} of the ring's {size}")


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def ring_gat_attention(f_dst, whf, a_src, blocks: ShardBlocks, *,
                       alpha: float, att_keep=None,
                       halo: bool = False) -> torch.Tensor:
    """This rank's [n_local, HF] rows of the sparse GATv1 attention, the
    per-rank body of the JAX ``ring_gat_attention``: ``f_dst`` [n_local,
    H] and ``whf`` [n_local, HF] are this shard's rows, ``a_src`` [H, F]
    the sender halves of the attention vectors, ``att_keep`` [D, E_blk, H]
    keep factors of the attention dropout (numerator only) or None.
    ``halo``: the direct halo exchange by shift ``k`` in hop ``k``, else
    the full rotation by one rank a hop. Every rank of the group calls it
    with its own ``blocks``."""
    _check_group(blocks)
    d, me = blocks.n_shards, blocks.dst
    n, h = f_dst.shape
    hf = whf.shape[1]
    f = hf // h
    with torch.no_grad():
        # the bound from the global sender-term max over real rows:
        # exp(logit - bound) <= 1, an exact softmax shift
        f_src = (whf.view(n, h, f) * a_src).sum(-1)
        m_loc = torch.where(blocks.node_mask[:, None], f_src,
                            float("-inf")).amax(dim=0)
        m_src = _finite_or_zero(col.all_reduce_max(m_loc, blocks.group))
        bound = leaky_relu(f_dst + m_src, alpha)
    acc = ring_hop_v1(torch.zeros(n, hf + h, device=whf.device), whf, 0,
                      blocks, f_dst, bound, a_src, att_keep, alpha=alpha)
    if halo and blocks.has_halo and d > 1:
        for k in range(1, d):
            # the rows of mine that shard me + k references, sent by k
            buf = whf[blocks.halo_idx[(me + k) % d].long()]
            buf = col.ppermute_ring(buf, k, blocks.group)
            acc = ring_hop_v1(acc, buf, k, blocks, f_dst, bound, a_src,
                              att_keep, alpha=alpha, halo=True)
    else:
        w_buf = whf
        for k in range(1, d):
            w_buf = col.ppermute_ring(w_buf, 1, blocks.group)
            acc = ring_hop_v1(acc, w_buf, k, blocks, f_dst, bound, a_src,
                              att_keep, alpha=alpha)
    out = softmax_div(acc[:, :hf].reshape(n, h, f), acc[:, hf:])
    return out.reshape(n, hf)


def ring_gat_attention_v2(whi, whj, a, blocks: ShardBlocks, *, alpha: float,
                          att_keep=None, halo: bool = False) -> torch.Tensor:
    """This rank's [n_local, HF] rows of the sparse GATv2 attention, the
    per-rank body of the JAX ``ring_gat_attention_v2``: ``whi`` (receiver
    logit term and messages) and ``whj`` (sender logit term) [n_local, HF]
    of this shard, ``a`` [H, F]; both tables travel (in one buffer of 2 HF
    columns in a halo hop). The sign-split bound needs one all-reduce max
    and one min of ``whj`` per (head, feature)."""
    _check_group(blocks)
    d, me = blocks.n_shards, blocks.dst
    h, f = a.shape
    n, hf = whi.shape
    with torch.no_grad():
        nm = blocks.node_mask[:, None]
        big = float("inf")
        mq_max = _finite_or_zero(col.all_reduce_max(
            torch.where(nm, whj, -big).amax(dim=0), blocks.group)).view(h, f)
        mq_min = _finite_or_zero(col.all_reduce_min(
            torch.where(nm, whj, big).amin(dim=0), blocks.group)).view(h, f)
        wi3 = whi.view(n, h, f)
        ub = (leaky_relu(wi3 + mq_max, alpha) * a.clamp(min=0.0)).sum(-1)
        ub = ub + (leaky_relu(wi3 + mq_min, alpha) * a.clamp(max=0.0)).sum(-1)
    acc = ring_hop_v2(torch.zeros(n, hf + h, device=whi.device), whi, whj, 0,
                      blocks, whi, ub, a, att_keep, alpha=alpha)
    if halo and blocks.has_halo and d > 1:
        wiwj = torch.cat([whi, whj], dim=1)
        for k in range(1, d):
            buf = col.ppermute_ring(
                wiwj[blocks.halo_idx[(me + k) % d].long()], k, blocks.group)
            acc = ring_hop_v2(acc, buf[:, :hf], buf[:, hf:], k, blocks, whi,
                              ub, a, att_keep, alpha=alpha, halo=True)
    else:
        wi_buf, wj_buf = whi, whj
        for k in range(1, d):
            wi_buf = col.ppermute_ring(wi_buf, 1, blocks.group)
            wj_buf = col.ppermute_ring(wj_buf, 1, blocks.group)
            acc = ring_hop_v2(acc, wi_buf, wj_buf, k, blocks, whi, ub, a,
                              att_keep, alpha=alpha)
    out = softmax_div(acc[:, :hf].reshape(n, h, f), acc[:, hf:])
    return out.reshape(n, hf)
