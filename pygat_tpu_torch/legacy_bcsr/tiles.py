"""Host-side BCSR tiling (port of the JAX package's
``tests/legacy_bcsr/tiles.py``).

Nodes are grouped into tiles of 128 (row tiles I of receivers, column tiles
J of senders); the real edges are grouped by (I, J) tile pair, sorted by
sender inside a pair, and cut into chunks of ``EDGE_CHUNK`` slots. A slot
holds ``(recv_local, send_local, valid)``, both locals in [0, 128), and the
chunks are in row-tile-major order, so one row tile's chunks are
contiguous. The TPU kernel needs this layout to turn gathers and scatters
into one-hot matmuls; the CUDA kernel (``csrc/bcsr_attention.cu``) reads
the tiling's walk instead (:class:`BcsrWalk`: its valid slots re-sorted by
receiver, built on the host with the tiling and kept beside it, so the
tuple keeps the reference's fields). The tiling is numpy on the host, field
for field the reference's; the tensors go to the graph's device.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.graph import Graph, host_edges
from pygat_tpu_torch.ops.stream import DEAD, EC, StreamWalk, build_stream_walk

TILE = 128  # node tile
EDGE_CHUNK = 128  # edge slots per chunk


class TiledGraph(NamedTuple):
    """BCSR edge layout on the device; C chunks (a multiple of 8)."""

    # per-chunk metadata, int32 [C]
    chunk_row: torch.Tensor  # receiver tile index I, non-decreasing
    chunk_col: torch.Tensor  # sender tile index J
    chunk_last: torch.Tensor  # 1 iff final chunk of its row tile
    # per-slot data [C, EDGE_CHUNK]
    recv_local: torch.Tensor  # int32: receiver - I*TILE
    send_local: torch.Tensor  # int32: sender - J*TILE
    valid: torch.Tensor  # f32 1/0
    edge_perm: torch.Tensor  # int32: the graph's edge index; -1 on padding
    n_tiles: int  # number of node tiles (N_pad / TILE)

    @property
    def num_chunks(self) -> int:
        return self.chunk_row.shape[0]

    @property
    def walk(self) -> "BcsrWalk | None":
        """The walk the CUDA kernel reads (:class:`BcsrWalk`), built with
        the tiling by :func:`tile_graph` (or :func:`attach_walk`) and kept
        while its tensors live; None for a tiling built otherwise."""
        return _WALKS.get(_walk_key(self))


class BcsrWalk(NamedTuple):
    """A tiling's valid slots as the kernel ``csrc/bcsr_attention.cu``
    walks them: re-sorted by (row tile, local receiver), senders ascending
    within a receiver, and laid out as a stream of ``EC``-position chunks
    per row tile (a tile without a valid slot owns none; a tile's last
    chunk is padded with dead positions, which no run reaches).
    ``stream.order`` names the flat BCSR slot ``c * EDGE_CHUNK + j`` at
    each position (-1 dead), through which ``drop`` is read; ``rows`` the
    sender's row ``chunk_col[c] * TILE + send_local[c, j]`` (-1 dead).
    ``stream`` carries ``row_ptr``, the tile ranges (a hub's tile cut into
    ``split_at`` pieces) and ``max_run``, the largest in-degree."""

    stream: StreamWalk
    rows: torch.Tensor  # [positions] int32


# the walk of each tiling, by the ids of the tensors it was built from
_WALKS: dict = {}
_KEY_FIELDS = ("chunk_row", "chunk_col", "recv_local", "send_local", "valid")


def _walk_key(tiles: TiledGraph) -> tuple:
    return tuple(id(getattr(tiles, f)) for f in _KEY_FIELDS)


def _build_walk(chunk_row, chunk_col, recv_local, send_local, valid,
                n_tiles: int, device=None) -> BcsrWalk:
    """The :class:`BcsrWalk` of a tiling's host arrays (numpy), on
    ``device``."""
    valid = np.asarray(valid).reshape(-1) > 0
    recv_local = np.asarray(recv_local).reshape(-1)
    send_local = np.asarray(send_local).reshape(-1)
    slot = np.flatnonzero(valid)  # chunks by row tile, slots by sender
    chunk = slot // EDGE_CHUNK
    tile = np.asarray(chunk_row, np.int64)[chunk]
    order = np.argsort(tile * TILE + recv_local[slot], kind="stable")
    slot, chunk, tile = slot[order], chunk[order], tile[order]
    counts = np.bincount(tile, minlength=n_tiles)
    chunks = -(-counts // EC)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    base = np.concatenate([[0], np.cumsum(chunks)[:-1]]) * EC
    pos = base[tile] + np.arange(slot.size) - start[tile]
    n_pos = int(chunks.sum()) * EC
    at_slot = np.full(n_pos, -1, np.int64)
    at_slot[pos] = slot
    rows = np.full(n_pos, -1, np.int64)
    rows[pos] = (np.asarray(chunk_col, np.int64)[chunk] * TILE
                 + send_local[slot])
    local = np.full(n_pos, DEAD, np.int64)
    local[pos] = recv_local[slot]
    stream = build_stream_walk(local, np.repeat(np.arange(n_tiles), chunks),
                               n_tiles, device, order=at_slot)
    return BcsrWalk(stream, torch.from_numpy(rows.astype(np.int32)).to(device))


def attach_walk(tiles: TiledGraph) -> BcsrWalk:
    """Build the walk of ``tiles`` from its tensors (one read to the host)
    and keep it beside them, as :func:`tile_graph` does; returns it. Not
    inside a CUDA-graph capture."""
    walk = _build_walk(*(getattr(tiles, f).cpu().numpy() for f in _KEY_FIELDS),
                      tiles.n_tiles, tiles.chunk_row.device)
    _keep_walk(tiles, walk)
    return walk


def _keep_walk(tiles: TiledGraph, walk: BcsrWalk) -> None:
    key = _walk_key(tiles)
    _WALKS[key] = walk
    for f in _KEY_FIELDS:  # dropped when the first of them dies
        weakref.finalize(getattr(tiles, f), _WALKS.pop, key, None)


def _edges(graph: Graph):
    """(senders, receivers, edge_mask) of ``graph`` as host numpy arrays,
    from the host copy where :func:`build_graph` made the graph in this
    process, else read back from the device."""
    host = host_edges(graph)
    if host is not None:
        return host[0], host[1], host[3]
    return (graph.senders.cpu().numpy(), graph.receivers.cpu().numpy(),
            graph.edge_mask.cpu().numpy())


def tile_graph(graph: Graph, *, pad_chunks_to: int | None = None) -> TiledGraph:
    """Group the graph's real edges by 128x128 tile pairs.

    Padding edges are dropped (the kernels use ``valid``). Every row tile
    has at least one chunk, a row tile with no edge one empty chunk. The
    chunk count is padded to a multiple of 8 and to ``pad_chunks_to``, with
    empty chunks on the last row tile. The tiling's walk
    (:attr:`TiledGraph.walk`) is built here too.
    """
    all_senders, all_receivers, mask = _edges(graph)
    mask = np.asarray(mask, bool)
    orig_idx = np.flatnonzero(mask).astype(np.int64)
    senders = np.asarray(all_senders)[mask].astype(np.int64)
    receivers = np.asarray(all_receivers)[mask].astype(np.int64)

    n_pad = graph.num_nodes_padded
    if n_pad % TILE:
        raise ValueError(f"N_pad={n_pad} must be a multiple of {TILE}")
    n_tiles = n_pad // TILE

    row_t = receivers // TILE
    col_t = senders // TILE
    order = np.lexsort((senders, col_t, row_t))
    senders, receivers = senders[order], receivers[order]
    orig_idx = orig_idx[order]
    row_t, col_t = row_t[order], col_t[order]

    e = len(senders)
    if e:
        # a group is a run of equal (row_t, col_t); chunks cut each group
        pair = row_t * n_tiles + col_t
        new_group = np.empty(e, bool)
        new_group[0] = True
        np.not_equal(pair[1:], pair[:-1], out=new_group[1:])
        group_id = np.cumsum(new_group) - 1
        group_start_idx = np.flatnonzero(new_group)
        group_sizes = np.diff(np.append(group_start_idx, e))
        pos_in_group = np.arange(e) - group_start_idx[group_id]
        chunks_per_group = -(-group_sizes // EDGE_CHUNK)
        chunk_base = np.concatenate([[0], np.cumsum(chunks_per_group)[:-1]])
        edge_chunk_id = chunk_base[group_id] + pos_in_group // EDGE_CHUNK
        edge_slot = pos_in_group % EDGE_CHUNK
        c_real = int(chunks_per_group.sum())

        chunk_row = np.zeros(c_real, np.int32)
        chunk_col = np.zeros(c_real, np.int32)
        # the first edge of each chunk stamps its metadata
        first_of_chunk = np.flatnonzero(
            np.diff(np.concatenate([[-1], edge_chunk_id])) > 0)
        chunk_row[edge_chunk_id[first_of_chunk]] = row_t[first_of_chunk]
        chunk_col[edge_chunk_id[first_of_chunk]] = col_t[first_of_chunk]

        recv_l = np.zeros((c_real, EDGE_CHUNK), np.int32)
        send_l = np.zeros((c_real, EDGE_CHUNK), np.int32)
        valid = np.zeros((c_real, EDGE_CHUNK), np.float32)
        perm = np.full((c_real, EDGE_CHUNK), -1, np.int32)
        recv_l[edge_chunk_id, edge_slot] = (receivers - row_t * TILE).astype(np.int32)
        send_l[edge_chunk_id, edge_slot] = (senders - col_t * TILE).astype(np.int32)
        valid[edge_chunk_id, edge_slot] = 1.0
        perm[edge_chunk_id, edge_slot] = orig_idx.astype(np.int32)
    else:
        c_real = 0
        chunk_row = np.zeros(0, np.int32)
        chunk_col = np.zeros(0, np.int32)
        recv_l = np.zeros((0, EDGE_CHUNK), np.int32)
        send_l = np.zeros((0, EDGE_CHUNK), np.int32)
        valid = np.zeros((0, EDGE_CHUNK), np.float32)
        perm = np.full((0, EDGE_CHUNK), -1, np.int32)

    # every row tile appears at least once
    missing = np.setdiff1d(np.arange(n_tiles, dtype=np.int32),
                           np.unique(chunk_row[:c_real] if c_real else []))
    if missing.size:
        chunk_row = np.concatenate([chunk_row, missing.astype(np.int32)])
        chunk_col = np.concatenate([chunk_col, np.zeros(missing.size, np.int32)])
        recv_l = np.concatenate([recv_l, np.zeros((missing.size, EDGE_CHUNK), np.int32)])
        send_l = np.concatenate([send_l, np.zeros((missing.size, EDGE_CHUNK), np.int32)])
        valid = np.concatenate([valid, np.zeros((missing.size, EDGE_CHUNK), np.float32)])
        perm = np.concatenate([perm, np.full((missing.size, EDGE_CHUNK), -1, np.int32)])
        order2 = np.argsort(chunk_row, kind="stable")
        chunk_row, chunk_col = chunk_row[order2], chunk_col[order2]
        recv_l, send_l, valid = recv_l[order2], send_l[order2], valid[order2]
        perm = perm[order2]

    c = len(chunk_row)
    # pad to a multiple of 8 and to any requested bucket; padding chunks
    # attach to the last row tile and hold no valid slot
    target = max(pad_chunks_to or 0, -(-max(c, 1) // 8) * 8)
    if target > c:
        extra = target - c
        last_row = chunk_row[-1] if c else 0
        chunk_row = np.concatenate([chunk_row, np.full(extra, last_row, np.int32)])
        chunk_col = np.concatenate([chunk_col, np.zeros(extra, np.int32)])
        recv_l = np.concatenate([recv_l, np.zeros((extra, EDGE_CHUNK), np.int32)])
        send_l = np.concatenate([send_l, np.zeros((extra, EDGE_CHUNK), np.int32)])
        valid = np.concatenate([valid, np.zeros((extra, EDGE_CHUNK), np.float32)])
        perm = np.concatenate([perm, np.full((extra, EDGE_CHUNK), -1, np.int32)])

    chunk_last = np.zeros(len(chunk_row), np.int32)
    chunk_last[-1] = 1
    chunk_last[:-1] = (chunk_row[1:] != chunk_row[:-1]).astype(np.int32)

    device = graph.senders.device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tiles = TiledGraph(
        chunk_row=dev(chunk_row),
        chunk_col=dev(chunk_col),
        chunk_last=dev(chunk_last),
        recv_local=dev(recv_l),
        send_local=dev(send_l),
        valid=dev(valid),
        edge_perm=dev(perm),
        n_tiles=n_tiles,
    )
    _keep_walk(tiles, _build_walk(chunk_row, chunk_col, recv_l, send_l,
                                  valid, n_tiles, device))
    return tiles


def tile_stats(tiles: TiledGraph) -> dict:
    """Edge-slot utilization (1.0 = no padding waste)."""
    v = tiles.valid.cpu().numpy()
    real = float(v.sum())
    total = float(v.size)
    return {
        "chunks": int(tiles.num_chunks),
        "edge_slots": int(total),
        "real_edges": int(real),
        "utilization": real / max(total, 1.0),
    }
