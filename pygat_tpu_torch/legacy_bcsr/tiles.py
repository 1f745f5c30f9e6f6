"""Host-side BCSR tiling (port of the JAX package's
``tests/legacy_bcsr/tiles.py``).

Nodes are grouped into tiles of 128 (row tiles I of receivers, column tiles
J of senders); the real edges are grouped by (I, J) tile pair, sorted by
sender inside a pair, and cut into chunks of ``EDGE_CHUNK`` slots. A slot
holds ``(recv_local, send_local, valid)``, both locals in [0, 128), and the
chunks are in row-tile-major order, so one row tile's chunks are
contiguous. The TPU kernel needs this layout to turn gathers and scatters
into one-hot matmuls; the CUDA kernel (``csrc/bcsr_attention.cu``) reads
the same layout with native gathers. The tiling is numpy on the host, field
for field the reference's; the tensors go to the graph's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.graph import Graph, host_edges

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
    empty chunks on the last row tile.
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

    return TiledGraph(
        chunk_row=dev(chunk_row),
        chunk_col=dev(chunk_col),
        chunk_last=dev(chunk_last),
        recv_local=dev(recv_l),
        send_local=dev(send_l),
        valid=dev(valid),
        edge_perm=dev(perm),
        n_tiles=n_tiles,
    )


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
