"""Static-shape padded graph container (port of ``pygat_tpu/graph.py``).

A graph is preprocessed once on the host into a padded, receiver-sorted
COO/CSR layout with a CSC view and the stream layouts of
:mod:`pygat_tpu_torch.ops.stream`, then held as torch tensors with the same
fields, dtypes and values as the reference's ``Graph``:

* ``senders[e] -> j``, ``receivers[e] -> i`` encode the edge ``j -> i``
  (``adj[i, j] != 0`` means "message j -> i"); attention normalizes over the
  incoming edges of ``i``;
* edges are sorted by ``(receiver, sender)``;
* padding edges carry weight 0 and ``edge_mask == False``; node ``N_pad - 1``
  is always a padding (dummy) node.

Beside the fields, :func:`build_graph` derives the walks of the receiver
stream and of the CSC stream for the tile-owner kernels once
(:attr:`Graph.stream_walk`, :attr:`Graph.sender_walk`). :func:`block_diag`
merges several graphs into one such graph, a block-diagonal batch of the
inductive path (:class:`GraphBatch`).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.utils.padding import LANE, pad_axis, round_up
from pygat_tpu_torch.utils.platform import resolve_device

# Host copies of the padded edge arrays, keyed by the senders tensor (id +
# weakref.finalize eviction), for plan construction that needs the edge
# structure on the host without reading it back from the device.
_HOST_EDGES: dict = {}


def _remember_host_edges(arr, value) -> None:
    key = id(arr)
    _HOST_EDGES[key] = value
    weakref.finalize(arr, _HOST_EDGES.pop, key, None)


def host_edges(graph: "Graph") -> tuple | None:
    """(senders, receivers, edge_weight, edge_mask) as host numpy arrays if
    this Graph was built by :func:`build_graph` in this process, else None."""
    return _HOST_EDGES.get(id(graph.senders))


# The walks (ops.stream.StreamWalk) of each graph's receiver stream and CSC
# stream, keyed by its r_local and c_local tensors (id + weakref.finalize
# eviction), on the graph's device: built by build_graph, carried by
# Graph.to, read through Graph.stream_walk and Graph.sender_walk. They live
# beside the graph rather than in fields, so the Graph keeps the JAX
# package's fields.
_STREAM_WALKS: dict = {}


def _remember_walk(local, walk) -> None:
    key = id(local)
    _STREAM_WALKS[key] = walk
    weakref.finalize(local, _STREAM_WALKS.pop, key, None)


class Graph(NamedTuple):
    """A padded static-shape graph of torch tensors.

    Shapes: ``E_pad = senders.shape[0]``, ``N_pad = node_mask.shape[0]``.
    """

    senders: torch.Tensor  # [E_pad] int32, source node of each edge
    receivers: torch.Tensor  # [E_pad] int32, destination node; sorted
    edge_weight: torch.Tensor  # [E_pad] f32 (0 on padding)
    edge_mask: torch.Tensor  # [E_pad] bool
    row_ptr: torch.Tensor  # [N_pad + 1] int32, CSR offsets
    node_mask: torch.Tensor  # [N_pad] bool
    n_node: torch.Tensor  # scalar int32, number of real nodes
    n_edge: torch.Tensor  # scalar int32, number of real edges
    # CSC view: col_perm[k] is the receiver-sorted edge index of the k-th
    # edge in (sender, receiver) order; col_ptr its offsets.
    col_perm: torch.Tensor | None = None  # [E_pad] int32
    col_ptr: torch.Tensor | None = None  # [N_pad + 1] int32
    # Stream layouts (ops.stream): the receiver side is physically
    # stream-aligned; the sender side carries a slot map over the CSC order.
    # None when N_pad is not 128-aligned.
    r_local: torch.Tensor | None = None  # [E_pad] int32 (128 = dead)
    r_chunk: torch.Tensor | None = None  # [E_pad / EC] int32
    c_slot: torch.Tensor | None = None  # [E_s2] int32
    c_local: torch.Tensor | None = None  # [E_s2] int32
    c_chunk: torch.Tensor | None = None  # [E_s2 / EC] int32

    @property
    def num_nodes_padded(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]

    @property
    def stream_walk(self):
        """The receiver stream's walk (:class:`~pygat_tpu_torch.ops.stream.
        StreamWalk`, on the graph's device), which the fused stream and
        window kernels read; built with the graph by :func:`build_graph`,
        None for a graph without a stream layout or built otherwise."""
        return (None if self.r_local is None
                else _STREAM_WALKS.get(id(self.r_local)))

    @property
    def sender_walk(self):
        """The CSC stream's walk (``c_local``, ``c_chunk``; on the graph's
        device), which the sender-side segment sums read; built with the
        graph by :func:`build_graph`, None otherwise. Its dummy sender's run
        holds the receiver stream's padding slots."""
        return (None if self.c_local is None
                else _STREAM_WALKS.get(id(self.c_local)))

    def to_dense(self, binary: bool = False) -> torch.Tensor:
        """Dense ``[N_pad, N_pad]`` adjacency (``adj[i, j]`` is the weight of
        edge ``j -> i``, or 1 if ``binary``; 0 on padding edges), the dense
        attention path's mask source and the reference's densification
        (utils.py:55). Set by ``index_put_`` without accumulation, as the
        JAX package's ``.at[].set``; no host sync, so a CUDA graph can
        capture it."""
        n = self.num_nodes_padded
        vals = self.edge_weight if not binary else torch.ones_like(
            self.edge_weight)
        vals = torch.where(self.edge_mask, vals, 0.0)
        dense = torch.zeros(n, n, dtype=self.edge_weight.dtype,
                            device=self.edge_weight.device)
        return dense.index_put_(
            (self.receivers.long(), self.senders.long()), vals)

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device`` (the host edge
        cache and the walks follow)."""
        g = Graph(*(None if t is None else t.to(device) for t in self))
        host = host_edges(self)
        if host is not None and g.senders is not self.senders:
            _remember_host_edges(g.senders, host)
        for local, new, walk in ((self.r_local, g.r_local, self.stream_walk),
                                 (self.c_local, g.c_local, self.sender_walk)):
            if walk is not None and new is not local:
                _remember_walk(new, walk.to(device))
        return g


class GraphBatch(NamedTuple):
    """A block-diagonal batch of graphs (the inductive PPI path).

    ``graph`` is one disconnected padded Graph (built by
    :func:`build_graph`, so it has its walks); ``graph_ids[v]`` names the
    member graph of node ``v`` (-1 on padding nodes). The reference's
    ``torch.block_diag`` collate (load_data_ppi.py:71-88), at static padded
    shapes.
    """

    graph: Graph
    graph_ids: torch.Tensor  # [N_pad] int32 on the graph's device
    n_graph: torch.Tensor  # scalar int32


def build_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_weight: np.ndarray | None,
    num_nodes: int,
    *,
    n_pad: int | None = None,
    e_pad: int | None = None,
    node_align: int = LANE,
    edge_align: int = LANE,
    node_mask: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> Graph:
    """Host-side constructor: sort, pad, CSR-ify, move to ``device`` (CUDA
    unless the caller names another device; raises without CUDA).

    ``senders[e] -> receivers[e]`` must already include any self loops the
    model expects. ``node_mask``: explicit [n_pad] real-node mask for
    non-prefix node layouts (requires ``n_pad``). An explicit ``e_pad``
    requests static-shape bucketing: the stream layout then uses the
    worst-case length bound.
    """
    device = resolve_device(device)
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if senders.shape != receivers.shape or senders.ndim != 1:
        raise ValueError("senders/receivers must be 1-D and equal length")
    num_edges = int(senders.shape[0])
    if edge_weight is None:
        edge_weight = np.ones((num_edges,), dtype=np.float32)
    edge_weight = np.asarray(edge_weight, dtype=np.float32)

    if node_mask is not None:
        if n_pad is None or node_mask.shape != (n_pad,):
            raise ValueError("explicit node_mask requires a matching n_pad")
        if node_mask[n_pad - 1]:
            raise ValueError("node_mask must leave the dummy row n_pad-1 free")
        id_limit = n_pad - 1
    else:
        id_limit = num_nodes
    if num_edges and (senders.min() < 0 or max(senders.max(), receivers.max()) >= id_limit):
        raise ValueError("edge endpoints out of range")

    # Always pad by >= 1 node so N_pad - 1 is a guaranteed dummy row.
    if n_pad is None:
        n_pad = round_up(num_nodes + 1, node_align)
    if n_pad <= num_nodes:
        raise ValueError(f"n_pad={n_pad} must exceed num_nodes={num_nodes}")
    explicit_e_pad = e_pad is not None
    if e_pad is None:
        e_pad = round_up(max(num_edges, 1), edge_align)
    if e_pad < num_edges:
        raise ValueError(f"e_pad={e_pad} < num_edges={num_edges}")

    order = np.lexsort((senders, receivers))
    senders = senders[order]
    receivers = receivers[order]
    edge_weight = edge_weight[order]

    dummy = n_pad - 1
    if node_mask is None:
        node_mask = np.zeros((n_pad,), dtype=bool)
        node_mask[:num_nodes] = True

    stream_fields: dict = {}
    if n_pad % 128 == 0:
        # Stream-aligned physical layout: padding inside tile t carries
        # receiver t*128+127 (keeps the array receiver-sorted), sender
        # dummy, weight 0, mask False.
        from pygat_tpu_torch.ops.stream import (
            EC,
            build_stream_layout,
            build_stream_walk,
            stream_length,
        )

        real_ptr = np.zeros((n_pad + 1,), dtype=np.int64)
        np.cumsum(np.bincount(receivers, minlength=n_pad), out=real_ptr[1:])
        lay = build_stream_layout(
            real_ptr,
            stream_pad=stream_length(e_pad, n_pad) if explicit_e_pad else None,
        )
        e_s = lay.slot.shape[0]
        live = lay.slot >= 0
        src = np.maximum(lay.slot, 0)
        senders_p = np.where(live, senders[src], dummy).astype(np.int32)
        receivers_p = np.where(
            live, receivers[src],
            lay.chunk_tile[np.arange(e_s) // EC].astype(np.int64) * 128 + 127,
        ).astype(np.int32)
        weight_p = np.where(live, edge_weight[src], 0.0).astype(np.float32)
        edge_mask = live
        e_pad = e_s

        c_lay = build_stream_layout(
            _csc_ptr(senders_p, n_pad),
            order=np.lexsort((receivers_p, senders_p)),
            stream_pad=stream_length(e_s, n_pad) if explicit_e_pad else None,
        )
        stream_fields = dict(
            r_local=lay.local,
            r_chunk=lay.chunk_tile,
            c_slot=np.maximum(c_lay.slot, 0).astype(np.int32),
            c_local=c_lay.local,
            c_chunk=c_lay.chunk_tile,
        )
    else:
        # legacy padding (no stream kernels): all padding in the dummy row
        senders_p = pad_axis(senders.astype(np.int32), e_pad, value=dummy)
        receivers_p = pad_axis(receivers.astype(np.int32), e_pad, value=dummy)
        weight_p = pad_axis(edge_weight, e_pad, value=0.0)
        edge_mask = np.zeros((e_pad,), dtype=bool)
        edge_mask[:num_edges] = True

    counts = np.bincount(receivers_p, minlength=n_pad)
    row_ptr = np.zeros((n_pad + 1,), dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])

    # CSC (sender-major) permutation + offsets; padding edges sort last.
    col_perm = np.lexsort((receivers_p, senders_p)).astype(np.int32)
    col_counts = np.bincount(senders_p, minlength=n_pad)
    col_ptr = np.zeros((n_pad + 1,), dtype=np.int32)
    np.cumsum(col_counts, out=col_ptr[1:])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    g = Graph(
        senders=dev(senders_p),
        receivers=dev(receivers_p),
        edge_weight=dev(weight_p),
        edge_mask=dev(edge_mask),
        row_ptr=dev(row_ptr),
        node_mask=dev(node_mask),
        n_node=torch.tensor(num_nodes, dtype=torch.int32, device=device),
        n_edge=torch.tensor(num_edges, dtype=torch.int32, device=device),
        col_perm=dev(col_perm),
        col_ptr=dev(col_ptr),
        **{k: dev(v) for k, v in stream_fields.items()},
    )
    _remember_host_edges(g.senders, (np.asarray(senders_p, np.int64),
                                     np.asarray(receivers_p, np.int64),
                                     np.asarray(weight_p, np.float32),
                                     np.asarray(edge_mask, bool)))
    if stream_fields:
        _remember_walk(g.r_local, build_stream_walk(
            lay.local, lay.chunk_tile, n_pad // 128, device))
        _remember_walk(g.c_local, build_stream_walk(
            c_lay.local, c_lay.chunk_tile, n_pad // 128, device))
    return g


def _csc_ptr(senders_p: np.ndarray, n_pad: int) -> np.ndarray:
    ptr = np.zeros((n_pad + 1,), dtype=np.int64)
    np.cumsum(np.bincount(senders_p, minlength=n_pad), out=ptr[1:])
    return ptr


def from_scipy(adj, *, n_pad: int | None = None, e_pad: int | None = None,
               device: torch.device | str | None = None) -> Graph:
    """Build from a scipy sparse matrix where ``adj[i, j] != 0`` is edge j->i
    (on ``device`` as :func:`build_graph` resolves it)."""
    coo = adj.tocoo()
    return build_graph(
        senders=coo.col,
        receivers=coo.row,
        edge_weight=coo.data,
        num_nodes=int(adj.shape[0]),
        n_pad=n_pad,
        e_pad=e_pad,
        device=device,
    )


def block_diag(
    graphs: list[tuple[np.ndarray, np.ndarray, np.ndarray | None, int]],
    *,
    n_pad: int | None = None,
    e_pad: int | None = None,
    device: torch.device | str | None = None,
) -> GraphBatch:
    """Merge ``(senders, receivers, weights, num_nodes)`` tuples into one
    disconnected padded graph with node-id offsets (a block-diagonal
    batch), on ``device`` as :func:`build_graph` resolves it."""
    device = resolve_device(device)
    all_s, all_r, all_w = [], [], []
    offsets = [0]
    for s, r, w, n in graphs:
        s = np.asarray(s)
        r = np.asarray(r)
        all_s.append(s + offsets[-1])
        all_r.append(r + offsets[-1])
        all_w.append(np.ones_like(s, dtype=np.float32) if w is None
                     else np.asarray(w, np.float32))
        offsets.append(offsets[-1] + int(n))
    num_nodes = offsets[-1]
    senders = np.concatenate(all_s) if all_s else np.zeros((0,), np.int64)
    receivers = np.concatenate(all_r) if all_r else np.zeros((0,), np.int64)
    weights = np.concatenate(all_w) if all_w else np.zeros((0,), np.float32)
    g = build_graph(senders, receivers, weights, num_nodes, n_pad=n_pad,
                    e_pad=e_pad, device=device)

    gid = np.full((g.num_nodes_padded,), -1, dtype=np.int32)
    for k in range(len(graphs)):
        gid[offsets[k]:offsets[k + 1]] = k
    return GraphBatch(
        graph=g,
        graph_ids=torch.from_numpy(gid).to(device),
        n_graph=torch.tensor(len(graphs), dtype=torch.int32, device=device),
    )
