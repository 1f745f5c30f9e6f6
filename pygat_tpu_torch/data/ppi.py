"""Inductive PPI pipeline: multi-graph loading, static-shape batching and
the device-resident graph bank (port of ``pygat_tpu/data/ppi.py``).

Mirrors the reference loader (load_data_ppi.py:90-192): per split, node
features ``{split}_feats.npy`` [NS, 50], multi-labels ``{split}_labels.npy``
[NS, 121], node-link JSON topology, and ``{split}_graph_id.npy`` slicing the
collection into individual graphs (20 train / 2 val / 2 test); each graph
gets self-loops + D^-1/2(A+I)D^-1/2 (load_data_ppi.py:151).

Missing files are regenerated deterministically at the real sizes, by the
same generators as the JAX package, so both packages load the same arrays:
topology as planted-partition graphs at the per-graph sizes of the
``graph_id`` files, labels from one global random hyperplane rule over
(features + neighbour mean). There is no download: ``load_ppi`` reads the
files from a search root that has them (``data_root``, ``$PYGAT_DATA``, the
working directory) and builds the stand-ins otherwise, as the JAX loader
does with its download gate off.

Two ways to batch, both block-diagonal at one static shape:

* :func:`make_batches` merges each batch's graphs on the host
  (:func:`~pygat_tpu_torch.graph.block_diag`, whose ``build_graph`` also
  builds the batch's two walks) and moves it to the device, every epoch;
* :func:`build_bank` pads every graph alone to one per-graph bound once and
  keeps the stacked fields, and each graph's two walks, on the device;
  :func:`assemble_banked_batch` then collates a batch there by offset
  arithmetic, walks included, from member indices the host already holds.
"""

from __future__ import annotations

import json
import sys
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from pygat_tpu_torch.data.citation import _find, _search_roots
from pygat_tpu_torch.data.preprocess import normalize_adj
from pygat_tpu_torch.data.synthetic import _rng, planted_partition_graph
from pygat_tpu_torch.graph import (
    Graph,
    GraphBatch,
    _remember_walk,
    block_diag,
    build_graph,
)
from pygat_tpu_torch.models.presets import (
    PPI_NUM_CLASSES,
    PPI_NUM_INPUT_FEATURES,
)
from pygat_tpu_torch.ops.stream import EC, TILE, StreamWalk, tile_ranges
from pygat_tpu_torch.utils.padding import pad_axis, round_up
from pygat_tpu_torch.utils.platform import resolve_device

SPLITS = ("train", "valid", "test")
# Real per-graph node counts (from {split}_graph_id.npy), used when the id
# files themselves are missing.
_FALLBACK_SIZES = {
    "train": [1767, 1377, 2263, 2339, 1578, 1021, 1823, 2488, 591, 3312,
              2401, 1878, 1819, 3480, 2794, 2326, 2650, 2815, 3163, 3021],
    "valid": [3230, 3284],
    "test": [3224, 2300],
}
_SYNTH_DEGREE = 14.0  # average degree for synthetic topology


class PPIGraph(NamedTuple):
    """One host-side PPI graph (pre-padding)."""

    features: np.ndarray  # [N, 50] float32
    labels: np.ndarray  # [N, 121] float32
    senders: np.ndarray  # directed COO incl. both directions + self loops
    receivers: np.ndarray
    weights: np.ndarray  # normalized adjacency values
    num_nodes: int


def _warn(part: str) -> None:
    print(
        f"[pygat_tpu_torch.data] ppi: '{part}' not found (stripped blob?) — "
        "using deterministic synthetic stand-in",
        file=sys.stderr,
    )


def _synth_labels(features: np.ndarray, senders, receivers, n: int) -> np.ndarray:
    """Global hyperplane rule on neighbor-smoothed features: the same
    projection R for every split, so train graphs predict val/test."""
    rng = _rng("ppi:labelrule", PPI_NUM_INPUT_FEATURES, PPI_NUM_CLASSES)
    R = rng.standard_normal((PPI_NUM_INPUT_FEATURES, PPI_NUM_CLASSES)).astype(np.float32)
    bias = rng.standard_normal(PPI_NUM_CLASSES).astype(np.float32) * 0.5
    deg = np.zeros(n, np.float32)
    np.add.at(deg, receivers, 1.0)
    smooth = np.zeros_like(features)
    np.add.at(smooth, receivers, features[senders])
    smooth = smooth / np.maximum(deg, 1.0)[:, None]
    z = 0.5 * (features + smooth)
    z = (z - z.mean(0)) / (z.std(0) + 1e-6)
    return (z @ R + bias > 0.8).astype(np.float32)


def _load_split(split: str, roots: list[str]) -> tuple[list[PPIGraph], list[str]]:
    synth: list[str] = []
    gid_path = _find(f"data/ppi/{split}_graph_id.npy", roots)
    if gid_path is not None:
        graph_ids = np.load(gid_path)
    else:
        _warn(f"{split}_graph_id.npy")
        synth.append(f"{split}_graph_id")
        sizes = _FALLBACK_SIZES[split]
        graph_ids = np.repeat(np.arange(len(sizes)), sizes)
    n_total = graph_ids.shape[0]

    feats_path = _find(f"data/ppi/{split}_feats.npy", roots)
    if feats_path is not None:
        feats_all = np.load(feats_path).astype(np.float32)
    else:
        _warn(f"{split}_feats.npy")
        synth.append(f"{split}_feats")
        rng = _rng(f"ppi:{split}:feats", n_total)
        # match the real features' rough scale (mostly small positive values)
        feats_all = np.abs(rng.standard_normal((n_total, PPI_NUM_INPUT_FEATURES))).astype(
            np.float32
        ) * (rng.random((n_total, PPI_NUM_INPUT_FEATURES)) < 0.3)

    topo_path = _find(f"data/ppi/{split}_graph.json", roots)
    topo = None
    if topo_path is not None:
        with open(topo_path) as f:
            topo = json.load(f)
    else:
        _warn(f"{split}_graph.json")
        synth.append(f"{split}_graph")

    labels_path = _find(f"data/ppi/{split}_labels.npy", roots)
    labels_all = None
    if labels_path is not None:
        labels_all = np.load(labels_path).astype(np.float32)
    else:
        _warn(f"{split}_labels.npy")
        synth.append(f"{split}_labels")

    graphs: list[PPIGraph] = []
    for gid in np.unique(graph_ids):
        mask = graph_ids == gid
        node_ids = np.nonzero(mask)[0]
        n = node_ids.shape[0]
        feats = feats_all[mask]

        if topo is not None:
            # node-link JSON: edges among this graph's global node ids
            remap = {int(g): i for i, g in enumerate(node_ids)}
            src, dst = [], []
            for link in topo["links"]:
                s, t = int(link["source"]), int(link["target"])
                if s in remap and t in remap:
                    src.append(remap[s])
                    dst.append(remap[t])
            senders = np.asarray(src + dst, dtype=np.int64)
            receivers = np.asarray(dst + src, dtype=np.int64)
        else:
            senders, receivers, _ = planted_partition_graph(
                n, 8, f"ppi:{split}:{int(gid)}", avg_degree=_SYNTH_DEGREE
            )

        # dedupe + self loops + normalize, reference load_data_ppi.py:149-151
        adj = sp.coo_matrix(
            (np.ones(len(senders), np.float32), (receivers, senders)), shape=(n, n)
        ).tocsr()
        adj.data[:] = 1.0  # DiGraph semantics: multi-edges collapse
        adj_norm = normalize_adj(adj + sp.eye(n, dtype=np.float32, format="csr")).tocoo()
        assert abs(adj_norm - adj_norm.T).max() < 1e-6  # load_data_ppi.py:157

        if labels_all is not None:
            labels = labels_all[mask]
        else:
            labels = _synth_labels(feats, adj_norm.col, adj_norm.row, n)

        graphs.append(
            PPIGraph(
                features=feats,
                labels=labels,
                senders=adj_norm.col.astype(np.int64),
                receivers=adj_norm.row.astype(np.int64),
                weights=adj_norm.data.astype(np.float32),
                num_nodes=n,
            )
        )
    return graphs, synth


class PPIData(NamedTuple):
    train: list[PPIGraph]
    valid: list[PPIGraph]
    test: list[PPIGraph]
    synthetic_parts: tuple[str, ...]


def load_ppi(data_root: str | None = None) -> PPIData:
    """The three splits as host graphs: read from the first search root
    that has each file, else the deterministic stand-ins (recorded in
    ``synthetic_parts``). Nothing is downloaded."""
    roots = _search_roots(data_root)
    out = {}
    synth: list[str] = []
    for split in SPLITS:
        graphs, s = _load_split(split, roots)
        out[split] = graphs
        synth += s
    return PPIData(out["train"], out["valid"], out["test"], tuple(synth))


def ppi_config(layer_type: str):
    """The PPI preset (``models.presets.PRESETS["ppi"]``) as the trainers
    run it: its input width padded to the 128 feature columns that
    :func:`make_batches` and :func:`build_bank` give the features."""
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.models.presets import PRESETS

    cfg = GATConfig(layer_type=layer_type, **PRESETS["ppi"])
    return cfg._replace(nfeats=(round_up(cfg.nfeats[0]),) + cfg.nfeats[1:])


class PaddedBatch(NamedTuple):
    features: torch.Tensor  # [N_pad, F_pad]
    labels: torch.Tensor  # [N_pad, C]
    batch: GraphBatch


def batch_bounds(graphs: list[PPIGraph], batch_size: int) -> tuple[int, int]:
    """Worst-case (N_pad, E_pad) over any batch_size-subset: the sum of the
    largest batch_size graphs (shuffling makes any combination possible)."""
    ns = sorted((g.num_nodes for g in graphs), reverse=True)[:batch_size]
    es = sorted((len(g.senders) for g in graphs), reverse=True)[:batch_size]
    return round_up(sum(ns) + 1), round_up(max(sum(es), 1))


def make_batches(
    graphs: list[PPIGraph],
    batch_size: int,
    *,
    n_pad: int,
    e_pad: int,
    shuffle: bool = False,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> Iterator[PaddedBatch]:
    """Block-diagonal batches at ONE static shape (reference collate
    load_data_ppi.py:71-88, shuffle semantics load_data_ppi.py:168-190),
    each built on the host (its graph's walks included) and moved to
    ``device`` (CUDA unless the caller names another device)."""
    device = resolve_device(device)
    order = np.arange(len(graphs))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    f_pad = round_up(PPI_NUM_INPUT_FEATURES)
    for start in range(0, len(graphs), batch_size):
        members = [graphs[i] for i in order[start : start + batch_size]]
        gb = block_diag(
            [(g.senders, g.receivers, g.weights, g.num_nodes) for g in members],
            n_pad=n_pad,
            e_pad=e_pad,
            device=device,
        )
        feats = np.concatenate([g.features for g in members], axis=0)
        labels = np.concatenate([g.labels for g in members], axis=0)
        feats = pad_axis(pad_axis(feats, n_pad, axis=0), f_pad, axis=1)
        labels = pad_axis(labels, n_pad, axis=0)
        yield PaddedBatch(
            features=torch.from_numpy(feats).to(device),
            labels=torch.from_numpy(labels).to(device),
            batch=gb,
        )


# ---------------------------------------------------------------------------
# Device-resident graph bank.
#
# make_batches rebuilds every block-diagonal batch, its stream layouts and
# its walks in numpy each epoch. The bank instead pads EVERY graph to one
# per-graph bound (N_pg, E_pg) ONCE, stacks the padded Graph fields [G, ...]
# on the device, and assembles a batch there: a gather over the graph axis
# plus per-block offset arithmetic.
#
# Why the stream layouts survive concatenation: per-graph edge arrays are
# receiver-sorted and chunk-aligned (E_s is a multiple of 8*EC, N_pg of
# 128), so stacking B blocks keeps global receiver-sortedness and chunk
# alignment; the only fix-ups are +k*N_pg on node ids, +k*E_s on edge
# indices and +k*(N_pg/128) on chunk tile ids.
#
# The walks survive it too (ops.stream.StreamWalk, one per stream side). A
# walk's row_ptr names the first position of each (tile, local row) key, so
# member k's entries move by +k*E_s (the side's stream length) and the
# batch's last entry is B*E_s. Its tile_ptr and split_at are the tile
# ranges of the chunks up to the LAST live chunk of the whole stream: a
# member followed by another keeps all its chunks, trailing all-dead ones
# included (they sit between its last live chunk and the next member's
# first), while the batch's last member is cut at its own last live chunk,
# as its own walk is. So the bank keeps both ranges of every graph, the
# ranges over all its chunks and its own walk's; their chunk ids move by
# +k*C (the side's chunks per graph). A dead member (a padding slot of the
# batch) keeps its walk: its rows drop out of the losses through the masks.
# ---------------------------------------------------------------------------


class BankWalks(NamedTuple):
    """One stream side's walks of every graph of a bank: the stacked
    ``row_ptr`` and the two tile ranges (over all of a graph's chunks,
    ``tile_ptr`` / ``split_at``; up to its last live chunk, ``*_last``),
    ``split_at`` flat with host offsets (a graph's pieces vary in number),
    and each graph's ``max_run`` on the host, so that assembling a batch's
    walk reads nothing back from the device."""

    row_ptr: torch.Tensor  # [G, n_tiles * (TILE + 1) + 1] int32
    tile_ptr: torch.Tensor  # [G, n_tiles + 1] int32, all chunks
    tile_ptr_last: torch.Tensor  # [G, n_tiles + 1] int32, the graph's walk's
    split_at: torch.Tensor  # flat int32, graph g at split_off[g]:split_off[g+1]
    split_off: np.ndarray  # [G + 1] int64
    split_at_last: torch.Tensor  # flat int32, by split_last_off
    split_last_off: np.ndarray  # [G + 1] int64
    max_run: np.ndarray  # [G] int64


def _bank_walks(walks: list[StreamWalk], locals_: list[np.ndarray],
                chunks: list[np.ndarray], n_tiles: int,
                device: torch.device) -> BankWalks:
    """Stack the graphs' own walks (built by ``build_graph``) and add each
    graph's tile ranges over all its chunks, from its host fields."""
    full = [tile_ranges(c, loc, n_tiles) for loc, c in zip(locals_, chunks)]

    def flat(parts):
        off = np.zeros(len(parts) + 1, np.int64)
        np.cumsum([len(p) for p in parts], out=off[1:])
        cat = (np.concatenate(parts) if parts else np.zeros(0)).astype(np.int32)
        return torch.from_numpy(cat).to(device), off

    split_at, split_off = flat([sa for _, sa in full])
    split_last, split_last_off = flat([w.split_at.cpu().numpy() for w in walks])
    return BankWalks(
        row_ptr=torch.stack([w.row_ptr for w in walks]).to(device),
        tile_ptr=torch.from_numpy(np.stack([tp for tp, _ in full])).to(device),
        tile_ptr_last=torch.stack([w.tile_ptr for w in walks]).to(device),
        split_at=split_at,
        split_off=split_off,
        split_at_last=split_last,
        split_last_off=split_last_off,
        max_run=np.asarray([w.max_run for w in walks], np.int64),
    )


def _assemble_walk(bw: BankWalks, idx: list[int], stream_len: int,
                   n_chunks: int) -> StreamWalk:
    """The walk of a batch of members ``idx`` (host ints) laid end to end,
    equal to ``build_stream_walk`` over the assembled stream (see the note
    above :class:`BankWalks`), joined from views of the bank's walks."""
    last = len(idx) - 1
    end = bw.row_ptr[idx[0], -1:] * 0 + len(idx) * stream_len
    row_ptr, tile_ptr, split_at = [], [], []
    for k, g in enumerate(idx):
        row_ptr.append(bw.row_ptr[g, :-1] + k * stream_len)
        if k < last:
            tp = bw.tile_ptr[g, :-1]
            sa = bw.split_at[bw.split_off[g]:bw.split_off[g + 1]]
        else:
            tp = bw.tile_ptr_last[g]
            sa = bw.split_at_last[bw.split_last_off[g]:bw.split_last_off[g + 1]]
        tile_ptr.append(tp + k * n_chunks)
        split_at.append(sa + k * n_chunks)
    return StreamWalk(row_ptr=torch.cat(row_ptr + [end]),
                      tile_ptr=torch.cat(tile_ptr),
                      split_at=torch.cat(split_at),
                      max_run=int(bw.max_run[idx].max()))


# the Graph fields a bank stacks (all but the scalars n_node, n_edge come
# out of the bank by a gather over the graph axis)
_BANK_FIELDS = ("senders", "receivers", "edge_weight", "edge_mask", "row_ptr",
                "node_mask", "n_node", "n_edge", "col_perm", "col_ptr",
                "r_local", "r_chunk", "c_slot", "c_local", "c_chunk")


class GraphBank(NamedTuple):
    """[G, ...]-stacked padded per-graph fields, and each graph's two
    walks, resident on the device."""

    features: torch.Tensor  # [G, N_pg, F_pad]
    labels: torch.Tensor  # [G, N_pg, C]
    senders: torch.Tensor  # [G, E_s] int32, block-local ids
    receivers: torch.Tensor  # [G, E_s]
    edge_weight: torch.Tensor  # [G, E_s]
    edge_mask: torch.Tensor  # [G, E_s] bool
    row_ptr: torch.Tensor  # [G, N_pg + 1]
    node_mask: torch.Tensor  # [G, N_pg] bool
    n_node: torch.Tensor  # [G]
    n_edge: torch.Tensor  # [G]
    col_perm: torch.Tensor  # [G, E_s]
    col_ptr: torch.Tensor  # [G, N_pg + 1]
    r_local: torch.Tensor  # [G, E_s]
    r_chunk: torch.Tensor  # [G, C]
    c_slot: torch.Tensor  # [G, E_s2]
    c_local: torch.Tensor  # [G, E_s2]
    c_chunk: torch.Tensor  # [G, C2]
    stream_walks: BankWalks  # the receiver streams' walks
    sender_walks: BankWalks  # the CSC streams' walks

    @property
    def n_graphs(self) -> int:
        return self.features.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.features.shape[1]


def bank_bounds(splits: list[list[PPIGraph]]) -> tuple[int, int]:
    """One per-graph (N_pg, E_pg) across all splits (a single batch shape
    per batch size)."""
    n = max(g.num_nodes for graphs in splits for g in graphs)
    e = max(len(g.senders) for graphs in splits for g in graphs)
    return round_up(n + 1), round_up(e)


def build_bank(graphs: list[PPIGraph], n_pg: int, e_pg: int,
               device: torch.device | str | None = None) -> GraphBank:
    """Host-side, once per split: pad each graph alone (``build_graph``,
    walks included, on the host), stack, and move to ``device`` (CUDA
    unless the caller names another device)."""
    device = resolve_device(device)
    f_pad = round_up(PPI_NUM_INPUT_FEATURES)
    feats, labels = [], []
    cols: dict = {f: [] for f in _BANK_FIELDS}
    walks: dict = {"r": [], "c": []}
    for g in graphs:
        gr = build_graph(g.senders, g.receivers, g.weights, g.num_nodes,
                         n_pad=n_pg, e_pad=e_pg, device="cpu")
        assert gr.r_local is not None  # n_pg is 128-aligned by round_up
        for f in cols:
            cols[f].append(getattr(gr, f).numpy())
        walks["r"].append(gr.stream_walk)
        walks["c"].append(gr.sender_walk)
        feats.append(pad_axis(pad_axis(g.features, n_pg, axis=0), f_pad, axis=1))
        labels.append(pad_axis(g.labels, n_pg, axis=0))

    def dev(v):
        return torch.from_numpy(np.stack(v)).to(device)

    n_tiles = n_pg // TILE
    return GraphBank(
        features=dev(feats),
        labels=dev(labels),
        **{f: dev(v) for f, v in cols.items()},
        stream_walks=_bank_walks(walks["r"], cols["r_local"], cols["r_chunk"],
                                 n_tiles, device),
        sender_walks=_bank_walks(walks["c"], cols["c_local"], cols["c_chunk"],
                                 n_tiles, device),
    )


def assemble_banked_batch(bank: GraphBank, idx: Sequence[int],
                          live: Sequence[bool]):
    """Device-side block-diagonal collate: (features [B*N_pg, F], Graph,
    labels [B*N_pg, C]) for member graphs ``idx`` (B host ints); ``live``
    (B host bools) masks padding slots (their nodes drop out of every
    loss and metric: their outputs are computed but never consumed, so
    duplicated pad graphs contribute nothing). The Graph carries its two
    walks, assembled on the device by offsets (``Graph.stream_walk``,
    ``Graph.sender_walk``), so the fused kernels run on it as on a graph
    from ``build_graph``. Members are taken as views of the bank and
    joined with their offsets added, so nothing is copied from the host
    and nothing is read back."""
    idx = [int(i) for i in idx]
    live = [bool(v) for v in live]
    b = len(idx)
    n_pg = bank.nodes_per_graph
    e_s = bank.senders.shape[1]
    e_s2 = bank.c_local.shape[1]
    tiles = n_pg // TILE

    def cat(leaf, off=0):
        return torch.cat([leaf[g] + k * off if off else leaf[g]
                          for k, g in enumerate(idx)])

    def masked(leaf):
        return torch.cat([leaf[g] if lv else torch.zeros_like(leaf[g])
                          for g, lv in zip(idx, live)])

    def ptr(leaf):
        end = leaf[idx[0], -1:] * 0 + b * e_s
        return torch.cat([leaf[g, :-1] + k * e_s
                          for k, g in enumerate(idx)] + [end])

    def count(leaf):
        return sum(leaf[g] for g, lv in zip(idx, live) if lv) + leaf[idx[0]] * 0

    graph = Graph(
        senders=cat(bank.senders, n_pg),
        receivers=cat(bank.receivers, n_pg),
        edge_weight=cat(bank.edge_weight),
        edge_mask=masked(bank.edge_mask),
        row_ptr=ptr(bank.row_ptr),
        node_mask=masked(bank.node_mask),
        n_node=count(bank.n_node),
        n_edge=count(bank.n_edge),
        col_perm=cat(bank.col_perm, e_s),
        col_ptr=ptr(bank.col_ptr),
        r_local=cat(bank.r_local),
        r_chunk=cat(bank.r_chunk, tiles),
        c_slot=cat(bank.c_slot, e_s),
        c_local=cat(bank.c_local),
        c_chunk=cat(bank.c_chunk, tiles),
    )
    _remember_walk(graph.r_local, _assemble_walk(
        bank.stream_walks, idx, e_s, e_s // EC))
    _remember_walk(graph.c_local, _assemble_walk(
        bank.sender_walks, idx, e_s2, e_s2 // EC))
    return cat(bank.features), graph, cat(bank.labels)
