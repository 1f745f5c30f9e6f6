"""Transductive citation datasets: Cora / Citeseer / Pubmed (port of
``pygat_tpu/data/citation.py``).

Reproduces the reference loaders (utils.py:16-70): Cora from raw text
``cora.content`` + ``cora.cites`` with the fixed splits train=range(140),
val=range(200,500), test=range(500,1500); Citeseer/Pubmed from DGL-exported
``{name}_dgl/`` tensors; shared post-processing: symmetrize, row-normalize
features, D^-1/2 (A+I) D^-1/2. Missing files are regenerated
deterministically by :mod:`pygat_tpu_torch.data.synthetic` (the same
generator as the JAX package, so both load identical arrays) and recorded
in ``synthetic_parts``.
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from pygat_tpu_torch.data import synthetic
from pygat_tpu_torch.data.preprocess import (
    normalize_adj_with_self_loops,
    normalize_features,
    symmetrize,
)
from pygat_tpu_torch.graph import Graph, build_graph, from_scipy, host_edges
from pygat_tpu_torch.models.presets import (
    CITESEER_NUM_CLASSES,
    CITESEER_NUM_INPUT_FEATURES,
    CORA_NUM_CLASSES,
    CORA_NUM_INPUT_FEATURES,
    PUBMED_NUM_CLASSES,
    PUBMED_NUM_INPUT_FEATURES,
)
from pygat_tpu_torch.utils.padding import pad_axis, round_up
from pygat_tpu_torch.utils.platform import resolve_device


class CitationDataset(NamedTuple):
    graph: Graph
    features: torch.Tensor  # [N_pad, F_pad] float32, row-normalized
    labels: torch.Tensor  # [N_pad] int32, -1 on padding
    idx_train: torch.Tensor  # int32
    idx_val: torch.Tensor
    idx_test: torch.Tensor
    num_classes: int
    num_features: int  # real (unpadded) feature count
    synthetic_parts: tuple[str, ...]

    @property
    def num_nodes(self) -> int:
        return int(self.graph.n_node)


def _search_roots(data_root: str | None) -> list[str]:
    """``data_root``, then ``$PYGAT_DATA``, then the working directory."""
    roots = []
    if data_root:
        roots.append(data_root)
    if os.environ.get("PYGAT_DATA"):
        roots.append(os.environ["PYGAT_DATA"])
    roots.append(os.getcwd())
    return roots


def _find(relpath: str, roots: list[str]) -> str | None:
    for r in roots:
        p = os.path.join(r, relpath)
        if os.path.exists(p):
            return p
    return None


def _warn_synth(dataset: str, part: str) -> None:
    print(
        f"[pygat_tpu_torch.data] {dataset}: '{part}' not found — "
        "using deterministic synthetic stand-in",
        file=sys.stderr,
    )


def _load_cora(roots: list[str]):
    synth: list[str] = []
    content_path = _find("data/cora/cora.content", roots)
    cites_path = _find("data/cora/cora.cites", roots)
    if cites_path is None and content_path is None:
        _warn_synth("cora", "cora.cites/cora.content")
        s, r, labels = synthetic.planted_partition_graph(2708, CORA_NUM_CLASSES, "cora")
        adj = sp.coo_matrix(
            (np.ones(len(s), np.float32), (r, s)), shape=(2708, 2708)
        ).tocsr()
        features = synthetic.class_features(labels, CORA_NUM_INPUT_FEATURES, "cora")
        return adj, features, labels, ("topology", "features", "labels")

    if content_path is not None:
        # reference utils.py:21-29
        raw = np.genfromtxt(content_path, dtype=np.dtype(str))
        features = sp.csr_matrix(raw[:, 1:-1], dtype=np.float32)
        class_names = sorted(set(raw[:, -1]))
        labels = np.array([class_names.index(c) for c in raw[:, -1]], dtype=np.int32)
        ids = raw[:, 0].astype(np.int64)
    else:
        _warn_synth("cora", "cora.content")
        synth += ["features", "labels"]
        edges_raw = np.genfromtxt(cites_path, dtype=np.int64)
        ids = np.unique(edges_raw)
        features = labels = None  # filled below once edges are mapped

    idx_map = {int(j): i for i, j in enumerate(ids)}
    n = len(ids)
    edges_raw = np.genfromtxt(cites_path, dtype=np.int64)
    edges = np.array(
        [[idx_map[int(a)], idx_map[int(b)]] for a, b in edges_raw], dtype=np.int64
    )
    adj = sp.coo_matrix(
        (np.ones(len(edges), np.float32), (edges[:, 0], edges[:, 1])), shape=(n, n)
    ).tocsr()

    if features is None:
        labels = synthetic.propagate_labels(
            edges[:, 1], edges[:, 0], n, CORA_NUM_CLASSES, "cora"
        )
        features = synthetic.class_features(labels, CORA_NUM_INPUT_FEATURES, "cora")
    return adj, features, labels, tuple(synth)


def _load_dgl_export(name: str, roots: list[str], n_feat: int, n_classes: int):
    """Citeseer/Pubmed from the {name}_dgl/ export (utils.py:35-45)."""
    synth: list[str] = []
    folder = f"{name}_dgl"
    adj_path = _find(f"{folder}/adj_sparse.npz", roots)
    if adj_path is None:
        _warn_synth(name, f"{folder}/adj_sparse.npz")
        s, r, labels = synthetic.planted_partition_graph(
            19717 if name == "pubmed" else 3327, n_classes, name
        )
        n = labels.shape[0]
        adj = sp.coo_matrix((np.ones(len(s), np.float32), (r, s)), shape=(n, n)).tocsr()
        feats = synthetic.class_features(labels, n_feat, name)
        idx = np.arange(n)
        return adj, feats, labels, idx[:140], idx[200:500], idx[500:1500], (
            "topology",
            "features",
            "labels",
            "splits",
        )

    adj = sp.load_npz(adj_path).tocsr().astype(np.float32)
    n = adj.shape[0]

    def _load_pt(rel):
        p = _find(f"{folder}/{rel}", roots)
        return None if p is None else torch.load(p, map_location="cpu", weights_only=True)

    labels_t = _load_pt("labels.pt")
    if labels_t is None:
        _warn_synth(name, "labels.pt")
        synth.append("labels")
        coo = adj.tocoo()
        labels = synthetic.propagate_labels(coo.col, coo.row, n, n_classes, name)
    else:
        labels = labels_t.numpy().astype(np.int32)

    feats_t = _load_pt("features.pt")
    if feats_t is None:
        _warn_synth(name, "features.pt")
        synth.append("features")
        feats = synthetic.class_features(labels, n_feat, name)
    else:
        feats = feats_t.numpy().astype(np.float32)

    idx = {}
    for split in ("train", "val", "test"):
        t = _load_pt(f"idx_{split}.pt")
        if t is None:
            _warn_synth(name, f"idx_{split}.pt")
            synth.append(f"idx_{split}")
            rng = np.random.default_rng(72)
            perm = rng.permutation(n)
            sizes = {"train": 140, "val": 500, "test": 1000}
            off = {"train": 0, "val": 140, "test": 640}
            idx[split] = np.sort(perm[off[split] : off[split] + sizes[split]])
        else:
            idx[split] = t.numpy().astype(np.int64)

    return adj, feats, labels, idx["train"], idx["val"], idx["test"], tuple(synth)


def load_citation(dataset: str, data_root: str | None = None,
                  reorder: bool = False,
                  device: torch.device | str | None = None) -> CitationDataset:
    """Load a citation dataset onto ``device`` (CUDA unless the caller names
    another device; raises without CUDA).

    ``reorder=True`` relabels the nodes in reverse Cuthill-McKee order
    (:func:`pygat_tpu_torch.native.rcm_order` over the CSR of the
    normalised adjacency) before the padded Graph is built: an isomorphic
    relabelling, under which the features, labels and the three splits
    move with their nodes, that packs each receiver's senders near it in
    id order. Default off, to keep the reference's node numbering (Cora's
    train split is range(140)).
    """
    device = resolve_device(device)
    roots = _search_roots(data_root)

    if dataset == "cora":
        adj, features, labels, synth = _load_cora(roots)
        idx_train = np.arange(140)
        idx_val = np.arange(200, 500)
        idx_test = np.arange(500, 1500)
        n_classes = CORA_NUM_CLASSES
    elif dataset == "citeseer":
        adj, features, labels, idx_train, idx_val, idx_test, synth = _load_dgl_export(
            "citeseer", roots, CITESEER_NUM_INPUT_FEATURES, CITESEER_NUM_CLASSES
        )
        n_classes = CITESEER_NUM_CLASSES
    elif dataset == "pubmed":
        adj, features, labels, idx_train, idx_val, idx_test, synth = _load_dgl_export(
            "pubmed", roots, PUBMED_NUM_INPUT_FEATURES, PUBMED_NUM_CLASSES
        )
        n_classes = PUBMED_NUM_CLASSES
    else:
        raise ValueError(f"unknown citation dataset {dataset!r}")

    n = adj.shape[0]
    # Shared post-processing, reference utils.py:49-52.
    adj = symmetrize(adj)
    features = normalize_features(features)
    adj_norm = normalize_adj_with_self_loops(adj)

    if reorder:
        from pygat_tpu_torch.native import apply_reorder, rcm_order

        csr = adj_norm.tocsr()
        order = rcm_order(csr.indptr, csr.indices, n)
        coo = csr.tocoo()
        # adj[i, j] is the edge j -> i: senders = col, receivers = row
        new_row, new_col, inverse = apply_reorder(
            order.astype(np.int64), coo.row.astype(np.int64),
            coo.col.astype(np.int64))
        adj_norm = sp.coo_matrix((coo.data, (new_row, new_col)), shape=(n, n))
        features = (features.tocsr() if sp.issparse(features)
                    else np.asarray(features))[order]
        labels = np.asarray(labels)[order]
        idx_train, idx_val, idx_test = (
            inverse[np.asarray(i, dtype=np.int64)]
            for i in (idx_train, idx_val, idx_test))

    graph = from_scipy(adj_norm.tocsr(), device=device)
    n_pad = graph.num_nodes_padded

    if sp.issparse(features):
        features = np.asarray(features.todense())
    features = np.asarray(features, dtype=np.float32)
    f_pad = round_up(features.shape[1])
    feats_p = pad_axis(pad_axis(features, n_pad, axis=0), f_pad, axis=1)

    labels_p = np.full((n_pad,), -1, dtype=np.int32)
    labels_p[:n] = labels

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return CitationDataset(
        graph=graph,
        features=torch.from_numpy(np.ascontiguousarray(feats_p)).to(device),
        labels=torch.from_numpy(labels_p).to(device),
        idx_train=idx(idx_train),
        idx_val=idx(idx_val),
        idx_test=idx(idx_test),
        num_classes=int(n_classes),
        num_features=int(features.shape[1]),
        synthetic_parts=synth,
    )


def _real_edges(g: Graph):
    """(senders, receivers, weights) of ``g``'s real edges, numpy (the
    host copy kept by :func:`~pygat_tpu_torch.graph.build_graph`, else read
    from the device)."""
    host = host_edges(g)
    if host is None:
        host = tuple(t.cpu().numpy() for t in (g.senders, g.receivers,
                                               g.edge_weight, g.edge_mask))
    send, recv, w, mask = host
    return send[mask], recv[mask], w[mask]


def repad_citation(ds: CitationDataset, n_pad: int) -> CitationDataset:
    """The dataset with its node padding changed to ``n_pad`` (feature rows
    grow with zeros, labels with -1), the graph rebuilt by
    :func:`~pygat_tpu_torch.graph.build_graph` on the dataset's device, so
    it has its walks. Port of ``pygat_tpu/data/citation.py::
    repad_citation``: the ring edge partition needs ``N_pad % (128 *
    n_shards) == 0``."""
    g = ds.graph
    old_pad = g.num_nodes_padded
    if n_pad == old_pad:
        return ds
    n_real = int(g.n_node)
    if n_pad < n_real + 1:
        raise ValueError(f"n_pad={n_pad} too small for {n_real} nodes")
    device = ds.features.device
    send, recv, w = _real_edges(g)
    g2 = build_graph(send, recv, w, n_real, n_pad=n_pad, device=device)
    feats, labels = ds.features, ds.labels
    if n_pad > old_pad:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, n_pad - old_pad))
        labels = torch.nn.functional.pad(labels, (0, n_pad - old_pad),
                                         value=-1)
    else:
        feats, labels = feats[:n_pad], labels[:n_pad]
    return ds._replace(graph=g2, features=feats.contiguous(),
                       labels=labels.contiguous())


def interleave_citation(ds: CitationDataset, n_shards: int,
                        n_pad: int | None = None) -> CitationDataset:
    """Cyclic node relabel that balances the ring edge partition's blocks
    (port of ``pygat_tpu/data/citation.py::interleave_citation``): real
    node ``v`` goes to shard ``v % d`` at rank ``v // d``, so every
    neighbourhood spreads over the shards and the (dst, src) blocks
    approach ``E / d^2`` edges each, where contiguous ranges would pile
    id-local edges into the diagonal blocks. Padding fills each shard's
    tail: the real rows are a prefix of each shard's range, not of the
    graph's, whose ``node_mask`` says which rows are real, and the dummy
    row ``n_pad - 1`` stays padding. ``n_pad`` (default: the current
    padding) must be a multiple of ``128 * n_shards``. The graph is
    rebuilt by :func:`~pygat_tpu_torch.graph.build_graph` on the dataset's
    device, walks included. Training is node-permutation-equivariant."""
    g = ds.graph
    d = int(n_shards)
    n_real = int(g.n_node)
    if n_pad is None:
        n_pad = g.num_nodes_padded
    if n_pad % (128 * d):
        raise ValueError(f"n_pad={n_pad} not a multiple of 128*{d}")
    if n_pad <= n_real:
        raise ValueError(f"n_pad={n_pad} too small for {n_real} real nodes")
    n_local = n_pad // d
    device = ds.features.device

    old_real = np.arange(n_real, dtype=np.int64)
    new_of_real = (old_real % d) * n_local + old_real // d
    # per-shard real counts differ by at most 1 and n_real < n_pad, so every
    # new id lands inside its shard's range and the dummy row stays free
    if n_real and int(new_of_real.max()) >= n_pad - 1:
        raise ValueError(f"{n_real} real nodes leave no dummy row in "
                         f"{n_pad} over {d} shards")
    mask_new = np.zeros(n_pad, bool)
    mask_new[new_of_real] = True

    send, recv, w = _real_edges(g)
    g2 = build_graph(new_of_real[send], new_of_real[recv], w, n_real,
                     n_pad=n_pad, node_mask=mask_new, device=device)
    new_t = torch.from_numpy(new_of_real).to(device)
    feats = ds.features
    f_new = torch.zeros(n_pad, feats.shape[1], dtype=feats.dtype,
                        device=device)
    f_new[new_t] = feats[:n_real]
    l_new = torch.full((n_pad,), -1, dtype=ds.labels.dtype, device=device)
    l_new[new_t] = ds.labels[:n_real]

    def remap(idx):
        return new_t[idx.long()].to(torch.int32)

    return ds._replace(graph=g2, features=f_new, labels=l_new,
                       idx_train=remap(ds.idx_train),
                       idx_val=remap(ds.idx_val),
                       idx_test=remap(ds.idx_test))


def dataset_stats(ds: CitationDataset) -> dict:
    """Startup stats mirroring the reference prints (train.py:104-110)."""
    n = int(ds.graph.n_node)
    e = int(ds.graph.n_edge)
    return {
        "nodes": n,
        "edges": (e - n) // 2,  # undirected edges excl. self loops, train.py:105
        "input_features": ds.num_features,
        "classes": ds.num_classes,
        "train_nodes": int(ds.idx_train.shape[0]),
        "val_nodes": int(ds.idx_val.shape[0]),
        "test_nodes": int(ds.idx_test.shape[0]),
        "synthetic_parts": list(ds.synthetic_parts),
    }
