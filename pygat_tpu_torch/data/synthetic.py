"""Deterministic synthetic stand-ins for missing dataset files (port of
``pygat_tpu/data/synthetic.py``, unchanged, so both packages generate the
same arrays).

Where a dataset file is absent, the loaders regenerate the missing pieces
deterministically at the right shapes:

* labels missing  -> seeded label propagation over the REAL edge structure
  (so classes follow graph communities and a GNN can genuinely learn);
* features missing -> noisy class signatures embedded in the real feature
  dimensionality, row-normalized like the bag-of-words originals;
* topology missing -> planted-partition random graphs.

:func:`clustered_citation` makes a whole dataset of any size whose edges
are local (senders near their receivers), the large graph of the banded
path. :func:`hub_edges`, the port's own, is a small graph with one hub, whose
output tile the tile-owner SpMM kernels cut into pieces.

Everything is keyed by (dataset name, shape) through a sha256 seed, so runs
are reproducible across processes. Loaders record which parts were
synthesized in ``synthetic_parts``.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _rng(name: str, *dims: int) -> np.random.Generator:
    # Stable across processes (python's str hash is salted; sha256 is not).
    digest = hashlib.sha256(f"{name}:{dims}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


def propagate_labels(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    num_classes: int,
    name: str,
    rounds: int = 6,
) -> np.ndarray:
    """Community-style labels: seed a few nodes per class, then iterate
    majority-vote label propagation over the real edges."""
    rng = _rng(name + ":labels", num_nodes, num_classes)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    seeds = rng.permutation(num_nodes)[: max(num_classes * 4, num_nodes // 50)]
    fixed = np.zeros(num_nodes, dtype=bool)
    fixed[seeds] = True
    for _ in range(rounds):
        votes = np.zeros((num_nodes, num_classes), dtype=np.int32)
        np.add.at(votes, receivers, np.eye(num_classes, dtype=np.int32)[labels[senders]])
        np.add.at(votes, senders, np.eye(num_classes, dtype=np.int32)[labels[receivers]])
        new = votes.argmax(axis=1).astype(np.int32)
        has_votes = votes.sum(axis=1) > 0
        labels = np.where(fixed | ~has_votes, labels, new)
    return labels


def class_features(
    labels: np.ndarray, num_features: int, name: str, noise: float = 1.0, density: float = 0.03
) -> np.ndarray:
    """Sparse noisy class-signature features, row-normalized downstream like
    the original bag-of-words matrices."""
    rng = _rng(name + ":feats", int(labels.max()) + 1, num_features)
    n_classes = int(labels.max()) + 1
    protos = (rng.random((n_classes, num_features)) < density).astype(np.float32)
    feats = protos[labels]
    flips = (rng.random((labels.shape[0], num_features)) < density * noise * 0.5).astype(
        np.float32
    )
    return np.clip(feats + flips, 0.0, 1.0)


def planted_partition_graph(
    num_nodes: int,
    num_classes: int,
    name: str,
    avg_degree: float = 8.0,
    homophily: float = 0.8,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Undirected planted-partition graph: returns (senders, receivers,
    labels); edges are emitted in both directions, no self loops."""
    rng = _rng(name + ":topo", num_nodes, num_classes)
    labels = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    m = int(num_nodes * avg_degree / 2)
    u = rng.integers(0, num_nodes, size=2 * m)
    v = np.empty_like(u)
    same = rng.random(2 * m) < homophily
    # same-class partner: random node, resampled from the same class bucket
    order = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[order], np.arange(num_classes))
    ends = np.searchsorted(labels[order], np.arange(num_classes), side="right")
    for c in range(num_classes):
        members = order[starts[c] : ends[c]]
        sel = same & (labels[u] == c)
        if members.size and sel.any():
            v[sel] = members[rng.integers(0, members.size, size=int(sel.sum()))]
    rnd = ~same
    v[rnd] = rng.integers(0, num_nodes, size=int(rnd.sum()))
    keep = u != v
    u, v = u[keep][:m], v[keep][:m]
    senders = np.concatenate([u, v])
    receivers = np.concatenate([v, u])
    return senders, receivers, labels


def clustered_citation(n_nodes: int, n_feat: int, n_classes: int, name: str,
                       spread: int, n_pad: int | None = None, *,
                       device=None):
    """A citation-like dataset whose senders lie within ``spread`` of their
    receivers (the counterpart of ``_synthetic_citation(spread=k)`` in the
    JAX package's ``__graft_entry__.py``): 9 in-edges per node from
    ``receiver + U[-spread, spread)`` (clipped to the node range) plus a
    self-loop, noisy class-signature features in the first
    ``min(n_feat, 64)`` of ``n_feat`` columns, labels by contiguous node
    band, and 10 % / 10 % / 80 % train / validation / test splits. Seeded
    from ``name`` through sha256, so every process draws the same graph
    (the JAX function seeds from ``hash(name)``, which is salted per
    process; the two generators are not meant to agree). Returns a
    :class:`~pygat_tpu_torch.data.citation.CitationDataset` on ``device``
    (CUDA unless the caller names another device; raises without CUDA)."""
    import torch

    from pygat_tpu_torch.data.citation import CitationDataset
    from pygat_tpu_torch.graph import build_graph
    from pygat_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)
    rng = _rng(name + ":clustered", n_nodes, spread)
    deg = 9
    base = np.repeat(np.arange(n_nodes, dtype=np.int64), deg)
    s = np.clip(base + rng.integers(-spread, spread, base.shape[0]),
                0, n_nodes - 1)
    s = np.concatenate([s, np.arange(n_nodes)])
    r = np.concatenate([base, np.arange(n_nodes)])
    labels = (np.arange(n_nodes) * n_classes // n_nodes).astype(np.int32)
    g = build_graph(s, r, None, n_nodes, n_pad=n_pad, device=device)
    feats = class_features(labels, min(n_feat, 64), name)
    x = np.zeros((g.num_nodes_padded, n_feat), np.float32)
    x[:n_nodes, : feats.shape[1]] = feats
    lab = np.full(g.num_nodes_padded, -1, np.int32)
    lab[:n_nodes] = labels
    n_train = max(32, n_nodes // 10)
    n_val_end = min(2 * n_train, n_nodes)

    def idx(a, b):
        return torch.arange(a, b, dtype=torch.int32, device=device)

    return CitationDataset(
        graph=g,
        features=torch.from_numpy(x).to(device),
        labels=torch.from_numpy(lab).to(device),
        idx_train=idx(0, n_train),
        idx_val=idx(n_train, n_val_end),
        idx_test=idx(n_val_end, n_nodes),
        num_classes=n_classes,
        num_features=n_feat,
        synthetic_parts=("all",),
    )


def hub_edges(rng: np.random.Generator | None = None
              ) -> tuple[np.ndarray, np.ndarray, int]:
    """(senders, receivers, num_nodes) of a small graph with a hub: 1500
    nodes, 3 in-edges each from within +-200 plus self loops, and 9000 more
    in-edges of node 700 from anywhere, so that node 700's tile owns some 38
    chunks of the receiver stream and of a w = 4 band plan. Drawn from
    ``rng`` (default: seed 9), which a caller may go on drawing from."""
    if rng is None:
        rng = np.random.default_rng(9)
    n = 1500
    base = np.repeat(np.arange(n), 3)
    s = np.clip(base + rng.integers(-200, 200, base.size), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, 9000), np.arange(n)])
    r = np.concatenate([base, np.full(9000, 700), np.arange(n)])
    return s, r, n
