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
