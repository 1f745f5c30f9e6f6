"""PPI-sized protein graphs: the splits of the configuration at the real
per-graph node counts, made from the seed.

Rewritten from the port's ``data/ppi.py`` stand-ins (used where the PPI
files are absent, at ``_FALLBACK_SIZES``) with the run's seed mixed into
every draw, so that the yardstick does not move when the program's loader
does: per graph a planted-partition topology of ``communities`` classes,
``avg_degree`` edge ends drawn a node and ``homophily`` of the edges
inside a class (emitted in both directions, no self-loops), then made
simple (repeated edges collapse) with a self-loop on every node, as the
reference loader does (load_data_ppi.py:149-151); features |N(0, 1)| kept
with probability ``feature_keep``; labels from one hyperplane rule over
the features and their neighbourhood mean, shared by all splits (so the
train graphs predict the others), thresholded at ``label_threshold``. The symmetric
normalisation D^-1/2 (A + I) D^-1/2 gives each edge its weight.

Returns host arrays: ``{split: [graph]}``, each graph a dict of
``features`` [n, F] f32, ``labels`` [n, C] f32, ``senders``, ``receivers``
(sorted by receiver, then sender), ``weights`` f32 and ``num_nodes``.
"""

from __future__ import annotations

import numpy as np

from h100_bench.seeds import rng


def _planted_partition(n: int, mix: dict, g) -> tuple[np.ndarray, np.ndarray]:
    k = int(mix["communities"])
    labels = g.integers(0, k, size=n)
    m = int(n * float(mix["avg_degree"]) / 2)
    u = g.integers(0, n, size=2 * m)
    v = np.empty_like(u)
    same = g.random(2 * m) < float(mix["homophily"])
    order = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[order], np.arange(k))
    ends = np.searchsorted(labels[order], np.arange(k), side="right")
    for c in range(k):
        members = order[starts[c]:ends[c]]
        sel = same & (labels[u] == c)
        if members.size and sel.any():
            v[sel] = members[g.integers(0, members.size, size=int(sel.sum()))]
    other = ~same
    v[other] = g.integers(0, n, size=int(other.sum()))
    keep = u != v
    u, v = u[keep][:m], v[keep][:m]
    return np.concatenate([u, v]), np.concatenate([v, u])


def _simple_with_loops(s, r, n):
    """The graph made simple, with one self-loop a node, sorted by
    (receiver, sender), and the symmetric normalisation's weights."""
    key = np.unique(np.concatenate([r * n + s, np.arange(n) * (n + 1)]))
    r, s = key // n, key % n
    deg = np.bincount(r, minlength=n).astype(np.float64)
    w = (1.0 / np.sqrt(deg[r] * deg[s])).astype(np.float32)
    return s, r, w


def generate(mix: dict, graph: dict, seed: int) -> dict:
    n_feat, n_lab = int(graph["features"]), int(graph["labels"])
    lrng = rng(seed, "ppi", "label_rule")
    proj = lrng.standard_normal((n_feat, n_lab)).astype(np.float32)
    bias = lrng.standard_normal(n_lab).astype(np.float32) * 0.5
    out = {}
    for split, sizes in graph["splits"].items():
        graphs = []
        for i, n in enumerate(sizes):
            g = rng(seed, "ppi", split, i)
            x = (np.abs(g.standard_normal((n, n_feat))).astype(np.float32)
                 * (g.random((n, n_feat)) < float(mix["feature_keep"])))
            s, r = _planted_partition(n, mix, g)
            s, r, w = _simple_with_loops(s, r, n)
            deg = np.bincount(r, minlength=n).astype(np.float32)
            smooth = np.zeros_like(x)
            np.add.at(smooth, r, x[s])
            z = 0.5 * (x + smooth / np.maximum(deg, 1.0)[:, None])
            z = (z - z.mean(0)) / (z.std(0) + 1e-6)
            y = (z @ proj + bias > float(mix["label_threshold"])).astype(
                np.float32)
            graphs.append({"features": x, "labels": y, "senders": s,
                           "receivers": r, "weights": w, "num_nodes": n})
        out[split] = graphs
    return out
