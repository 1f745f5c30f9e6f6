"""A tiny multi-graph PPI problem for the PyTorch port's PPI tests, at the
scale of ``tests/test_ppi.py::_synth_ppi`` (4 train graphs of 40 nodes, 2
validation and 2 test graphs of 25 to 35, 16 features, 6 labels), built
from numpy arrays that both packages' loaders and loops take unchanged."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from pygat_tpu_torch.data.preprocess import normalize_adj
from pygat_tpu_torch.data.synthetic import planted_partition_graph

SIZES = {"train": [(40, f"t{i}") for i in range(4)],
         "valid": [(30, "v0"), (35, "v1")],
         "test": [(30, "x0"), (25, "x1")]}


def synth_ppi(graph_cls, data_cls, n_feat: int = 16, n_labels: int = 6):
    """The problem as ``data_cls(train, valid, test, ("all",))`` of
    ``graph_cls(features, labels, senders, receivers, weights, n)`` (either
    package's ``PPIData`` and ``PPIGraph``), with ``n_feat`` features and
    ``n_labels`` labels a node (PPI's 50 and 121 for the CLI)."""
    rng = np.random.default_rng(0)
    R = rng.standard_normal((n_feat, n_labels)).astype(np.float32)

    def mk(n, name):
        s, r, _ = planted_partition_graph(n, 3, name, avg_degree=6)
        adj = sp.coo_matrix((np.ones(len(s), np.float32), (r, s)),
                            shape=(n, n)).tocsr()
        adj.data[:] = 1.0
        adj = normalize_adj(adj + sp.eye(n, format="csr",
                                         dtype=np.float32)).tocoo()
        feats = rng.standard_normal((n, n_feat)).astype(np.float32)
        labels = (feats @ R > 0.5).astype(np.float32)
        return graph_cls(feats, labels, adj.col.astype(np.int64),
                         adj.row.astype(np.int64), adj.data.astype(np.float32),
                         n)

    return data_cls(*([mk(n, name) for n, name in SIZES[split]]
                      for split in ("train", "valid", "test")), ("all",))


# a 3-layer model with skip connections at the PPI preset's shape, cut down
CFG = dict(nlayers=3, nheads=(2, 2, 3), nfeats=(128, 16, 16, 6), dropout=0.0,
           alpha=0.2, skip_connection=True)
