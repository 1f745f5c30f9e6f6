"""Host-side graph preprocessing (port of ``pygat_tpu/data/preprocess.py``),
reproducing the reference pipeline exactly
(reference utils.py:49-55 and utils.py:73-89):

* symmetrize:      adj + adj.T∘(adj.T > adj) − adj∘(adj.T > adj)
* feature norm:    row-normalize (rows sum to 1; zero rows stay zero)
* adjacency norm:  D^-1/2 (A + I) D^-1/2 (on the symmetrized matrix)

All in scipy/numpy on the host; the result feeds pygat_tpu_torch.graph.build_graph
once, unlike the reference which re-extracts edges per forward pass.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def symmetrize(adj: sp.spmatrix) -> sp.spmatrix:
    """Build a symmetric adjacency from a directed one (utils.py:49)."""
    adj = adj.tocsr()
    t = adj.T
    mask = (t > adj).astype(adj.dtype)
    return adj + t.multiply(mask) - adj.multiply(mask)


def normalize_adj(mx: sp.spmatrix) -> sp.spmatrix:
    """Symmetric normalization D^-1/2 M^T D^-1/2 (utils.py:73-79).

    (For the symmetric matrices this pipeline feeds it, the transpose is a
    no-op; kept to mirror the reference exactly.)
    """
    rowsum = np.asarray(mx.sum(1)).flatten()
    with np.errstate(divide="ignore"):
        r_inv_sqrt = np.power(rowsum, -0.5)
    r_inv_sqrt[np.isinf(r_inv_sqrt)] = 0.0
    d = sp.diags(r_inv_sqrt)
    return mx.dot(d).transpose().dot(d)


def normalize_adj_with_self_loops(adj: sp.spmatrix) -> sp.spmatrix:
    """D^-1/2 (A + I) D^-1/2 — the transductive pipeline's call site
    (utils.py:52)."""
    return normalize_adj(adj + sp.eye(adj.shape[0], dtype=adj.dtype, format="csr"))


def normalize_features(mx) -> np.ndarray | sp.spmatrix:
    """Row-normalize a (sparse or dense) feature matrix (utils.py:82-89)."""
    rowsum = np.asarray(mx.sum(1)).flatten()
    with np.errstate(divide="ignore"):
        r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    if sp.issparse(mx):
        return sp.diags(r_inv).dot(mx)
    return r_inv[:, None] * np.asarray(mx)
