"""Host side of the PyTorch port against the JAX package: the stream layout,
every Graph field, and the citation loader produce identical arrays."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pygat_tpu import graph as jgraph
from pygat_tpu.data import citation as jcitation
from pygat_tpu.ops import stream as jstream
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import graph as tgraph
from pygat_tpu_torch.data import citation as tcitation
from pygat_tpu_torch.ops import stream as tstream


def _assert_graphs_equal(gj, gt):
    assert gj._fields == gt._fields
    for name in gj._fields:
        a, b = getattr(gj, name), getattr(gt, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _graph_cases():
    rng = np.random.default_rng(72)
    n = 300
    s = np.concatenate([rng.integers(0, n, 1800), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, 1800), np.arange(n)])
    # tile 1 (rows 128..255) has no incoming edge
    r_gap = np.concatenate([rng.integers(0, 100, 500),
                            rng.integers(256, 380, 500)])
    s_gap = rng.integers(0, 383, 1000)
    w = rng.random(s.shape[0]).astype(np.float32)
    return {
        "random": ((s, r, w, n), {}),
        "empty_tile": ((s_gap, r_gap, None, 383), dict(n_pad=384)),
        "bucketed": ((s, r, None, n), dict(n_pad=512, e_pad=4096)),
        "unaligned": ((s, r, None, n), dict(node_align=8)),
    }


@pytest.mark.parametrize("case", sorted(_graph_cases()))
def test_build_graph_fields_equal(case):
    args, kw = _graph_cases()[case]
    gj = jgraph.build_graph(*args, **kw)
    gt = tgraph.build_graph(*args, **kw, device="cpu")
    _assert_graphs_equal(gj, gt)
    host = tgraph.host_edges(gt)
    np.testing.assert_array_equal(host[0], gt.senders.numpy())
    np.testing.assert_array_equal(host[3], gt.edge_mask.numpy())


@pytest.mark.parametrize("stream_pad", [None, 8192])
def test_stream_layout_equal(stream_pad):
    rng = np.random.default_rng(11)
    n_pad = 512
    ids = np.sort(rng.integers(0, n_pad - 1, 2500))
    ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=n_pad), out=ptr[1:])
    order = rng.permutation(2500)
    for o in (None, order):
        lj = jstream.build_stream_layout(ptr, o, stream_pad=stream_pad)
        lt = tstream.build_stream_layout(ptr, o, stream_pad=stream_pad)
        for a, b in zip(lj, lt):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for e_pad in (100, 2500, 40000):
        assert (tstream.stream_length(e_pad, n_pad)
                == jstream.stream_length(e_pad, n_pad))


def test_from_scipy_matches():
    import scipy.sparse as sp

    adj = sp.random(200, 200, density=0.05, random_state=3, format="csr",
                    dtype=np.float32) + sp.eye(200, dtype=np.float32)
    _assert_graphs_equal(jgraph.from_scipy(adj),
                         tgraph.from_scipy(adj, device="cpu"))


def test_graph_to_keeps_host_edges():
    gt = tgraph.build_graph(np.arange(5), np.arange(5), None, 5,
                            device="cpu")
    g2 = gt.to("cpu")
    assert tgraph.host_edges(g2) is not None


def test_load_citation_cora_identical():
    dj = jcitation.load_citation("cora")
    dt = tcitation.load_citation("cora", device="cpu")
    _assert_graphs_equal(dj.graph, dt.graph)
    for name in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        a, b = np.asarray(getattr(dj, name)), getattr(dt, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert dj.num_classes == dt.num_classes
    assert dj.num_features == dt.num_features
    assert dj.synthetic_parts == dt.synthetic_parts
    assert jcitation.dataset_stats(dj) == tcitation.dataset_stats(dt)
    # the main path's shapes on Cora (22 tiles of 128 rows, 112 chunks)
    assert dt.graph.num_nodes_padded == 2816
    assert dt.graph.num_edges_padded == 28672
    assert dt.features.shape == (2816, 1536)


def test_load_citation_reorder_not_ported():
    """``reorder=True``, which raised before the host graph library was
    ported, relabels Cora isomorphically by the RCM order of its
    normalised adjacency: the same counts, each node's features, label and
    split membership moved with it, every edge relabelled, and the edges
    packed nearer the diagonal."""
    from pygat_tpu_torch import native
    from pygat_tpu_torch.data.preprocess import (
        normalize_adj_with_self_loops,
        symmetrize,
    )

    plain = tcitation.load_citation("cora", device="cpu")
    re = tcitation.load_citation("cora", reorder=True, device="cpu")
    n = plain.num_nodes
    assert tcitation.dataset_stats(re) == tcitation.dataset_stats(plain)
    adj = tcitation._load_cora(tcitation._search_roots(None))[0]
    csr = normalize_adj_with_self_loops(symmetrize(adj)).tocsr()
    order = native.rcm_order(csr.indptr, csr.indices, n)
    inverse = np.argsort(order)
    assert torch.equal(re.features[:n], plain.features[:n][order])
    assert torch.equal(re.labels[:n], plain.labels[:n][order])
    for f in ("idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(
            getattr(re, f).numpy(), inverse[getattr(plain, f).numpy()])

    def edges(g, relabel=None):
        m = g.edge_mask.numpy()
        s, r = g.senders.numpy()[m], g.receivers.numpy()[m]
        if relabel is not None:
            s, r = relabel[s], relabel[r]
        return s, r

    s_re, r_re = edges(re.graph)
    s_pl, r_pl = edges(plain.graph, inverse)
    assert sorted(zip(s_re, r_re)) == sorted(zip(s_pl, r_pl))
    s_old, r_old = edges(plain.graph)
    assert np.abs(s_re - r_re).mean() < np.abs(s_old - r_old).mean()


def test_graph_tensors_on_requested_device():
    g = tgraph.build_graph(np.arange(5), np.arange(5), None, 5,
                           device=torch.device("cpu"))
    assert all(t.device.type == "cpu" for t in g if t is not None)
