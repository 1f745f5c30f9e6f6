"""The port's unfused sparse branches, segment gathers and impl switches
against the JAX package: both head-batched layers' unfused branch under
the ``stream`` impl (the plain stream segment sum on the CPU) and under
``scatter``, on a graph with a stream layout and on one without, against
the JAX package's unfused branch (its CPU default), forward and gradients;
the fused switch off against on; ``gather_receivers_hn``,
``take_receivers``, ``take_senders``, the impl-dependent gathers and
``stream_expand``, values and VJPs; ``use_impl`` scoping; and the four
single-head layer functions against the torch goldens of
``tests/golden/golden_layers.npz``."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import layers as jlayers
from pygat_tpu.ops import large as jlarge
from pygat_tpu.ops import segment as jseg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.graph import from_scipy
from pygat_tpu_torch.models import layers as tlayers
from pygat_tpu_torch.ops import fused_stream as tfs
from pygat_tpu_torch.ops import large as tlarge
from pygat_tpu_torch.ops import segment as tseg
from pygat_tpu_torch.ops.stream import stream_scatter_plain

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
H, F_IN, F_OUT = 3, 12, 5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_layers.npz")
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_golden_torch.py:38


@pytest.fixture(scope="module")
def graphs():
    """A graph with the stream layout (N_pad 384) and one without (nodes
    padded to 8: N_pad 304), in both packages, and node features."""
    rng = np.random.default_rng(5)
    n = 300
    s = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    out = {}
    for name, kw in (("aligned", {}), ("unaligned", dict(node_align=8))):
        gj = jbuild_graph(s, r, None, n, **kw)
        gt = tbuild_graph(s, r, None, n, device="cpu", **kw)
        assert (gt.r_local is not None) == (name == "aligned")
        x = (rng.standard_normal((gt.num_nodes_padded, F_IN)) * 0.5).astype(
            np.float32)
        out[name] = (gj, gt, x)
    return out


@pytest.fixture
def fused_mode():
    """Sets the fused switch for one test and restores the default."""
    yield tfs.set_fused_attention
    tfs.set_fused_attention("auto")


@pytest.fixture
def stream_calls(monkeypatch):
    """Counts the stream segment sums the segment ops run."""
    calls = []
    real = tseg.stream_scatter

    def spy(data, *a, **k):
        calls.append(data.shape[1])
        return real(data, *a, **k)

    monkeypatch.setattr(tseg, "stream_scatter", spy)
    return calls


def _params(v2, rng):
    w_rows = 2 * F_IN if v2 else F_IN
    a_cols = F_OUT if v2 else 2 * F_OUT
    return tuple((rng.standard_normal(shape) * 0.4).astype(np.float32)
                 for shape in ((H, w_rows, F_OUT), (H, a_cols),
                               (H, F_IN, F_OUT)))


@pytest.fixture(scope="module")
def jax_heads(graphs):
    """The JAX heads function's unfused branch (its CPU default), value and
    gradients of sum(sin(out)) / N, once per (model, graph)."""
    cache = {}

    def get(v2, name):
        if (v2, name) not in cache:
            gj, _, x = graphs[name]
            params = _params(v2, np.random.default_rng(7 + v2))
            fn = (jlayers.gat_v2_sparse_heads if v2
                  else jlayers.gat_v1_sparse_heads)
            cls = jlayers.V2Params if v2 else jlayers.V1Params

            def loss(p, h):
                out = fn(cls(*p), h, gj, None, alpha=0.2, drop=0.0,
                         concat=True, train=False)
                return jnp.sum(jnp.sin(out)) / out.shape[0], out

            (_, out), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(
                    tuple(map(jnp.asarray, params)), jnp.asarray(x))
            cache[v2, name] = (params, np.asarray(out),
                               [np.asarray(g) for g in (*grads[0], grads[1])])
        return cache[v2, name]

    return get


def _torch_heads(v2, params, gt, x):
    fn = tlayers.gat_v2_sparse_heads if v2 else tlayers.gat_v1_sparse_heads
    cls = tlayers.V2Params if v2 else tlayers.V1Params
    tp = [torch.tensor(t, requires_grad=True) for t in params]
    h = torch.tensor(x, requires_grad=True)
    out = fn(cls(*tp), h, gt, None, alpha=0.2, drop=0.0, concat=True,
             train=False)
    (torch.sin(out).sum() / out.shape[0]).backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (*tp, h)]


@pytest.mark.parametrize("impl", ["stream", "scatter"])
@pytest.mark.parametrize("name", ["aligned", "unaligned"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_unfused_heads_match_jax(graphs, jax_heads, fused_mode, stream_calls,
                                 v2, name, impl):
    """The unfused branch (fused switch off) against the JAX package's,
    forward and the gradients of W, a, skip and the input. Under the
    stream impl on the aligned graph the sums run the stream segment sum:
    one receiver sum of [E, H F + H] forward, and backward the sender sums
    of the gathers (one for v1, two for v2) and one receiver sum ([E, H]
    for v1, [E, H F] for v2); otherwise none."""
    _, gt, x = graphs[name]
    params, out_j, grads_j = jax_heads(v2, name)
    fused_mode("off")
    with tseg.use_impl(impl):
        out_t, grads_t = _torch_heads(v2, params, gt, x)
    np.testing.assert_allclose(out_t, out_j, **VAL)
    for got, want in zip(grads_t, grads_j):
        np.testing.assert_allclose(got, want, **GRAD)
    hf = H * F_OUT
    want_calls = ([] if impl == "scatter" or name == "unaligned" else
                  [hf + H, hf, hf, hf] if v2 else [hf + H, hf, H])
    assert sorted(stream_calls) == sorted(want_calls)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_fused_off_matches_on(graphs, fused_mode, v2):
    """On a graph with the stream layout, the unfused branch gives the
    fused branch's output and gradients."""
    _, gt, x = graphs["aligned"]
    params = _params(v2, np.random.default_rng(3))
    results = []
    for mode in ("on", "off"):
        fused_mode(mode)
        results.append(_torch_heads(v2, params, gt, x))
    (out_on, grads_on), (out_off, grads_off) = results
    np.testing.assert_allclose(out_off, out_on, **VAL)
    for got, want in zip(grads_off, grads_on):
        np.testing.assert_allclose(got, want, **GRAD)


def test_fused_enabled_follows_the_switches(graphs, fused_mode):
    _, aligned, _ = graphs["aligned"]
    _, unaligned, _ = graphs["unaligned"]
    for impl, mode, want in (("auto", "auto", True), ("stream", "auto", True),
                             ("scatter", "auto", False),
                             ("scan", "auto", False), ("scan", "on", True),
                             ("auto", "off", False)):
        fused_mode(mode)
        with tseg.use_impl(impl):
            assert tfs.fused_enabled(aligned) is want, (impl, mode)
            assert tfs.fused_enabled(unaligned) is False
    with pytest.raises(ValueError, match="fused-attention mode"):
        tfs.set_fused_attention("bogus")


def test_use_impl_scopes_and_restores(graphs, stream_calls):
    """``use_impl`` overrides the default inside its scope (nested, None a
    no-op) and restores it on exit; an unknown impl raises; a gather keeps
    the impl of its forward for its backward."""
    _, gt, _ = graphs["aligned"]
    base = tseg.current_impl()
    with tseg.use_impl("scatter"):
        assert tseg.current_impl() == "scatter"
        with tseg.use_impl("stream"):
            assert tseg.current_impl() == "stream"
        with tseg.use_impl(None):
            assert tseg.current_impl() == "scatter"
        assert not tseg.stream_enabled()
    assert tseg.current_impl() == base
    for bad in (lambda: tseg.use_impl("bogus").__enter__(),
                lambda: tseg.set_segment_impl("bogus")):
        with pytest.raises(ValueError, match="unknown segment impl"):
            bad()
    tseg.set_segment_impl("scan")
    try:
        assert tseg.current_impl() == "scan" and not tseg.stream_enabled()
    finally:
        tseg.set_segment_impl(base)
    x = torch.randn(gt.num_nodes_padded, 4, requires_grad=True)
    with tseg.use_impl("scatter"):
        y = tseg.gather_senders(x, gt)
    y.sum().backward()  # outside the scope: still the forward's scatter
    assert stream_calls == []
    y = tseg.gather_senders(x, gt)
    with tseg.use_impl("scatter"):
        y.sum().backward()
    assert stream_calls == [4]


@pytest.mark.parametrize("impl", ["stream", "scatter"])
def test_gathers_and_takes_match_jax(graphs, impl):
    """``gather_receivers_hn`` ([H, N] -> [H, E]), ``gather_receivers``,
    ``gather_senders``, ``take_receivers`` and ``take_senders``: values
    and VJPs against the JAX package's (cotangents zero on padding edges,
    whose data the JAX CPU lowering adds into a tile's last row)."""
    gj, gt, _ = graphs["aligned"]
    rng = np.random.default_rng(9)
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    live = np.asarray(gj.edge_mask)[:, None]
    x_hn = rng.standard_normal((H, n)).astype(np.float32)
    x = rng.standard_normal((n, 7)).astype(np.float32)
    ct_he = (rng.standard_normal((H, e)) * live.T).astype(np.float32)
    ct = (rng.standard_normal((e, 7)) * live).astype(np.float32)
    cases = [
        (lambda v: jseg.gather_receivers_hn(v, gj),
         lambda v: tseg.gather_receivers_hn(v, gt), x_hn, ct_he),
        (lambda v: jseg.gather_receivers(v, gj),
         lambda v: tseg.gather_receivers(v, gt), x, ct),
        (lambda v: jseg.gather_senders(v, gj),
         lambda v: tseg.gather_senders(v, gt), x, ct),
        (lambda v: jseg.take_receivers(v, gj.receivers, gj.row_ptr),
         lambda v: tseg.take_receivers(v, gt.receivers, gt.row_ptr), x, ct),
        (lambda v: jseg.take_senders(v, gj.senders, gj.col_perm, gj.col_ptr),
         lambda v: tseg.take_senders(v, gt.senders, gt.col_perm, gt.col_ptr),
         x, ct),
    ]
    for jfn, tfn, v, c in cases:
        want, vjp = jax.vjp(jfn, jnp.asarray(v))
        (want_g,) = vjp(jnp.asarray(c))
        tv = torch.tensor(v, requires_grad=True)
        with tseg.use_impl(impl):
            got = tfn(tv)
        got.backward(torch.from_numpy(c))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want_g),
                                   **VAL)


@pytest.mark.parametrize("side", ["receiver", "sender"])
def test_stream_expand_matches_jax(graphs, side):
    """``stream_expand`` over either stream side: the expand (bit-exact,
    zeros at dead slots) and its VJP, the stream segment sum on the same
    side, against the JAX package's (in interpret mode)."""
    gj, gt, _ = graphs["aligned"]
    rng = np.random.default_rng(13)
    n = gt.num_nodes_padded
    lj, cj = ((gj.r_local, gj.r_chunk) if side == "receiver"
              else (gj.c_local, gj.c_chunk))
    lt, ct_, walk = ((gt.r_local, gt.r_chunk, gt.stream_walk)
                     if side == "receiver"
                     else (gt.c_local, gt.c_chunk, gt.sender_walk))
    x = rng.standard_normal((n, 9)).astype(np.float32)
    c = rng.standard_normal((lt.shape[0], 9)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda v: jlarge.stream_expand(v, lj, cj, n, "high", True),
        jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(c))
    tv = torch.tensor(x, requires_grad=True)
    got = tlarge.stream_expand(tv, lt, ct_, n, walk=walk)
    got.backward(torch.from_numpy(c))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # the JAX VJP sums in 'high' (two bf16 limbs, about 1e-5 of each term;
    # tests/test_torch_stream.py's bound), so it is held at that bound and
    # the same sum in f64 at the value tolerance
    scale = float(np.abs(np.asarray(want_g)).max())
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want_g),
                               atol=5e-5 * scale)
    exact = stream_scatter_plain(torch.from_numpy(c), lt, ct_, n,
                                 f64=True)
    np.testing.assert_allclose(tv.grad.numpy(), exact.numpy(), **VAL)


# ---------------------------------------------------------------------------
# The single-head layers against the torch goldens
# ---------------------------------------------------------------------------

LAYER_TYPES = ("GAT", "GAT_sparse", "GATv2", "GATv2_sparse")
LAYER_FNS = {"GAT": tlayers.gat_v1_dense, "GAT_sparse": tlayers.gat_v1_sparse,
             "GATv2": tlayers.gat_v2_dense,
             "GATv2_sparse": tlayers.gat_v2_sparse}


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    adj = z["adj"]
    n = adj.shape[0]
    g = from_scipy(sp.coo_matrix(adj), device="cpu")
    h = np.zeros((g.num_nodes_padded, z["h"].shape[1]), np.float32)
    h[:n] = z["h"]
    return z, g, torch.from_numpy(h), n


def _golden_params(z, lt, skip):
    cls = tlayers.V2Params if lt.startswith("GATv2") else tlayers.V1Params
    return cls(torch.from_numpy(z[f"{lt}/W"].astype(np.float32)),
               torch.from_numpy(z[f"{lt}/a"].astype(np.float32)[:, 0]),
               torch.from_numpy(z[f"{lt}/skip"].astype(np.float32))
               if skip else None)


def _golden_masks(z, g, lt, n):
    """The golden boolean masks padded to the graph's shapes (padding keeps:
    its rows hold zeros or are masked downstream)."""
    n_pad = g.num_nodes_padded

    def rows(m):
        out = np.ones((n_pad, m.shape[1]), bool)
        out[:n] = m
        return torch.from_numpy(out)

    att = z[f"train/{lt}/m_att"]
    if lt.endswith("_sparse"):
        recv, send = g.receivers.numpy(), g.senders.numpy()
        live = g.edge_mask.numpy()
        m_att = np.ones(g.num_edges_padded, bool)
        m_att[live] = att[recv[live], send[live]]
    else:
        m_att = np.ones((n_pad, n_pad), bool)
        m_att[:n, :n] = att
    return tlayers.DropoutMasks(
        rows(z[f"train/{lt}/m_in"]), rows(z[f"train/{lt}/m_proj"]),
        rows(z[f"train/{lt}/m_proj2"]) if lt.startswith("GATv2") else None,
        torch.from_numpy(m_att))


def _golden_layer(golden, lt, concat, skip, train):
    z, g, h, n = golden
    neigh = g if lt.endswith("_sparse") else g.to_dense(binary=True) > 0
    masks = _golden_masks(z, g, lt, n) if train else tlayers.NO_MASKS
    out = LAYER_FNS[lt](_golden_params(z, lt, skip), h, neigh, masks,
                        alpha=float(z["alpha"]),
                        drop=float(z["p_drop"]) if train else 0.0,
                        concat=concat, train=train)
    return out.numpy()[:n]


@pytest.mark.parametrize("concat,skip", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("lt", LAYER_TYPES)
def test_layer_matches_torch_golden(golden, lt, concat, skip):
    """Each single-head layer in eval against the goldens at 1e-4."""
    z = golden[0]
    np.testing.assert_allclose(
        _golden_layer(golden, lt, concat, skip, False),
        z[f"{lt}/out_c{int(concat)}_s{int(skip)}"], **GOLDEN_TOL)


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("lt", LAYER_TYPES)
def test_train_mode_matches_torch_golden(golden, lt, concat):
    """Each single-head layer in train mode with the goldens' keep masks
    (input, projections, attention numerators; the skip projection on)
    against the goldens at 1e-4."""
    z = golden[0]
    np.testing.assert_allclose(_golden_layer(golden, lt, concat, True, True),
                               z[f"train/{lt}/out_c{int(concat)}"],
                               **GOLDEN_TOL)
