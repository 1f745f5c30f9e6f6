"""The PyTorch port's segment, SpMM and SDDMM ops (their plain versions,
which the CPU runs) against the JAX package on the same graph: the
segment-sum and gather subset of ``ops/segment.py``, ``spmm``, ``sddmm``,
``spmm_graph``, ``sddmm_graph`` and ``spmm_corner_graph``, forward and the
gradient of every differentiable input.

Tolerances: against an f32 XLA reference, 1e-5 of max(1, max |JAX|) (sums
in another order); against a JAX Pallas kernel in interpret mode at
``high`` precision, which sums two bf16 limbs (about 16 mantissa bits),
2e-5 of the same sum over the terms' magnitudes."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import large as jlarge
from pygat_tpu.ops import segment as jseg
from pygat_tpu.ops.sddmm import sddmm as jsddmm
from pygat_tpu.ops.sddmm import sddmm_graph as jsddmm_graph
from pygat_tpu.ops.spmm import spmm as jspmm
from pygat_tpu.ops.spmm import spmm_graph as jspmm_graph
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import ops
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops.large import plan_csc_to_csr as tplan_csc_to_csr
from pygat_tpu_torch.ops.spmm import spmm_backward

L = 24


@pytest.fixture(scope="module")
def setup():
    """A uniform graph of 300 nodes in both packages, node rows, per-edge
    values (also on the padding edges, which must be ignored) and a
    cotangent."""
    rng = np.random.default_rng(5)
    n = 300
    s = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    n_pad, e_s = gt.num_nodes_padded, gt.num_edges_padded
    x = rng.standard_normal((n_pad, L)).astype(np.float32)
    b = rng.standard_normal((n_pad, L)).astype(np.float32)
    w = rng.standard_normal(e_s).astype(np.float32)
    ct = rng.standard_normal((n_pad, L)).astype(np.float32)
    ct_e = rng.standard_normal(e_s).astype(np.float32)
    return gj, gt, x, b, w, ct, ct_e


def _jax_vjp(fn, primals, ct):
    @jax.jit
    def run(*p):
        out, vjp = jax.vjp(fn, *p)
        return (out,) + tuple(vjp(ct))

    return [np.asarray(a) for a in run(*(jnp.asarray(p) for p in primals))]


def _torch_vjp(fn, primals, ct):
    leaves = [torch.tensor(p, requires_grad=True) for p in primals]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _assert_close(got, want, what, mag=None):
    """1e-5 of max(1, max |want|); with ``mag`` (the same sum over the
    terms' magnitudes), 2e-5 of it elementwise."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    if mag is None:
        allowed = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert float(err.max()) <= allowed, (what, float(err.max()), allowed)
    else:
        assert bool((err <= 2e-5 * np.asarray(mag) + 1e-6).all()), (
            what, float(err.max()))


@contextlib.contextmanager
def _jax_stream_high():
    """The JAX package's stream kernel (interpret mode) at 'high' precision,
    for the traces in the body; its module default is 'fastest'."""
    prev = jseg._STREAM_PRECISION
    jseg._STREAM_PRECISION = "high"
    try:
        with jseg.use_impl("stream"):
            yield
    finally:
        jseg._STREAM_PRECISION = prev


def _spmm_mags(gt, w, x, ct):
    """The SpMM's forward, d values and d x over |values|, |x| and |ct|."""
    args = (gt.senders, gt.receivers, gt.edge_mask)
    aw, ax, act = (torch.from_numpy(np.abs(a)) for a in (w, x, ct))
    out = ops.spmm(aw, ax, *args)
    dv, dx = spmm_backward(act, aw, ax, *args)
    return out.numpy(), dv.numpy(), dx.numpy()


@pytest.mark.parametrize("side", ["receivers", "senders"])
def test_segment_sum_matches_jax(setup, side):
    gj, gt, *_ = setup
    data = np.random.default_rng(1).standard_normal(
        (gt.num_edges_padded, 3, 5)).astype(np.float32)
    ids = getattr(gt, side)
    sorted_ids = side == "receivers"
    want = jseg.segment_sum(jnp.asarray(data), getattr(gj, side),
                            gt.num_nodes_padded, sorted_ids=sorted_ids)
    got = ops.segment_sum(torch.from_numpy(data), ids, gt.num_nodes_padded,
                          sorted_ids=sorted_ids)
    assert got.shape == want.shape
    _assert_close(got.numpy(), want, "segment_sum")


@pytest.mark.parametrize("name,shape", [
    ("gather_senders", (None, 7)), ("gather_receivers", (None, 7)),
    ("segment_sum_receivers", ("e", 7)), ("segment_sum_senders", ("e", 7)),
    ("segment_sum_receivers", ("e",)), ("segment_sum_senders", ("e", 2, 3)),
])
def test_segment_ops_match_jax(setup, name, shape):
    """Forward and gradient: a gather's gradient is the stream segment sum
    of the opposite side, a segment sum's is a gather. Edge data of any
    trailing shape, [E] included. The edge data is zero on the padding
    edges, as the layers leave it: the JAX package's CPU lowering (sorted
    scans) adds padding edges into row t*128+127 of their tile, its stream
    kernel and the port drop them (tested below)."""
    gj, gt, *_ = setup
    rng = np.random.default_rng(2)
    on_edges = shape[0] == "e"
    rows = gt.num_edges_padded if on_edges else gt.num_nodes_padded
    other = gt.num_nodes_padded if on_edges else gt.num_edges_padded
    live = np.asarray(gt.edge_mask).reshape((-1,) + (1,) * (len(shape) - 1))
    data = rng.standard_normal((rows,) + shape[1:]).astype(np.float32)
    ct = rng.standard_normal((other,) + shape[1:]).astype(np.float32)
    if on_edges:
        data = data * live
    else:
        ct = ct * live
    want = _jax_vjp(lambda d: getattr(jseg, name)(d, gj), (data,),
                    jnp.asarray(ct))
    got = _torch_vjp(lambda d: getattr(ops, name)(d, gt), (data,), ct)
    for a, b_, what in zip(got, want, ("forward", "gradient")):
        assert a.shape == b_.shape
        _assert_close(a, b_, f"{name} {what}")


@pytest.mark.parametrize("side", ["receivers", "senders"])
def test_stream_segment_sums_drop_padding_edges(setup, side):
    """Over the stream layouts, what the padding edges carry reaches no real
    node: the receiver side drops them (dead slots), the sender side adds
    them into the dummy row N_pad - 1, their sender."""
    _, gt, *_ = setup
    data = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (gt.num_edges_padded, 4)).astype(np.float32))
    fn = getattr(ops, f"segment_sum_{side}")
    clean = torch.where(gt.edge_mask[:, None], data, 0.0)
    got, want = fn(data, gt), fn(clean, gt)
    rows = slice(None) if side == "receivers" else slice(0, -1)
    assert torch.equal(got[rows], want[rows])
    assert not want[-1].any()
    assert float(got.abs().max()) > 1.0


def test_spmm_matches_jax(setup):
    gj, gt, x, _, w, ct, _ = setup
    want = _jax_vjp(lambda v, d: jspmm(v, d, gj.senders, gj.receivers,
                                       gj.edge_mask), (w, x), jnp.asarray(ct))
    got = _torch_vjp(lambda v, d: ops.spmm(v, d, gt.senders, gt.receivers,
                                           gt.edge_mask), (w, x), ct)
    for a, b_, what in zip(got, want, ("out", "d values", "d dense")):
        _assert_close(a, b_, f"spmm {what}")
    assert float(np.abs(got[0]).max()) > 1.0  # the comparison is not idle


@pytest.mark.parametrize("impl", ["auto", "stream"])
def test_spmm_graph_matches_jax(setup, impl):
    """Against the JAX package's own CPU lowering (its sorted scans) and
    against its stream kernel at 'high' precision, in interpret mode."""
    gj, gt, x, _, w, ct, _ = setup
    fn = lambda v, d: jspmm_graph(jnp.where(gj.edge_mask, v, 0.0), d, gj)  # noqa: E731
    with _jax_stream_high() if impl == "stream" else contextlib.nullcontext():
        want = _jax_vjp(fn, (w, x), jnp.asarray(ct))
    got = _torch_vjp(lambda v, d: ops.spmm_graph(v, d, gt), (w, x), ct)
    mags = _spmm_mags(gt, w, x, ct) if impl == "stream" else (None,) * 3
    for a, b_, mag, what in zip(got, want, mags, ("out", "d values", "d x")):
        _assert_close(a, b_, f"spmm_graph {what}", mag)


def test_sddmm_matches_jax(setup):
    gj, gt, x, b, _, _, ct_e = setup
    want = _jax_vjp(lambda p, q: jsddmm(p, q, gj.senders, gj.receivers,
                                        gj.edge_mask), (x, b),
                    jnp.asarray(ct_e))
    got = _torch_vjp(lambda p, q: ops.sddmm(p, q, gt.senders, gt.receivers,
                                            gt.edge_mask), (x, b), ct_e)
    for a, b_, what in zip(got, want, ("out", "d a", "d b")):
        _assert_close(a, b_, f"sddmm {what}")


def test_sddmm_graph_matches_jax(setup):
    gj, gt, x, b, _, _, ct_e = setup
    want = _jax_vjp(lambda p, q: jsddmm_graph(p, q, gj), (x, b),
                    jnp.asarray(ct_e))
    got = _torch_vjp(lambda p, q: ops.sddmm_graph(p, q, gt), (x, b), ct_e)
    for a, b_, what in zip(got, want, ("out", "d a", "d b")):
        _assert_close(a, b_, f"sddmm_graph {what}")
    assert float(np.abs(got[0]).max()) > 1.0
    assert not np.abs(got[0][~np.asarray(gt.edge_mask)]).any()


def test_spmm_corner_graph_matches_jax(setup):
    """Corner plans with a span cap of 3 tiles (several passes and overflow
    rows both ways) in both packages; the JAX op runs its expand, permute
    and stream kernels in interpret mode at 'high' precision."""
    gj, gt, x, _, w, ct, _ = setup
    pj = jlarge.plan_csc_to_csr(gj, p_cap=3)
    pt = tplan_csc_to_csr(gt, p_cap=3)
    assert len(pt.fwd.passes) >= 2 and pt.fwd.overflow_total > 0
    want = _jax_vjp(lambda v, d: jlarge.spmm_corner_graph(v, d, gj, pj),
                    (w, x), jnp.asarray(ct))
    got = _torch_vjp(lambda v, d: ops.spmm_corner_graph(v, d, gt, pt),
                     (w, x), ct)
    mags = _spmm_mags(gt, w, x, ct)
    for a, b_, mag, what in zip(got, want, mags, ("out", "d values", "d x")):
        _assert_close(a, b_, f"spmm_corner_graph {what}", mag)


def test_spmm_corner_graph_bucketed_empty_tiles():
    """An explicit (n_pad, e_pad) bucket with empty tiles: the corner route
    equals the port's spmm_graph and the JAX package's, zeros past the real
    rows."""
    rng = np.random.default_rng(5)
    n = 150
    s = np.concatenate([rng.integers(0, n, 600), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, 600), np.arange(n)])
    gj = jbuild_graph(s, r, None, n, n_pad=512, e_pad=2048)
    gt = tbuild_graph(s, r, None, n, n_pad=512, e_pad=2048, device="cpu")
    x = rng.standard_normal((512, 32)).astype(np.float32)
    w = rng.random(gt.num_edges_padded).astype(np.float32)
    want = jspmm_graph(jnp.where(gj.edge_mask, w, 0.0), jnp.asarray(x), gj)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = ops.spmm_corner_graph(wt, xt, gt, tplan_csc_to_csr(gt))
    _assert_close(got.numpy(), want, "spmm_corner_graph")
    _assert_close(ops.spmm_graph(wt, xt, gt).numpy(), want, "spmm_graph")
    assert not got[192:].any()


@pytest.mark.parametrize("kw,err", [
    (dict(precision="fastest"), None),
    (dict(precision="medium"), ValueError), (dict(mode="gather"), ValueError),
], ids=["kw0-NotImplementedError", "kw1-ValueError", "kw2-ValueError"])
def test_spmm_corner_graph_rejects_what_it_lacks(setup, kw, err):
    """An unknown precision or mode raises; 'fastest' runs (one bf16 limb:
    another result than the default 'high', whose rounding
    tests/test_torch_fastest_spmm.py holds to the JAX package's); 'take'
    and 'onehot' are accepted."""
    _, gt, x, _, w, _, _ = setup
    pt = tplan_csc_to_csr(gt)
    args = (torch.from_numpy(w), torch.from_numpy(x), gt, pt)
    got = ops.spmm_corner_graph(*args, mode="take")
    assert torch.equal(got, ops.spmm_corner_graph(*args))
    if err is None:
        fastest = ops.spmm_corner_graph(*args, **kw)
        assert bool(torch.isfinite(fastest).all())
        assert 0 < float((fastest - got).abs().max()) <= 2.0 ** -7 * float(
            got.abs().max())
        return
    with pytest.raises(err, match="unknown"):
        ops.spmm_corner_graph(*args, **kw)
