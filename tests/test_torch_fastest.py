"""The ``fastest`` precision mode (one bf16 limb) of the PyTorch port against
the JAX package's, which runs its Pallas kernels in interpret mode under
``seg.use_impl("stream")`` with ``seg._STREAM_PRECISION = "fastest"``: row 1
(the stream segment sums, both sides), rows 2 and 3 (the fused GATv1 and
GATv2 attention, forward and VJP), the unfused segment sums, and the whole
2-layer GAT_sparse and GATv2_sparse models (forward and parameter
gradients, dropout off); and the errors: an unknown precision raises
``ValueError``. The band plan and the corner plans under ``fastest`` are
tests/test_torch_fastest_large.py's.

Both packages round at the same points (the operands and the messages to
bf16, to nearest with ties to even; the sums in f32), so they differ only
by the order of f32 sums and by the last bit of an exp, which may move a
rounded message to the neighbouring bf16 value. The tolerances below are
stated against the output's scale; each test also holds ``fastest`` away
from ``high``, so a ``precision`` that is ignored fails."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import gat as jgat
from pygat_tpu.ops import fused_stream as jfs
from pygat_tpu.ops import segment as jseg
from pygat_tpu.ops import stream as jstream
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models import layers as tlayers
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.ops import fused_stream as tfs
from pygat_tpu_torch.ops import segment as tseg
from pygat_tpu_torch.ops import stream as tstream

ALPHA = 0.2
# Row 1: the same rounded values summed in f32 in two orders differ by a
# small multiple of 6e-8 of the same sum over |data|.
SUM_RTOL = 1e-6
# Rows 2 and 3 and the models, forward: about 2^-8 of the output's scale
# (a message on the neighbouring bf16 value moves by at most 2^-7 of
# itself); the gradients: 2^-7 of the gradient's scale. The reference's
# own fastest-vs-scatter check (tests/test_fused.py) allows 3e-2 and 6e-2.
OUT_RTOL = 2.0 ** -8
GRAD_RTOL = 2.0 ** -7
# what 'fastest' must differ from 'high' by, relative to the output's scale
APART = 1e-5
# All but MOST_FRACTION of the elements agree within MOST_RTOL of the
# scale: a rounding point missed or added moves most elements by about
# 2^-9 of their scale, the order of f32 sums by about 1e-7, a message on
# the neighbouring bf16 value only the few rows it is summed into.
MOST_RTOL = 2.0 ** -12
MOST_FRACTION = 0.01


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(3)
    n = 300
    s = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    return (jbuild_graph(s, r, None, n),
            tbuild_graph(s, r, None, n, device="cpu"))


@pytest.fixture
def fastest_default(monkeypatch):
    """The port's module default set to 'fastest' for one test (restored
    after it)."""
    monkeypatch.setattr(tseg, "_STREAM_PRECISION", "fastest")


def _jax_fastest(fn):
    """``fn()`` under the JAX package's stream impl and 'fastest' default,
    restored after."""
    prev = jseg._STREAM_PRECISION
    jseg._STREAM_PRECISION = "fastest"
    try:
        with jseg.use_impl("stream"):
            return fn()
    finally:
        jseg._STREAM_PRECISION = prev


def _scale(a) -> float:
    return max(float(np.abs(np.asarray(a)).max()), 1e-30)


def _held(got, want, rtol, what=""):
    """``got`` within ``rtol`` of ``want``'s scale everywhere, and within
    MOST_RTOL of it in all but MOST_FRACTION of the elements."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want) / _scale(want)
    assert float(err.max()) <= rtol, (what, float(err.max()))
    assert float((err > MOST_RTOL).mean()) <= MOST_FRACTION, (
        what, float((err > MOST_RTOL).mean()))


# -- row 1: the stream segment sums -------------------------------------------


@pytest.mark.parametrize("side", ["recv", "send"])
@pytest.mark.parametrize("width", [1, 7, 64])
def test_stream_scatter_fastest_matches_jax(graphs, side, width):
    """The port's one-limb segment sum against the JAX kernel's
    (``precision='fastest'``, interpret mode) on the same data: within 1e-6
    of the same sums over |data|; and apart from the port's 'high'."""
    gj, gt = graphs
    n_pad = gj.num_nodes_padded
    rng = np.random.default_rng(width + (0 if side == "recv" else 50))
    data = rng.standard_normal((gj.num_edges_padded, width)).astype(np.float32)

    if side == "recv":
        want = jax.jit(lambda d: jstream.stream_scatter(
            d, gj.r_local, gj.r_chunk, n_pad, precision="fastest",
            interpret=True))(jnp.asarray(data))
        lay = (gt.r_local, gt.r_chunk, n_pad)
        kw = {}
    else:
        want = jax.jit(lambda d: jstream.stream_sender_segment_sum(
            d, gj.senders, gj.c_slot, gj.c_local, gj.c_chunk, None, n_pad,
            "fastest", True))(jnp.asarray(data))
        lay = (gt.c_local, gt.c_chunk, n_pad)
        kw = dict(slot=gt.c_slot)
    d = torch.from_numpy(data)
    got = tstream.stream_scatter(d, *lay, precision="fastest", **kw)
    high = tstream.stream_scatter(d, *lay, **kw)
    mag = tstream.stream_scatter_plain(d.abs(), *lay, **kw)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= SUM_RTOL * mag.numpy() + 1e-30).all(), float(err.max())
    assert float((got - high).abs().max()) > APART * _scale(want)
    # the wrapper counting the one-limb kernel takes the same path
    torch.testing.assert_close(
        tstream.stream_scatter_bf16(d, *lay, **kw), got, rtol=0, atol=0)


def test_stream_scatter_plain_fastest_rounds_before_the_f64_sum(graphs):
    """The plain version under 'fastest' returns f32 sums of the bf16-rounded
    data, in f32 or (``f64=True``) in f64."""
    _, gt = graphs
    n_pad = gt.num_nodes_padded
    rng = np.random.default_rng(11)
    d = torch.from_numpy(rng.standard_normal(
        (gt.num_edges_padded, 5)).astype(np.float32))
    lay = (gt.r_local, gt.r_chunk, n_pad)
    rounded = d.to(torch.bfloat16).float()
    for f64 in (False, True):
        got = tstream.stream_scatter_plain(d, *lay, f64=f64,
                                           precision="fastest")
        assert got.dtype == torch.float32
        torch.testing.assert_close(
            got, tstream.stream_scatter_plain(rounded, *lay, f64=f64),
            rtol=0, atol=0)


# -- rows 2 and 3: the fused attention ops ------------------------------------


def _v1_inputs(g, h, f, seed):
    """wh, f_dst, bound (as the layer builds it), a_src, keepq (dropout keep
    factors, p = 0.4) and the cotangents, from one numpy seed."""
    rng = np.random.default_rng(seed)
    n, e = g.num_nodes_padded, g.num_edges_padded
    wh = rng.standard_normal((n, h * f)).astype(np.float32) * 0.5
    a = rng.standard_normal((h, 2 * f)).astype(np.float32) * 0.5
    wh3 = wh.reshape(n, h, f)
    f_dst = np.einsum("nho,ho->nh", wh3, a[:, :f]).astype(np.float32)
    f_src = np.einsum("nho,ho->nh", wh3, a[:, f:])
    m_src = np.where(np.asarray(g.node_mask)[:, None], f_src, -np.inf).max(0)
    raw = f_dst + m_src[None]
    bound = np.where(raw >= 0, raw, ALPHA * raw).astype(np.float32)
    keepq = np.where(rng.random((e, h)) < 0.6, 1.0 / 0.6, 0.0).astype(
        np.float32)
    g_out = rng.standard_normal((n, h * f)).astype(np.float32)
    g_den = rng.standard_normal((n, h)).astype(np.float32)
    return (dict(wh=wh, f_dst=f_dst, a_src=np.ascontiguousarray(a[:, f:])),
            dict(bound=bound, keepq=keepq), (g_out, g_den))


def _v2_inputs(g, h, f, seed):
    """whi, whj, a, ub (the layer's sign-split bound), keepq and the
    cotangents, from one numpy seed."""
    rng = np.random.default_rng(seed)
    n, e = g.num_nodes_padded, g.num_edges_padded
    whi = rng.standard_normal((n, h * f)).astype(np.float32) * 0.5
    whj = rng.standard_normal((n, h * f)).astype(np.float32) * 0.5
    a = rng.standard_normal((h, f)).astype(np.float32) * 0.5
    mask = np.asarray(g.node_mask)[:, None]
    hi = np.where(mask, whj, -np.inf).max(0).reshape(1, h, f)
    lo = np.where(mask, whj, np.inf).min(0).reshape(1, h, f)
    whi3 = whi.reshape(n, h, f)

    def leaky(x):
        return np.where(x >= 0, x, ALPHA * x)

    ub = (np.einsum("nhf,hf->nh", leaky(whi3 + hi), np.maximum(a, 0))
          + np.einsum("nhf,hf->nh", leaky(whi3 + lo), np.minimum(a, 0)))
    keepq = np.where(rng.random((e, h)) < 0.6, 1.0 / 0.6, 0.0).astype(
        np.float32)
    g_out = rng.standard_normal((n, h * f)).astype(np.float32)
    g_den = rng.standard_normal((n, h)).astype(np.float32)
    return (dict(whi=whi, whj=whj, a=a),
            dict(ub=ub.astype(np.float32), keepq=keepq), (g_out, g_den))


def _jax_fused(which, gj, leaves, fixed, cts):
    """(out, den, grads of the leaves) of the JAX op under 'fastest',
    jitted (interpret mode op by op costs several times the compile)."""
    if which == "v1":
        def fn(wh, f_dst, a_src):
            return jfs.fused_v1_attention(
                wh, f_dst, jnp.asarray(fixed["bound"]), a_src,
                jnp.asarray(fixed["keepq"]), gj.senders, gj.receivers,
                gj.r_local, gj.r_chunk, gj.c_slot, gj.c_local, gj.c_chunk,
                ALPHA, "fastest", True)
    else:
        def fn(whi, whj, a):
            return jfs.fused_v2_attention(
                whi, whj, jnp.asarray(fixed["ub"]), a,
                jnp.asarray(fixed["keepq"]), gj.senders, gj.receivers,
                gj.r_local, gj.r_chunk, gj.c_slot, gj.c_local, gj.c_chunk,
                ALPHA, "fastest", True)

    @jax.jit
    def run(*xs):
        (out, den), vjp = jax.vjp(fn, *xs)
        return out, den, vjp(tuple(jnp.asarray(c) for c in cts))

    return run(*(jnp.asarray(v) for v in leaves.values()))


def _torch_fused(which, gt, leaves, fixed, cts, precision):
    xs = [torch.tensor(v, requires_grad=True) for v in leaves.values()]
    op = tfs.fused_v1_attention if which == "v1" else tfs.fused_v2_attention
    shift = fixed["bound"] if which == "v1" else fixed["ub"]
    out, den = op(xs[0], xs[1], torch.from_numpy(shift), xs[2],
                  torch.from_numpy(fixed["keepq"]), gt.senders, gt.receivers,
                  gt.r_local, gt.r_chunk, gt.c_slot, gt.c_local, gt.c_chunk,
                  ALPHA, precision=precision)
    grads = torch.autograd.grad((out, den), xs,
                                tuple(torch.from_numpy(c) for c in cts))
    return out.detach(), den.detach(), grads


@pytest.mark.parametrize("which", ["v1", "v2"])
@pytest.mark.parametrize("h,f", [(4, 8), (1, 7)])
def test_fused_attention_fastest_matches_jax(graphs, which, h, f):
    """Rows 2 and 3 under 'fastest': forward (out, den) and the gradients of
    the three differentiable inputs against the JAX op's."""
    gj, gt = graphs
    make = _v1_inputs if which == "v1" else _v2_inputs
    leaves, fixed, cts = make(gj, h, f, 10 * h + f)
    out_j, den_j, grads_j = _jax_fused(which, gj, leaves, fixed, cts)
    out_t, den_t, grads_t = _torch_fused(which, gt, leaves, fixed, cts,
                                         "fastest")
    _held(out_t, out_j, OUT_RTOL, "out")
    _held(den_t, den_j, OUT_RTOL, "den")
    for name, gt_, gj_ in zip(leaves, grads_t, grads_j):
        _held(gt_, gj_, GRAD_RTOL, name)
    out_h, _, _ = _torch_fused(which, gt, leaves, fixed, cts, "high")
    assert float((out_t - out_h).abs().max()) > APART * _scale(out_j)


@pytest.mark.parametrize("which", ["v1", "v2"])
def test_fused_plain_fastest_f64_matches_f32(graphs, which):
    """The plain versions under 'fastest' round at the same points in f32
    and in f64 (the kernels' oracle on the card)."""
    _, gt = graphs
    make = _v1_inputs if which == "v1" else _v2_inputs
    leaves, fixed, _ = make(gt, 4, 8, 5)
    t = {k: torch.from_numpy(v) for k, v in {**leaves, **fixed}.items()}
    if which == "v1":
        args = (t["wh"], t["f_dst"], t["bound"], t["a_src"], t["keepq"])
        plain = tfs.fused_v1_plain
    else:
        args = (t["whi"], t["whj"], t["ub"], t["a"], t["keepq"])
        plain = tfs.fused_v2_plain
    args += (gt.senders, gt.r_local, gt.r_chunk, ALPHA)
    f32 = plain(*args, precision="fastest")
    f64 = plain(*args, precision="fastest", f64=True)
    for a, b in zip(f32, f64):
        torch.testing.assert_close(a, b, rtol=0, atol=OUT_RTOL * float(
            b.abs().max()))


# -- the unfused sums ---------------------------------------------------------


@pytest.mark.parametrize("side", ["receivers", "senders"])
def test_unfused_segment_sums_fastest_match_jax(graphs, side):
    """``segment_sum_receivers`` / ``segment_sum_senders`` with
    ``precision='fastest'`` against the JAX package's under the stream impl,
    forward and the gradient (a gather, exact); and the module default."""
    gj, gt = graphs
    rng = np.random.default_rng(21)
    data = rng.standard_normal((gj.num_edges_padded, 9)).astype(np.float32)
    data *= np.asarray(gj.edge_mask)[:, None]  # the layers' data: 0 on padding
    cot = rng.standard_normal((gj.num_nodes_padded, 9)).astype(np.float32)
    jfn = getattr(jseg, f"segment_sum_{side}")
    tfn = getattr(tseg, f"segment_sum_{side}")

    def run():
        return jax.jit(lambda d: jax.vjp(
            lambda x: jfn(x, gj, precision="fastest"), d)[1](
                jnp.asarray(cot))[0])(jnp.asarray(data)), jax.jit(
            lambda d: jfn(d, gj, precision="fastest"))(jnp.asarray(data))

    want_g, want = _jax_fastest(run)
    d = torch.tensor(data, requires_grad=True)
    got = tfn(d, gt, precision="fastest")
    (got_g,) = torch.autograd.grad(got, d, torch.from_numpy(cot))
    mag = tfn(torch.from_numpy(np.abs(data)), gt)
    err = np.abs(got.detach().numpy() - np.asarray(want))
    assert (err <= SUM_RTOL * mag.numpy() + 1e-30).all(), float(err.max())
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    got = got.detach()
    high = tfn(torch.from_numpy(data), gt, precision="high")
    assert float((got - high).abs().max()) > APART * _scale(want)
    tseg._STREAM_PRECISION, prev = "fastest", tseg._STREAM_PRECISION
    try:
        torch.testing.assert_close(tfn(torch.from_numpy(data), gt), got,
                                   rtol=0, atol=0)
    finally:
        tseg._STREAM_PRECISION = prev
    # the scatter impl sums in f32 whatever the precision, as the JAX one
    with tseg.use_impl("scatter"):
        torch.testing.assert_close(
            tfn(torch.from_numpy(data), gt, precision="fastest"), high,
            rtol=0, atol=1e-5 * _scale(want))


# -- the whole models ---------------------------------------------------------


@pytest.fixture(scope="module")
def features(graphs):
    gj, _ = graphs
    rng = np.random.default_rng(4)
    return (rng.standard_normal((gj.num_nodes_padded, 32)) * 0.5).astype(
        np.float32)


def _model_cfg(layer_type):
    kw = dict(nlayers=2, nheads=(4, 2), nfeats=(32, 8, 4), dropout=0.0,
              alpha=ALPHA, layer_type=layer_type, skip_connection=True)
    return jgat.GATConfig(**kw), tgat.GATConfig(**kw)


def _torch_model(cfg_t, tparams, x, gt):
    out = tgat.apply_gat(tparams, cfg_t, torch.from_numpy(x), gt, None,
                         train=False)
    torch.sin(out).sum().backward()
    grads = torch.cat([p.grad.reshape(-1) for p in tgat.parameters(tparams)])
    return out.detach().numpy(), grads.numpy()


@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_sparse_models_fastest_match_jax(graphs, features, layer_type,
                                         fastest_default):
    """Both 2-layer sparse models under the 'fastest' default (the fused
    op over the receiver stream and its backward's stream sums), forward
    and parameter gradients, dropout off, against the JAX package's."""
    gj, gt = graphs
    cfg_j, cfg_t = _model_cfg(layer_type)
    jparams = jgat.init_gat(jax.random.PRNGKey(0), cfg_j)

    def loss(p):
        out = jgat.apply_gat(p, cfg_j, jnp.asarray(features), gj,
                             jax.random.PRNGKey(1), train=False)
        return jnp.sum(jnp.sin(out)), out

    def run():
        assert jfs.fused_enabled(gj)
        return jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)

    (_, out_j), grads_j = _jax_fastest(run)
    grads_j = np.asarray(ravel_pytree(grads_j)[0])
    numpy_params = [tuple(None if t is None else np.asarray(t) for t in p)
                    for p in jparams]
    assert tfs.fused_enabled(gt)
    out_t, grads_t = _torch_model(
        cfg_t, params_from_jax(numpy_params, device="cpu"), features, gt)
    _held(out_t, out_j, OUT_RTOL, "out")
    _held(grads_t, grads_j, GRAD_RTOL, "gradients")
    tseg._STREAM_PRECISION = "high"
    out_h, _ = _torch_model(
        cfg_t, params_from_jax(numpy_params, device="cpu"), features, gt)
    assert float(np.abs(out_t - out_h).max()) > APART * _scale(out_j)


# -- errors -------------------------------------------------------------------


def _layer_call(layer_type, gt, plan):
    """One sparse layer over ``plan`` at small widths (random parameters)."""
    rng = np.random.default_rng(2)
    n, h, f_in, f_out = gt.num_nodes_padded, 2, 6, 3
    x = torch.from_numpy(rng.standard_normal((n, f_in)).astype(np.float32))
    if layer_type == "GAT_sparse":
        params = tlayers.V1Params(
            W=torch.from_numpy(rng.standard_normal(
                (h, f_in, f_out)).astype(np.float32)),
            a=torch.from_numpy(rng.standard_normal(
                (h, 2 * f_out)).astype(np.float32)), skip=None)
        layer = tlayers.gat_v1_sparse_heads
    else:
        params = tlayers.V2Params(
            W=torch.from_numpy(rng.standard_normal(
                (h, 2 * f_in, f_out)).astype(np.float32)),
            a=torch.from_numpy(rng.standard_normal(
                (h, f_out)).astype(np.float32)), skip=None)
        layer = tlayers.gat_v2_sparse_heads
    return layer(params, x, gt, None, alpha=ALPHA, drop=0.0, concat=True,
                 train=False, plan=plan)


def test_unknown_precision_raises(graphs, monkeypatch):
    """Every op that takes a precision, and the module default, refuse one
    that is neither 'high' nor 'fastest'."""
    _, gt = graphs
    n_pad, e = gt.num_nodes_padded, gt.num_edges_padded
    data = torch.zeros(e, 3)
    leaves, fixed, _ = _v1_inputs(gt, 2, 3, 1)
    t = {k: torch.from_numpy(v) for k, v in {**leaves, **fixed}.items()}
    v1 = (t["wh"], t["f_dst"], t["bound"], t["a_src"], t["keepq"],
          gt.senders, gt.r_local, gt.r_chunk, ALPHA)
    for call in (
            lambda: tstream.stream_scatter(data, gt.r_local, gt.r_chunk,
                                           n_pad, precision="medium"),
            lambda: tstream.stream_scatter_plain(data, gt.r_local,
                                                 gt.r_chunk, n_pad,
                                                 precision="bf16"),
            lambda: tstream.stream_segment_sum(data, gt.receivers,
                                               gt.r_local, gt.r_chunk, n_pad,
                                               precision="low"),
            lambda: tseg.segment_sum_receivers(data, gt, precision="HIGH"),
            lambda: tfs.fused_v1(*v1, precision="fast"),
            lambda: tfs.fused_v1_attention(
                *v1[:5], gt.senders, gt.receivers, gt.r_local, gt.r_chunk,
                gt.c_slot, gt.c_local, gt.c_chunk, ALPHA, precision="x")):
        with pytest.raises(ValueError, match="unknown precision"):
            call()
    monkeypatch.setattr(tseg, "_STREAM_PRECISION", "half")
    with pytest.raises(ValueError, match="PYGAT_STREAM_PRECISION"):
        _layer_call("GAT_sparse", gt, None)
    with pytest.raises(ValueError, match="PYGAT_STREAM_PRECISION"):
        tseg.segment_sum_senders(data, gt)


def test_unset_default_is_high():
    """With PYGAT_STREAM_PRECISION unset the port's default is 'high' (the
    reference's is 'fastest'; its auto impl sums in f32 off the TPU, so
    'high' keeps the port's CPU runs equal to it); set, the module reads
    it at import (one fresh process, the module reloaded in it)."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k != "PYGAT_STREAM_PRECISION"}
    code = ("import importlib, os; "
            "from pygat_tpu_torch.ops import segment as s; "
            "print(s._STREAM_PRECISION, s.stream_precision()); "
            "os.environ['PYGAT_STREAM_PRECISION'] = 'fastest'; "
            "importlib.reload(s); "
            "print(s._STREAM_PRECISION, s.stream_precision())")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["high", "high", "fastest", "fastest"]
