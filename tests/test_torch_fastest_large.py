"""The ``fastest`` precision mode (one bf16 limb) of the PyTorch port over a
band plan and over the corner plans, against the JAX package's, which runs
its Pallas kernels in interpret mode: rows 5 and 6 (the banded take and the
banded sender sum), the banded fused attention ops and the corner attention
ops (forward and VJP), and the whole 2-layer GAT_sparse and GATv2_sparse
models over each order under the 'fastest' module default (forward and
parameter gradients, dropout off).

Both packages round at the same points (the interpret-mode contract of
tests/test_torch_fastest.py, whose tolerances these are): the forward as
the receiver stream's one-limb forward; the band plan's backward
recomputes its sender rows rounded to bf16 (the reference's ``exact=False``
take), the corner path's backward takes them unrounded (the reference's
passes run ``take`` in interpret mode, exact whatever the flag); both run
their two segment sums in one limb. Each case is also held away from
'high', so a ``precision`` that is ignored fails."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import gat as jgat
from pygat_tpu.ops import banded as jbd
from pygat_tpu.ops import fused_corner as jfc
from pygat_tpu.ops.large import plan_csc_to_csr as jplan_csc_to_csr
from tests.test_torch_fastest import (
    APART,
    GRAD_RTOL,
    OUT_RTOL,
    SUM_RTOL,
    _held,
    _jax_fastest,
    _scale,
    _v1_inputs,
    _v2_inputs,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops import fused_corner as tfc
from pygat_tpu_torch.ops import large as tlarge
from pygat_tpu_torch.ops import segment as tseg

ALPHA = 0.2
ORDERS = ("band plan", "corner plans")


@pytest.fixture(scope="module")
def band():
    """The graph and w = 2 band plan of tests/test_torch_banded_model.py
    (500 nodes, several chunks a tile, dead slots), in both packages, and
    features."""
    rng = np.random.default_rng(6)
    n = 500
    base = np.repeat(np.arange(n, dtype=np.int64), 6)
    s = np.clip(base + rng.integers(-180, 180, base.shape[0]), 0, n - 1)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([base, np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    x = (rng.standard_normal((gj.num_nodes_padded, 32)) * 0.5).astype(
        np.float32)
    return (gj, gt, jbd.build_band_plan(gj, w=2), tbd.build_band_plan(gt, w=2),
            x)


@pytest.fixture(scope="module")
def corner():
    """The uniform 200-node graph of tests/test_torch_corner_model.py and
    its corner plans, in both packages, and features."""
    rng = np.random.default_rng(6)
    n = 200
    s = np.concatenate([rng.integers(0, n, n * 4), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 4), np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    x = (rng.standard_normal((gj.num_nodes_padded, 32)) * 0.5).astype(
        np.float32)
    return gj, gt, jplan_csc_to_csr(gj), tlarge.plan_csc_to_csr(gt), x


@pytest.fixture
def order(request, band, corner):
    return band if request.param == "band plan" else corner


# -- rows 5 and 6 -------------------------------------------------------------


@pytest.mark.parametrize("width", [7, 64])
def test_banded_take_fastest_matches_jax(band, width):
    """Row 5 under 'fastest': the table's rows rounded to bf16, equal to
    the JAX ``_banded_take_impl(exact=False)`` (bf16, zeros at dead
    slots); apart from the exact take."""
    _, gt, pj, pt, _ = band
    table = np.random.default_rng(width).standard_normal(
        (gt.num_nodes_padded, width)).astype(np.float32)
    want = jax.jit(lambda t: jbd._banded_take_impl(
        t, pj.band, pj.s_loc, pj.w, exact=False, interpret=True))(
            jnp.asarray(table))
    t = torch.from_numpy(table)
    got = tbd.banded_take(t, pt, precision="fastest")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    torch.testing.assert_close(tbd.banded_take_bf16(t, pt), got, rtol=0,
                               atol=0)
    high = tbd.banded_take(t, pt)
    assert float((got.float() - high).abs().max()) > APART * _scale(table)


@pytest.mark.parametrize("width", [7, 64])
def test_banded_sender_sum_fastest_matches_jax(band, width):
    """Row 6 under 'fastest' (data on dead slots too, which must be
    ignored): within SUM_RTOL of the same sums over |data| of the JAX
    ``_banded_sender_sum_direct(precision='fastest')``; apart from
    'high'; the plain version's f64 sum of the rounded data too."""
    _, gt, pj, pt, _ = band
    n_pad = gt.num_nodes_padded
    data = np.random.default_rng(20 + width).standard_normal(
        (pt.num_slots, width)).astype(np.float32)
    want = np.asarray(jax.jit(lambda d: jbd._banded_sender_sum_direct(
        d, pj.bs_band, pj.bs_chunk, pj.bs_sloc, pj.w, n_pad, "fastest",
        True))(jnp.asarray(data)))
    d = torch.from_numpy(data)
    got = tbd.banded_sender_sum(d, pt, precision="fastest")
    mag = tbd.banded_sender_sum(d.abs(), pt).numpy()
    assert got.dtype == torch.float32
    for res in (got, tbd.banded_sender_sum_bf16(d, pt),
                tbd.banded_sender_sum_plain(d, pt, f64=True,
                                            precision="fastest")):
        err = np.abs(res.numpy() - want)
        assert (err <= SUM_RTOL * mag + 1e-30).all(), float(err.max())
    high = tbd.banded_sender_sum(d, pt)
    assert float((got - high).abs().max()) > APART * _scale(want)


# -- the banded and corner attention ops -------------------------------------


def _op_inputs(which, gt, e, h, f, seed):
    """tests/test_torch_fastest.py's inputs of the op on ``gt`` (the bound
    or ub as the layer builds it), keep factors drawn over ``e`` slots."""
    make = _v1_inputs if which == "v1" else _v2_inputs
    leaves, fixed, cts = make(gt, h, f, seed)
    rng = np.random.default_rng(seed + 1)
    fixed["keepq"] = np.where(rng.random((e, h)) < 0.6, 1.0 / 0.6,
                              0.0).astype(np.float32)
    return leaves, fixed, cts


def _jax_op(which, over, gj, pj, leaves, fixed, cts_list):
    """[(out, den, grads of the leaves)] of the JAX op under 'fastest',
    jitted once, for each pair of cotangents in ``cts_list``."""
    kw = dict(alpha=ALPHA, precision="fastest", interpret=True)
    shift, keepq = (jnp.asarray(fixed["bound" if which == "v1" else "ub"]),
                    jnp.asarray(fixed["keepq"]))
    if over == "band plan":
        op = (jbd.fused_v1_attention_banded if which == "v1"
              else jbd.fused_v2_attention_banded)

        def fn(x0, x1, x2):
            return op(x0, x1, shift, x2, keepq, pj, **kw)
    else:
        op = (jfc.fused_v1_attention_corner if which == "v1"
              else jfc.fused_v2_attention_corner)

        def fn(x0, x1, x2):
            return op(x0, x1, shift, x2, keepq, gj, pj, **kw)

    @jax.jit
    def run(xs, cts):
        (out, den), vjp = jax.vjp(fn, *xs)
        return out, den, vjp(cts)

    xs = tuple(jnp.asarray(v) for v in leaves.values())
    return [run(xs, tuple(jnp.asarray(c) for c in cts)) for cts in cts_list]


def _torch_op(which, over, gt, pt, leaves, fixed, cts, precision):
    """(out, den, grads of the leaves) of the port's op at ``precision``."""
    xs = [torch.tensor(v, requires_grad=True) for v in leaves.values()]
    shift = torch.from_numpy(fixed["bound" if which == "v1" else "ub"])
    keepq = torch.from_numpy(fixed["keepq"])
    if over == "band plan":
        op = (tbd.fused_v1_attention_banded if which == "v1"
              else tbd.fused_v2_attention_banded)
        out, den = op(xs[0], xs[1], shift, xs[2], keepq, pt, ALPHA, precision)
    else:
        op = (tfc.fused_v1_attention_corner if which == "v1"
              else tfc.fused_v2_attention_corner)
        out, den = op(xs[0], xs[1], shift, xs[2], keepq, gt, pt, ALPHA,
                      precision)
    grads = torch.autograd.grad((out, den), xs,
                                tuple(torch.from_numpy(c) for c in cts))
    return out.detach(), den.detach(), grads


@pytest.mark.parametrize("order", ORDERS, indirect=True)
@pytest.mark.parametrize("which", ["v1", "v2"])
@pytest.mark.parametrize("h,f", [(4, 8), (1, 7)])
def test_attention_ops_fastest_match_jax(order, which, h, f):
    """The banded and corner attention ops under 'fastest': forward (out,
    den) and the gradients of the three differentiable inputs against the
    JAX op's, for the cotangents of both outputs and for den's alone (the
    logit path by itself: GATv2's whi then takes its gradient from the
    receiver sum alone, which the message path outweighs otherwise); apart
    from the port's 'high'."""
    gj, gt, pj, pt, _ = order
    over = "band plan" if isinstance(pt, tbd.BandPlan) else "corner plans"
    e = pt.num_slots if over == "band plan" else gt.num_edges_padded
    leaves, fixed, cts = _op_inputs(which, gt, e, h, f, 10 * h + f)
    cts_list = (cts, (np.zeros_like(cts[0]), cts[1]))
    wants = _jax_op(which, over, gj, pj, leaves, fixed, cts_list)
    gots = [_torch_op(which, over, gt, pt, leaves, fixed, c, "fastest")
            for c in cts_list]
    for i, (got, want) in enumerate(zip(gots, wants)):
        (out_t, den_t, grads_t), (out_j, den_j, grads_j) = got, want
        _held(out_t, out_j, OUT_RTOL, "out")
        _held(den_t, den_j, OUT_RTOL, "den")
        for name, g_t, g_j in zip(leaves, grads_t, grads_j):
            _held(g_t, g_j, GRAD_RTOL, f"{name}, cotangents {i}")
    (out_t, _, grads_t), (out_j, _, grads_j) = gots[0], wants[0]
    out_h, _, grads_h = _torch_op(which, over, gt, pt, leaves, fixed, cts,
                                  "high")
    assert float((out_t - out_h).abs().max()) > APART * _scale(out_j)
    assert float((grads_t[0] - grads_h[0]).abs().max()) > APART * _scale(
        grads_j[0])


# -- the whole models ---------------------------------------------------------


def _model_cfg(layer_type):
    kw = dict(nlayers=2, nheads=(4, 2), nfeats=(32, 8, 4), dropout=0.0,
              alpha=ALPHA, layer_type=layer_type, skip_connection=True)
    return jgat.GATConfig(**kw), tgat.GATConfig(**kw)


def _numpy_params(cfg, seed):
    """The JAX model's parameters (their shapes from ``init_gat``, traced
    only: eager ``init_gat`` compiles its random ops for seconds), drawn
    with numpy, uniform on the xavier bound of each leaf's last two axes."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jgat.init_gat(jax.random.PRNGKey(0), cfg))
    return [type(layer)(*(None if t is None else (rng.uniform(
        -1, 1, t.shape) * np.sqrt(6 / sum(t.shape[-2:]))).astype(np.float32)
        for t in layer)) for layer in shapes]


def _torch_model(cfg_t, tparams, x, gt, pt):
    out = tgat.apply_gat(tparams, cfg_t, torch.from_numpy(x), gt, None,
                         train=False, plans=pt)
    torch.sin(out).sum().backward()
    grads = torch.cat([p.grad.reshape(-1) for p in tgat.parameters(tparams)])
    return out.detach().numpy(), grads.numpy()


@pytest.mark.parametrize("order", ORDERS, indirect=True)
@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_sparse_models_fastest_match_jax(order, layer_type, monkeypatch):
    """Both 2-layer sparse models over each order under the 'fastest'
    module default, forward and parameter gradients of sum(sin(out)),
    dropout off, against the JAX package's ``apply_gat(plans=...)``; apart
    from the port's 'high'."""
    gj, gt, pj, pt, x = order
    cfg_j, cfg_t = _model_cfg(layer_type)
    numpy_params = _numpy_params(cfg_j, 0)
    jparams = jax.tree_util.tree_map(jnp.asarray, numpy_params)

    def loss(p):
        out = jgat.apply_gat(p, cfg_j, jnp.asarray(x), gj,
                             jax.random.PRNGKey(1), train=False, plans=pj)
        return jnp.sum(jnp.sin(out)), out

    (_, out_j), grads_j = _jax_fastest(
        lambda: jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams))
    grads_j = np.asarray(ravel_pytree(grads_j)[0])
    monkeypatch.setattr(tseg, "_STREAM_PRECISION", "fastest")
    out_t, grads_t = _torch_model(
        cfg_t, params_from_jax(numpy_params, device="cpu"), x, gt, pt)
    _held(out_t, out_j, OUT_RTOL, "out")
    _held(grads_t, grads_j, GRAD_RTOL, "gradients")
    monkeypatch.setattr(tseg, "_STREAM_PRECISION", "high")
    out_h, _ = _torch_model(
        cfg_t, params_from_jax(numpy_params, device="cpu"), x, gt, pt)
    assert float(np.abs(out_t - out_h).max()) > APART * _scale(out_j)


# -- errors -------------------------------------------------------------------


def test_plan_ops_refuse_an_unknown_precision(band, corner):
    """Every op over a plan that takes a precision refuses one that is
    neither 'high' nor 'fastest', the SpMM ops over the plans too, which
    run under both (on ones, exact in bf16, alike)."""
    _, gb, _, pb, _ = band
    _, gc, _, pc, _ = corner
    leaves, fixed, _ = _op_inputs("v1", gb, pb.num_slots, 2, 3, 1)
    wh, f_dst, a_src = (torch.from_numpy(v) for v in leaves.values())
    bound, keepq = (torch.from_numpy(fixed[k]) for k in ("bound", "keepq"))
    cl, cf, _ = _op_inputs("v1", gc, gc.num_edges_padded, 2, 3, 1)
    cwh, cf_dst, ca = (torch.from_numpy(v) for v in cl.values())
    cbound, ckeepq = (torch.from_numpy(cf[k]) for k in ("bound", "keepq"))
    win = tlarge.gather_corner(cwh, gc, pc.fwd)
    for call in (
            lambda p: tbd.banded_take(wh, pb, precision=p),
            lambda p: tbd.banded_take_plain(wh, pb, precision=p),
            lambda p: tbd.banded_sender_sum(torch.zeros(pb.num_slots, 3), pb,
                                            precision=p),
            lambda p: tbd.fused_v1_banded(wh, f_dst, bound, a_src, keepq, pb,
                                          ALPHA, precision=p),
            lambda p: tbd.fused_v1_attention_banded(wh, f_dst, bound, a_src,
                                                    keepq, pb, ALPHA, p),
            lambda p: tfc.fused_v1_window(win, cf_dst, cbound, ca, ckeepq,
                                          gc.r_local, gc.r_chunk, ALPHA,
                                          precision=p),
            lambda p: tfc.fused_v1_attention_corner(cwh, cf_dst, cbound, ca,
                                                    ckeepq, gc, pc, ALPHA, p),
            lambda p: tlarge.scatter_corner(
                torch.zeros(gc.num_edges_padded, 3), gc, pc.inv, p)):
        call("high")
        with pytest.raises(ValueError, match="unknown precision"):
            call("medium")
    for call in (
            lambda p: tbd.spmm_banded(torch.ones(pb.num_slots),
                                      torch.ones(gb.num_nodes_padded, 4), pb,
                                      precision=p),
            lambda p: tlarge.spmm_corner_graph(
                torch.ones(gc.num_edges_padded),
                torch.ones(gc.num_nodes_padded, 4), gc, pc, precision=p)):
        assert torch.equal(call("fastest"), call("high"))  # exact in bf16
        with pytest.raises(ValueError, match="unknown precision"):
            call("medium")
