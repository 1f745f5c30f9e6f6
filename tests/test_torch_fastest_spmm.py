"""The ``fastest`` precision mode (one bf16 limb) of the PyTorch port's SpMM
ops against the JAX package's, which runs its Pallas kernels in interpret
mode: ``spmm_banded`` fused (kernel row 7) and two-pass, ``panel_spmm_graph``
(kernel row 9) with and without ``plans=`` and with overflow slots, and
``spmm_corner_graph``, forward and VJP; the default calls of
``spmm_banded`` and ``panel_spmm_graph`` (``'fastest'`` in both packages);
and the plain versions of the two kernels, which are their oracles on the
card.

Both packages form each message alike and round it to bf16 (to nearest,
ties to even) before an f32 sum: the fused banded form ``bf16(v) *
bf16(x)``, the two-pass form and the panel ``v * bf16(x)`` (f32 values),
the corner route ``v * x``; the overflow slots stay f32. So outputs and
one-limb sums differ only by the order of f32 sums: SUM_RTOL of the same
sums over magnitudes (and the looser OUT_RTOL / GRAD_RTOL of
tests/test_torch_fastest.py of the scale). Each output that the precision
moves is held away from 'high' (APART), so a ``precision`` that is ignored
fails; the gradients that the reference keeps f32 (the panel backward
without ``plans``, every ``d values`` but the banded one) equal 'high''s."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.ops import banded as jbd
from pygat_tpu.ops import large as jlarge
from pygat_tpu.ops import panel as jpanel
from pygat_tpu.ops.large import plan_csc_to_csr as jplan_csc_to_csr
from tests.test_torch_fastest import APART, GRAD_RTOL, OUT_RTOL, SUM_RTOL, _held
from tests.test_torch_panel import L, _banded_mags, _clustered, clustered  # noqa: F401
from tests.test_torch_spmm import _jax_vjp, _spmm_mags, _torch_vjp
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import ops
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops import panel as tpanel
from pygat_tpu_torch.ops.large import plan_csc_to_csr as tplan_csc_to_csr

WHAT = ("out", "d values", "d x")


@pytest.fixture(scope="module")
def band():
    """The clustered 600-node graph of tests/test_torch_panel.py and its
    w = 4 band plan in both packages, values in banded order (0 on dead
    slots), node rows, a cotangent, and the JAX fused op's VJP under
    'fastest' (the two-pass form shares its backward)."""
    gj, gt, rng = _clustered(600, 5, 200, 5)
    pj, pt = jbd.build_band_plan(gj, w=4), tbd.build_band_plan(gt, w=4)
    live = pt.perm >= 0
    vals = np.zeros(pt.num_slots, np.float32)
    vals[live] = rng.standard_normal(int(live.sum())).astype(np.float32)
    x = rng.standard_normal((gt.num_nodes_padded, L)).astype(np.float32)
    ct = rng.standard_normal((gt.num_nodes_padded, L)).astype(np.float32)
    want = _jax_vjp(lambda v, d: jbd.spmm_banded(v, d, pj, precision="fastest",
                                                 interpret=True),
                    (vals, x), jnp.asarray(ct))
    return gj, pj, pt, vals, x, ct, want


def _hold(got, want, high, mags, apart):
    """Each of out, d values, d x within SUM_RTOL of its magnitude sum and
    within OUT_RTOL / GRAD_RTOL of the scale; apart from 'high' where
    ``apart`` names it, else equal to 'high''s bit for bit."""
    for a, b, h, m, what in zip(got, want, high, mags, WHAT):
        err = np.abs(a - np.asarray(b))
        assert (err <= SUM_RTOL * m + 1e-30).all(), (what, float(err.max()))
        _held(a, b, OUT_RTOL if what == "out" else GRAD_RTOL, what)
        if what in apart:
            scale = float(np.abs(np.asarray(b)).max())
            assert float(np.abs(a - h).max()) > APART * scale, what
        else:
            np.testing.assert_array_equal(a, h, err_msg=what)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two-pass"])
def test_spmm_banded_fastest_matches_jax(band, fused):
    """Both forms under 'fastest' (the fused one rounds the values, the
    two-pass one does not), forward against the JAX form's, gradients
    against the JAX fused op's VJP: d values from x's rows rounded to bf16,
    d x a one-limb sender sum; dead slots get no gradient."""
    gj, pj, pt, vals, x, ct, want = band
    if not fused:
        want = [np.asarray(jax.jit(lambda v, d: jbd.spmm_banded(
            v, d, pj, precision="fastest", interpret=True, fused=False))(
                jnp.asarray(vals), jnp.asarray(x)))] + want[1:]
    got, high = (_torch_vjp(lambda v, d: ops.spmm_banded(
        v, d, pt, fused=fused, precision=p), (vals, x), ct)
        for p in ("fastest", "high"))
    _hold(got, want, high, _banded_mags(pt, vals, x, ct), WHAT)
    assert float(np.abs(got[0]).max()) > 1.0
    assert not got[1][pt.perm < 0].any()


@pytest.mark.parametrize("p_max,corner", [(None, False), (None, True),
                                          (2, False)],
                         ids=["panels", "panels-corner-backward", "overflow"])
def test_panel_spmm_graph_fastest_matches_jax(clustered, p_max, corner):  # noqa: F811
    """Forward and VJP under 'fastest': the messages of the slots that fit
    their panels rounded, the overflow slots (most of them at ``p_max=2``)
    f32; the backward f32 without ``plans`` (as 'high''s), with ``plans``
    (span cap 3) d x a one-limb CSC sum and d values f32."""
    gj, gt, x, w, ct = clustered
    lj = jpanel.build_panel_layout(gj, p_max=p_max)
    lt = tpanel.build_panel_layout(gt, p_max=p_max)
    pj = jplan_csc_to_csr(gj, p_cap=3) if corner else None
    pt = tplan_csc_to_csr(gt, p_cap=3) if corner else None
    want = _jax_vjp(lambda v, d: jpanel.panel_spmm_graph(
        v, d, gj, lj, plans=pj, precision="fastest", interpret=True),
        (w, x), jnp.asarray(ct))
    got, high = (_torch_vjp(lambda v, d: ops.panel_spmm_graph(
        v, d, gt, lt, plans=pt, precision=p), (w, x), ct)
        for p in ("fastest", "high"))
    _hold(got, want, high, _spmm_mags(gt, w, x, ct),
          ("out", "d x") if corner else ("out",))
    assert (lt.n_overflow > 0) == (p_max is not None)


def test_spmm_corner_graph_fastest_matches_jax(clustered):  # noqa: F811
    """Forward and VJP under 'fastest' over corner plans with a span cap of
    3 tiles: the messages ``v * x`` (rows moved exactly) rounded before the
    receiver sum, d x a one-limb CSC sum, d values f32."""
    gj, gt, x, w, ct = clustered
    pj, pt = jplan_csc_to_csr(gj, p_cap=3), tplan_csc_to_csr(gt, p_cap=3)
    want = _jax_vjp(lambda v, d: jlarge.spmm_corner_graph(
        v, d, gj, pj, precision="fastest", interpret=True),
        (w, x), jnp.asarray(ct))
    got, high = (_torch_vjp(lambda v, d: ops.spmm_corner_graph(
        v, d, gt, pt, precision=p), (w, x), ct) for p in ("fastest", "high"))
    _hold(got, want, high, _spmm_mags(gt, w, x, ct), ("out", "d x"))


@pytest.mark.parametrize("op", ["spmm_banded", "panel_spmm_graph"])
def test_spmm_default_calls_match_jax(band, clustered, op):  # noqa: F811
    """The port's call without ``precision`` against the JAX package's call
    without it (both 'fastest'): within SUM_RTOL of the magnitude sums, and
    equal bit for bit to the port's explicit 'fastest'."""
    if op == "spmm_banded":
        _, pj, pt, vals, x, ct, _ = band
        want = jax.jit(lambda v, d: jbd.spmm_banded(v, d, pj,
                                                    interpret=True))(
            jnp.asarray(vals), jnp.asarray(x))
        v, d = torch.from_numpy(vals), torch.from_numpy(x)
        got = ops.spmm_banded(v, d, pt)
        explicit = ops.spmm_banded(v, d, pt, precision="fastest")
        mag = _banded_mags(pt, vals, x, ct)[0]
    else:
        gj, gt, x, w, ct = clustered
        lj = jpanel.build_panel_layout(gj)
        lt = tpanel.build_panel_layout(gt)
        want = jax.jit(lambda v, d: jpanel.panel_spmm_graph(v, d, gj, lj))(
            jnp.asarray(w), jnp.asarray(x))
        v, d = torch.from_numpy(w), torch.from_numpy(x)
        got = ops.panel_spmm_graph(v, d, gt, lt)
        explicit = ops.panel_spmm_graph(v, d, gt, lt, precision="fastest")
        mag = _spmm_mags(gt, w, x, ct)[0]
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= SUM_RTOL * mag + 1e-30).all(), float(err.max())
    assert torch.equal(got, explicit)


@pytest.mark.parametrize("kernel", ["spmm_banded", "panel_spmm"])
def test_spmm_plain_fastest_rounds_each_message(band, clustered, kernel):  # noqa: F811
    """The kernels' plain versions under 'fastest' sum each message rounded
    to bf16 as the kernels form it (row 7: ``bf16(bf16(v) * bf16(x))``, row
    9: ``bf16(w * bf16(x))``), in f32 or, with ``f64=True``, in f64 within
    SUM_RTOL of the ``magnitude=True`` sum; the one-limb wrappers take the
    same path on the CPU."""
    if kernel == "spmm_banded":
        _, _, pt, vals, x, _, _ = band
        v, d = torch.from_numpy(vals), torch.from_numpy(x)
        plain, args = tbd.banded_weighted_sum_plain, (pt,)
        wrappers = (tbd.banded_weighted_sum, tbd.banded_weighted_sum_bf16)
        # the rounded operands, whose f32 product is exact
        rv, rd = (t.to(torch.bfloat16).float() for t in (v, d))
    else:
        _, gt, x, w, _ = clustered
        lt = tpanel.build_panel_layout(gt, p_max=2)
        v, d = torch.from_numpy(w), torch.from_numpy(x)
        plain = tpanel.panel_weighted_sum_plain
        args = (lt.panel_tiles, lt.g_idx, gt.edge_mask, gt.r_local,
                gt.r_chunk, lt.tile_ptr, lt.split_at)
        wrappers = (tpanel.panel_weighted_sum, tpanel.panel_weighted_sum_bf16)
        rv, rd = v, d.to(torch.bfloat16).float()
    got = plain(v, d, *args, precision="fastest")
    f64 = plain(v, d, *args, precision="fastest", f64=True)
    mag = plain(v, d, *args, precision="fastest", magnitude=True)
    assert got.dtype == f64.dtype == torch.float32
    assert bool(((got - f64).abs() <= SUM_RTOL * mag + 1e-30).all())
    # each message rounded once more from the f32 product: a rounding
    # missed or added moves the sums by about 2^-9 of their magnitude
    unrounded = plain(rv, rd, *args)
    assert float((got - unrounded).abs().max()) > APART * float(mag.max())
    assert torch.equal(mag, plain(v.abs(), d.abs(), *args,
                                  precision="fastest"))
    torch.testing.assert_close(plain(v, d, *args), wrappers[0](v, d, *args),
                               rtol=0, atol=0)
    for res in (wrappers[0](v, d, *args, precision="fastest"),
                wrappers[1](v, d, *args)):
        assert torch.equal(res, got)
