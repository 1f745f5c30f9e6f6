"""The PyTorch port's panel SpMM and banded SpMM (their plain versions,
which the CPU runs) against the JAX package: ``build_panel_layout`` field
for field (with and without ``p_max``, and with empty tiles),
``panel_spmm_graph`` forward and gradients with and without ``plans=``,
with overflow slots and with empty tiles, and ``spmm_banded`` with both
``fused`` values, forward and gradients. The JAX kernels run in interpret
mode at ``high`` precision, which sums two bf16 limbs (about 16 mantissa
bits): outputs and gradients agree to 2e-5 of the same sum over the terms'
magnitudes, or, where the JAX side sums in f32 XLA, to 1e-5 of max(1,
max |JAX|)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import banded as jbd
from pygat_tpu.ops import panel as jpanel
from pygat_tpu.ops.large import plan_csc_to_csr as jplan_csc_to_csr
from tests.test_torch_spmm import _assert_close, _jax_vjp, _spmm_mags, _torch_vjp
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import ops
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops import panel as tpanel
from pygat_tpu_torch.ops.large import plan_csc_to_csr as tplan_csc_to_csr

L = 48


def _clustered(n, deg, spread, seed, **kw):
    """Receivers 0..n-1 with ``deg`` in-edges from within ``spread``, plus
    self loops, in both packages."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.arange(n, dtype=np.int64), deg)
    s = np.clip(base + rng.integers(-spread, spread, base.shape[0]), 0, n - 1)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([base, np.arange(n)])
    return (jbuild_graph(s, r, None, n, **kw),
            tbuild_graph(s, r, None, n, device="cpu", **kw), rng)


@pytest.fixture(scope="module")
def clustered():
    """A clustered graph of 1024 nodes (9 tiles, 4-6 panels each), node
    rows, per-edge values (also on padding edges, which weigh 0) and a
    cotangent."""
    gj, gt, rng = _clustered(1024, 6, 200, 0)
    n_pad = gt.num_nodes_padded
    x = rng.standard_normal((n_pad, L)).astype(np.float32)
    w = rng.standard_normal(gt.num_edges_padded).astype(np.float32)
    ct = rng.standard_normal((n_pad, L)).astype(np.float32)
    return gj, gt, x, w, ct


def _assert_layouts_equal(lt, lj):
    for f in ("panel_tiles", "g_idx", "overflow_edges"):
        np.testing.assert_array_equal(getattr(lt, f).numpy(),
                                      np.asarray(getattr(lj, f)), err_msg=f)
        assert getattr(lt, f).dtype == torch.int32
    assert (lt.n_panels, lt.n_overflow) == (lj.n_panels, lj.n_overflow)
    assert lt.overflow_frac == lj.overflow_frac


@pytest.mark.parametrize("p_max", [None, 4, 2, 1])
def test_build_panel_layout_matches_jax(clustered, p_max):
    gj, gt, *_ = clustered
    lj = jpanel.build_panel_layout(gj, p_max=p_max)
    lt = tpanel.build_panel_layout(gt, p_max=p_max)
    _assert_layouts_equal(lt, lj)
    assert (lt.n_overflow > 0) == (p_max is not None and p_max < 5)


def test_build_panel_layout_empty_tiles_and_ties():
    """A bucketed graph with empty tiles and a uniform one, whose tiles
    rank many sender tiles with equal counts."""
    rng = np.random.default_rng(3)
    n = 150
    s = np.concatenate([rng.integers(0, n, 600), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, 600), np.arange(n)])
    for kw in (dict(n_pad=512, e_pad=2048), {}):
        gj = jbuild_graph(s, r, None, n, **kw)
        gt = tbuild_graph(s, r, None, n, device="cpu", **kw)
        for p_max in (None, 1):
            _assert_layouts_equal(tpanel.build_panel_layout(gt, p_max=p_max),
                                  jpanel.build_panel_layout(gj, p_max=p_max))


def _panel_vjp_jax(gj, lj, w, x, ct, plans=None):
    return _jax_vjp(
        lambda v, d: jpanel.panel_spmm_graph(v, d, gj, lj, plans=plans,
                                             precision="high",
                                             interpret=True),
        (w, x), jnp.asarray(ct))


@pytest.mark.parametrize("p_max,corner", [(None, False), (None, True),
                                          (2, False)],
                         ids=["panels", "panels-corner-backward", "overflow"])
def test_panel_spmm_graph_matches_jax(clustered, p_max, corner):
    """Forward and the gradients of the values and the node rows; with
    ``p_max=2`` most slots overflow to the second pass; ``plans=`` runs the
    gather-free backward over corner plans with a span cap of 3 tiles."""
    gj, gt, x, w, ct = clustered
    lj = jpanel.build_panel_layout(gj, p_max=p_max)
    lt = tpanel.build_panel_layout(gt, p_max=p_max)
    pj = jplan_csc_to_csr(gj, p_cap=3) if corner else None
    pt = tplan_csc_to_csr(gt, p_cap=3) if corner else None
    want = _panel_vjp_jax(gj, lj, w, x, ct, pj)
    got = _torch_vjp(lambda v, d: ops.panel_spmm_graph(
        v, d, gt, lt, plans=pt, precision="high"), (w, x), ct)
    mags = _spmm_mags(gt, w, x, ct)
    for a, b_, mag, what in zip(got, want, mags, ("out", "d values", "d x")):
        _assert_close(a, b_, what, mag)
    # every route is the SpMM
    ref = _torch_vjp(lambda v, d: ops.spmm_graph(v, d, gt), (w, x), ct)
    for a, b_, what in zip(got, ref, ("out", "d values", "d x")):
        _assert_close(a, b_, f"vs spmm_graph: {what}")


def test_panel_spmm_empty_tiles():
    """Bucketed shapes: real rows only in the low tiles, so empty output
    tiles and all-dead chunks give exact zeros."""
    gj, gt, rng = _clustered(150, 4, 40, 3, n_pad=512, e_pad=2048)
    lj, lt = jpanel.build_panel_layout(gj), tpanel.build_panel_layout(gt)
    x = rng.standard_normal((512, 32)).astype(np.float32)
    w = rng.random(gt.num_edges_padded).astype(np.float32)
    want = jax.jit(lambda v, d: jpanel.panel_spmm_graph(
        v, d, gj, lj, precision="high", interpret=True))(jnp.asarray(w),
                                                         jnp.asarray(x))
    got = ops.panel_spmm_graph(torch.from_numpy(w), torch.from_numpy(x), gt,
                               lt, precision="high")
    mag = _spmm_mags(gt, w, x, np.zeros_like(x))[0]
    _assert_close(got.numpy(), want, "out", mag)
    assert float(got.abs().max()) > 1.0 and not got[192:].any()


def test_panel_spmm_arrays_and_modes_agree(clustered):
    """The array-level ``panel_spmm`` over the layout's padded overflow
    list, and mode 'take', give what ``panel_spmm_graph`` gives."""
    _, gt, x, w, _ = clustered
    lt = tpanel.build_panel_layout(gt, p_max=2)
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    want = ops.panel_spmm_graph(wt, xt, gt, lt)
    got = ops.panel_spmm(wt, xt, lt.panel_tiles, lt.g_idx, lt.overflow_edges,
                         gt.senders, gt.receivers, gt.edge_mask, gt.r_local,
                         gt.r_chunk, lt.n_panels, tile_ptr=lt.tile_ptr,
                         split_at=lt.split_at)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(ops.panel_spmm_graph(wt, xt, gt, lt, mode="take"),
                       want)


@pytest.mark.parametrize("kw,err", [
    (dict(precision="fastest"), None),
    (dict(precision="default"), ValueError), (dict(mode="gather"), ValueError),
], ids=["kw0-NotImplementedError", "kw1-ValueError", "kw2-ValueError"])
def test_panel_spmm_graph_rejects_what_it_lacks(clustered, kw, err):
    """An unknown precision or mode raises; 'fastest', the default, runs
    (tests/test_torch_fastest_spmm.py holds it to the JAX package's)."""
    _, gt, x, w, _ = clustered
    lt = tpanel.build_panel_layout(gt)
    args = (torch.from_numpy(w), torch.from_numpy(x), gt, lt)
    if err is None:
        got = ops.panel_spmm_graph(*args, **kw)
        assert torch.equal(got, ops.panel_spmm_graph(*args))
        assert float((got - ops.panel_spmm_graph(
            *args, precision="high")).abs().max()) > 0
        return
    with pytest.raises(err, match="unknown"):
        ops.panel_spmm_graph(*args, **kw)


# ---------------------------------------------------------------------------
# spmm_banded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def banded():
    """A clustered graph of 600 nodes and its w=4 band plan (several chunks
    per tile, dead slots, all-dead padding chunks on the last band), values
    in banded order (0 on dead slots, as the plan's edge_weight), node rows
    of the width tests/test_banded.py uses, a cotangent, and the JAX VJP of
    the fused op."""
    gj, gt, rng = _clustered(600, 5, 200, 5)
    pj, pt = jbd.build_band_plan(gj, w=4), tbd.build_band_plan(gt, w=4)
    assert pt.num_chunks > gt.num_nodes_padded // 128
    n_pad = gt.num_nodes_padded
    live = pt.perm >= 0
    vals = np.zeros(pt.num_slots, np.float32)
    vals[live] = rng.standard_normal(int(live.sum())).astype(np.float32)
    x = rng.standard_normal((n_pad, L)).astype(np.float32)
    ct = rng.standard_normal((n_pad, L)).astype(np.float32)
    want = _jax_vjp(lambda v, d: jbd.spmm_banded(v, d, pj, precision="high",
                                                 interpret=True),
                    (vals, x), jnp.asarray(ct))
    return gt, pt, vals, x, ct, want


def _banded_mags(pt, vals, x, ct):
    """Forward, d values and d x of the banded SpMM over magnitudes."""
    s = tbd.banded_senders(pt, 0)
    live = (pt.s_loc < pt.w * 128)[:, None]
    av, ax, act = (torch.from_numpy(np.abs(a)) for a in (vals, x, ct))
    out = tbd.banded_weighted_sum_plain(av, ax, pt)
    ge = ops.large.expand(act, pt.r_local, pt.r_chunk)
    dv = (torch.where(live, ax[s], 0.0) * ge).sum(1)
    dx = tbd.banded_sender_sum(av[:, None] * ge, pt)
    return out.numpy(), dv.numpy(), dx.numpy()


@pytest.mark.parametrize("fused", [True, False])
def test_spmm_banded_matches_jax(banded, fused):
    """Both forms against the JAX fused op, forward and gradients (the JAX
    two-pass form has no gradient of its own; the port's shares the fused
    form's backward)."""
    gt, pt, vals, x, ct, want = banded
    got = _torch_vjp(lambda v, d: ops.spmm_banded(v, d, pt, fused=fused,
                                                  precision="high"),
                     (vals, x), ct)
    mags = _banded_mags(pt, vals, x, ct)
    for a, b_, mag, what in zip(got, want, mags, ("out", "d values", "d x")):
        _assert_close(a, b_, what, mag)
    assert float(np.abs(got[0]).max()) > 1.0
    assert not got[1][pt.perm < 0].any()  # dead slots get no gradient


def test_spmm_banded_is_the_spmm(banded):
    """Values on the edges, permuted into banded order through the plan's
    perm: the banded SpMM and its gradients equal spmm_graph's."""
    gt, pt, vals, x, ct, _ = banded
    live = pt.perm >= 0
    w = np.zeros(gt.num_edges_padded, np.float32)
    w[pt.perm[live]] = vals[live]
    got = _torch_vjp(lambda v, d: ops.spmm_banded(v, d, pt, precision="high"),
                     (vals, x), ct)
    ref = _torch_vjp(lambda v, d: ops.spmm_graph(v, d, gt), (w, x), ct)
    _assert_close(got[0], ref[0], "out")
    _assert_close(got[1][live], ref[1][pt.perm[live]], "d values")
    _assert_close(got[2], ref[2], "d x")


def test_spmm_banded_rejects_fastest(banded):
    """'fastest', the default, runs in both forms (one bf16 limb, held to
    the JAX package's by tests/test_torch_fastest_spmm.py); an unknown
    precision raises."""
    _, pt, vals, x, _, _ = banded
    v, d = torch.from_numpy(vals), torch.from_numpy(x)
    high = ops.spmm_banded(v, d, pt, precision="high")
    for fused in (True, False):
        got = ops.spmm_banded(v, d, pt, precision="fastest", fused=fused)
        assert torch.equal(got, ops.spmm_banded(v, d, pt, fused=fused))
        assert 0 < float((got - high).abs().max()) <= 2.0 ** -7 * float(
            high.abs().max())
    with pytest.raises(ValueError, match="unknown precision"):
        ops.spmm_banded(v, d, pt, precision="medium")
