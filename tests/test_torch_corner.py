"""The PyTorch port's corner-turn and gather-free attention ops (their plain
versions, which the CPU runs) against the JAX package's Pallas functions in
interpret mode: a pass chain with overflow rows bit-exact against
``corner_permute(mode="take")``, the gradient of ``permute_rows``, and the
corner attention ops of both models, forward and the gradient of every
differentiable input, at the tolerances of tests/test_torch_banded.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import corner as jcorner
from pygat_tpu.ops import fused_corner as jfc
from pygat_tpu.ops.large import plan_csc_to_csr as jplan_csc_to_csr
from tests.test_torch_banded import _assert_close, _vjp_jax, _vjp_torch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import corner as tcorner
from pygat_tpu_torch.ops import fused_corner as tfc
from pygat_tpu_torch.ops import fused_stream as tfs
from pygat_tpu_torch.ops.large import plan_csc_to_csr as tplan_csc_to_csr

ALPHA = 0.2
H, F = 4, 8


@pytest.fixture(scope="module")
def setup():
    """A uniform graph of 300 nodes and its corner plans with a span cap of
    3 tiles: several passes, re-windowed tiles and overflow rows in both
    directions, in both packages."""
    rng = np.random.default_rng(3)
    n = 300
    s = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    pj, pt = jplan_csc_to_csr(gj, p_cap=3), tplan_csc_to_csr(gt, p_cap=3)
    assert len(pt.fwd.passes) >= 3
    assert pt.fwd.overflow_total > 0 and pt.inv.overflow_total > 0
    return gj, gt, pj, pt


def test_apply_passes_matches_jax_bit_exact():
    """A full permutation (every row consumed) through a 4-pass plan with
    overflow rows: every output row equal to the JAX pass chain's and to
    the permutation's definition."""
    rng = np.random.default_rng(0)
    e = 128 * 64
    dest = rng.permutation(e)
    pj = jcorner.plan_corner_turn(dest, 3)
    pt = tcorner.plan_corner_turn(dest, 3)
    assert len(pt.passes) == 4 and pt.overflow_total > 0
    x = rng.standard_normal((e, 5)).astype(np.float32)
    want = jax.jit(lambda v: jcorner.corner_permute(v, pj, mode="take",
                                                    interpret=True))(
        jnp.asarray(x))
    got = tcorner.corner_permute(torch.from_numpy(x), pt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    expect = np.empty_like(x)
    expect[dest] = x
    np.testing.assert_array_equal(got.numpy(), expect)


def test_csc_to_csr_turn_matches_jax_on_live_rows(setup):
    """The CSC-to-CSR turn of a graph: the rows the plan cares about (live
    CSC slots, landing on their edge's receiver-stream slot) equal the JAX
    pass chain's, and each pass's plain version is ``x[lo * 128 + g]``."""
    _, gt, pj, pt = setup
    e_s2 = gt.c_slot.shape[0]
    x = np.random.default_rng(1).standard_normal((e_s2, 7)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jcorner.corner_permute(
        v, pj.fwd, mode="take", interpret=True))(jnp.asarray(x)))
    got = tcorner.corner_permute(torch.from_numpy(x), pt.fwd).numpy()
    live = (gt.c_local < 128).numpy()
    dst = gt.c_slot.numpy()[live]
    np.testing.assert_array_equal(got[dst], want[dst])
    np.testing.assert_array_equal(got[dst], x[live])
    cp = pt.fwd.passes[0]
    xt = torch.from_numpy(x)
    rows = cp.lo.long().repeat_interleave(128) * 128 + cp.g.reshape(-1)[
        :cp.lo.shape[0] * 128].long()
    assert torch.equal(tcorner.permute_pass(xt, cp), xt[rows])


def test_permute_rows_gradient_is_the_inverse_permutation():
    rng = np.random.default_rng(2)
    e = 128 * 40
    dest = rng.permutation(e)
    plan, plan_inv = tcorner.plan_pair(dest)
    x = torch.from_numpy(rng.standard_normal((e, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((e, 3)).astype(np.float32))
    x.requires_grad_()
    out = tcorner.permute_rows(x, plan, plan_inv)
    assert torch.equal(out.detach()[torch.from_numpy(dest)], x.detach())
    (grad,) = torch.autograd.grad((out * w).sum(), x)
    assert torch.equal(grad, w[torch.from_numpy(dest)])


def _operands(gt, seed):
    """Node tables, the v1 bound and the v2 ub as tests/test_banded.py makes
    them, keep factors of dropout 0.4 over the stream slots, cotangents."""
    rng = np.random.default_rng(seed)
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    f32 = np.float32
    wh = rng.standard_normal((n, H * F)).astype(f32)
    whj = rng.standard_normal((n, H * F)).astype(f32)
    f_dst = rng.standard_normal((n, H)).astype(f32)
    bound = np.abs(f_dst) + 2.0
    a = (rng.standard_normal((H, F)) * 0.1).astype(f32)
    keepq = np.where(rng.random((e, H)) < 0.6, 1 / 0.6, 0).astype(f32)
    g_out = rng.standard_normal((n, H * F)).astype(f32)
    g_den = rng.standard_normal((n, H)).astype(f32)
    return wh, whj, f_dst, bound, a, keepq, g_out, g_den


def test_fused_v1_attention_corner_matches_jax(setup):
    gj, gt, pj, pt = setup
    wh, _, f_dst, bound, a, keepq, g_out, g_den = _operands(gt, 10)
    want = _vjp_jax(
        lambda w_, f_, a_: jfc.fused_v1_attention_corner(
            w_, f_, jnp.asarray(bound), a_, jnp.asarray(keepq), gj, pj,
            alpha=ALPHA, precision="high", interpret=True),
        (wh, f_dst, a), (jnp.asarray(g_out), jnp.asarray(g_den)))
    got = _vjp_torch(
        lambda w_, f_, a_: tfc.fused_v1_attention_corner(
            w_, f_, torch.from_numpy(bound), a_, torch.from_numpy(keepq), gt,
            pt, ALPHA),
        (wh, f_dst, a), (g_out, g_den))
    _assert_close(got, want)


def test_fused_v2_attention_corner_matches_jax(setup):
    gj, gt, pj, pt = setup
    whi, whj, _, ub, a, keepq, g_out, g_den = _operands(gt, 11)
    want = _vjp_jax(
        lambda i_, j_, a_: jfc.fused_v2_attention_corner(
            i_, j_, jnp.asarray(ub), a_, jnp.asarray(keepq), gj, pj,
            alpha=ALPHA, precision="high", interpret=True),
        (whi, whj, a), (jnp.asarray(g_out), jnp.asarray(g_den)))
    got = _vjp_torch(
        lambda i_, j_, a_: tfc.fused_v2_attention_corner(
            i_, j_, torch.from_numpy(ub), a_, torch.from_numpy(keepq), gt,
            pt, ALPHA),
        (whi, whj, a), (g_out, g_den))
    _assert_close(got, want)


def test_window_plain_versions_are_the_stream_ones_over_a_window(setup):
    """Over the window that gather_corner builds, the window forwards give
    the receiver stream's forwards exactly, and dead slots (whose window
    rows hold whatever the turn left there) reach neither output."""
    _, gt, _, pt = setup
    wh, whj, f_dst, bound, a, keepq, _, _ = (
        torch.from_numpy(t) for t in _operands(gt, 12))
    wh[-1] = 1e4  # the dummy sender row of the stream's padding slots
    stream = (gt.senders, gt.r_local, gt.r_chunk, ALPHA)
    v1 = (tfc.fused_v1_window(tfc.gather_corner(wh, gt, pt.fwd), f_dst, bound,
                              a, keepq, gt.r_local, gt.r_chunk, ALPHA),
          tfs.fused_v1(wh, f_dst, bound, a, keepq, *stream))
    win = tfc.gather_corner(torch.cat([whj, wh], 1), gt, pt.fwd)
    v2 = (tfc.fused_v2_window(wh, win, bound, a, keepq, gt.r_local,
                              gt.r_chunk, ALPHA),
          tfs.fused_v2(wh, whj, bound, a, keepq, *stream))
    for got, want in (v1, v2):
        for g_, w_ in zip(got, want):
            assert torch.isfinite(g_).all() and torch.equal(g_, w_)


def test_corner_wrappers_reject_bad_inputs(setup):
    _, gt, _, pt = setup
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    cp = pt.fwd.passes[0]
    with pytest.raises(ValueError, match="128-row tiles"):
        tcorner.permute_pass(torch.zeros(100, 4), cp)
    with pytest.raises(ValueError, match="float32"):
        tcorner.permute_pass(torch.zeros(gt.c_slot.shape[0], 4,
                                         dtype=torch.float64), cp)
    with pytest.raises(ValueError, match="plan rows"):
        tcorner.corner_permute(torch.zeros(128, 4), pt.fwd)
    narrow = (torch.zeros(n, 2), torch.zeros(n, 2), torch.zeros(2, 4),
              torch.zeros(e, 2), gt.r_local, gt.r_chunk, ALPHA)
    with pytest.raises(ValueError, match="window must be"):
        tfc.fused_v1_window(torch.zeros(e - 1, 8), *narrow)
    with pytest.raises(ValueError, match="window must be"):
        tfc.fused_v2_window(torch.zeros(n, 8), torch.zeros(e, 8),
                            *narrow[1:])  # a v1-wide window
    meta = pt.to("meta").fwd.passes[0]
    for call in (lambda: tcorner.permute_pass(
                     torch.zeros(gt.c_slot.shape[0], 4, device="meta"), meta),
                 lambda: tfc.fused_v1_window(
                     torch.zeros(e, 8, device="meta"),
                     *(t.to("meta") if isinstance(t, torch.Tensor) else t
                       for t in narrow))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    for fn in (tcorner.permute_pass, tfc.fused_v1_window,
               tfc.fused_v2_window):
        assert fn.launches == 0
