"""Fused GATv1 attention of the PyTorch port against the JAX package's
Pallas op (interpret mode, ``high`` precision): forward ``(out, den)`` and
the gradients of ``wh``, ``f_dst`` and ``a_src``; and ``softmax_div``'s
stable backward."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.models import layers as jlayers
from pygat_tpu.ops import fused_stream as jfs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.models import layers as tlayers
from pygat_tpu_torch.ops import fused_stream as tfs

ALPHA = 0.2


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(3)
    n = 300
    s = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 6), np.arange(n)])
    return (jbuild_graph(s, r, None, n),
            tbuild_graph(s, r, None, n, device="cpu"))


def _inputs(g, h, f, seed):
    """wh, f_dst, bound (as the layer builds it), a_src, keepq with dropout
    keep factors (p = 0.4), and cotangents, all from one numpy seed."""
    rng = np.random.default_rng(seed)
    n, e = g.num_nodes_padded, g.num_edges_padded
    wh = rng.standard_normal((n, h * f)).astype(np.float32) * 0.5
    a = rng.standard_normal((h, 2 * f)).astype(np.float32) * 0.5
    wh3 = wh.reshape(n, h, f)
    f_dst = np.einsum("nho,ho->nh", wh3, a[:, :f]).astype(np.float32)
    f_src = np.einsum("nho,ho->nh", wh3, a[:, f:])
    mask = np.asarray(g.node_mask)
    m_src = np.where(mask[:, None], f_src, -np.inf).max(0)
    raw = f_dst + m_src[None]
    bound = np.where(raw >= 0, raw, ALPHA * raw).astype(np.float32)
    keepq = np.where(rng.random((e, h)) < 0.6, 1.0 / 0.6, 0.0).astype(np.float32)
    g_out = rng.standard_normal((n, h * f)).astype(np.float32)
    g_den = rng.standard_normal((n, h)).astype(np.float32)
    return wh, f_dst, bound, np.ascontiguousarray(a[:, f:]), keepq, g_out, g_den


@pytest.mark.parametrize("h,f", [(4, 8), (1, 7)])
def test_fused_v1_attention_matches_jax(graphs, h, f):
    gj, gt = graphs
    wh, f_dst, bound, a_src, keepq, g_out, g_den = _inputs(gj, h, f, 10 * h + f)

    def jfn(wh_, f_dst_, a_src_):
        return jfs.fused_v1_attention(
            wh_, f_dst_, jnp.asarray(bound), a_src_, jnp.asarray(keepq),
            gj.senders, gj.receivers, gj.r_local, gj.r_chunk, gj.c_slot,
            gj.c_local, gj.c_chunk, ALPHA, "high", True)

    @jax.jit  # interpret mode op by op costs several times the compile
    def run(wh_, f_dst_, a_src_):
        (out, den), vjp = jax.vjp(jfn, wh_, f_dst_, a_src_)
        return out, den, vjp((jnp.asarray(g_out), jnp.asarray(g_den)))

    out_j, den_j, grads_j = run(jnp.asarray(wh), jnp.asarray(f_dst),
                                jnp.asarray(a_src))

    leaves = [torch.tensor(v, requires_grad=True) for v in (wh, f_dst, a_src)]
    out_t, den_t = tfs.fused_v1_attention(
        leaves[0], leaves[1], torch.from_numpy(bound), leaves[2],
        torch.from_numpy(keepq), gt.senders, gt.receivers, gt.r_local,
        gt.r_chunk, gt.c_slot, gt.c_local, gt.c_chunk, ALPHA)
    grads_t = torch.autograd.grad((out_t, den_t), leaves,
                                  (torch.from_numpy(g_out),
                                   torch.from_numpy(g_den)))

    # tolerances of tests/test_fused.py: the JAX 'high' kernel keeps ~16
    # mantissa bits in its scatter, the port sums in f32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(den_t.detach().numpy(), np.asarray(den_j),
                               atol=2e-4, rtol=1e-4)
    for name, gt_, gj_ in zip(("wh", "f_dst", "a_src"), grads_t, grads_j):
        gj_ = np.asarray(gj_)
        scale = float(np.abs(gj_).max())
        np.testing.assert_allclose(gt_.numpy(), gj_, atol=5e-5 * scale,
                                   err_msg=name)


def test_stream_receivers_match_the_graph(graphs):
    """The receivers the kernel works out from r_chunk/r_local are the
    graph's, dead slots included (their tile's last row)."""
    _, gt = graphs
    torch.testing.assert_close(tfs.stream_receivers(gt.r_local, gt.r_chunk),
                               gt.receivers.long(), rtol=0, atol=0)


def test_dead_slots_are_killed_before_the_exp(graphs):
    """A dead slot whose logit would overflow the exp must contribute
    nothing (no inf * 0 = NaN), in the forward and the backward."""
    _, gt = graphs
    h, f = 2, 3
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    dummy = n - 1  # dead slots' sender
    wh = torch.zeros(n, h * f)
    wh[dummy] = 1e4  # unbounded logit at every dead slot
    wh.requires_grad_()
    a_src = torch.ones(h, f, requires_grad=True)
    f_dst = torch.zeros(n, h, requires_grad=True)
    bound = torch.zeros(n, h)
    keepq = torch.ones(e, h)
    out, den = tfs.fused_v1_attention(
        wh, f_dst, bound, a_src, keepq, gt.senders, gt.receivers, gt.r_local,
        gt.r_chunk, gt.c_slot, gt.c_local, gt.c_chunk, ALPHA)
    assert torch.isfinite(out).all() and torch.isfinite(den).all()
    (out.sum() + den.sum()).backward()
    for t in (wh, a_src, f_dst):
        assert torch.isfinite(t.grad).all()


def test_fused_wrapper_rejects_bad_inputs(graphs):
    _, gt = graphs
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    args = [torch.zeros(n, 8), torch.zeros(n, 2), torch.zeros(n, 2),
            torch.zeros(2, 4), torch.zeros(e, 2), gt.senders, gt.r_local,
            gt.r_chunk, ALPHA]
    bad = list(args)
    bad[3] = torch.zeros(2, 3)  # H*F != wh width
    with pytest.raises(ValueError):
        tfs.fused_v1(*bad)
    bad = list(args)
    bad[4] = torch.zeros(e - 1, 2)
    with pytest.raises(ValueError, match="stream"):
        tfs.fused_v1(*bad)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.fused_v1(*meta)
    assert tfs.fused_v1.launches == 0


@pytest.mark.parametrize("den_value", [1.0, 3e-18, 1.2e-18, 5e-19])
def test_softmax_div_backward_matches_jax_and_stays_finite(den_value):
    """Just above DEN_MIN a naive backward (g * agg / den^2) overflows; the
    stable VJP forms -sum(g * out) / den. Below the clamp rows pass
    through with zero den-gradient."""
    rng = np.random.default_rng(1)
    agg = (rng.standard_normal((5, 3, 4)) * den_value * 50).astype(np.float32)
    den = np.full((5, 3), den_value, np.float32)
    g = rng.standard_normal((5, 3, 4)).astype(np.float32) * 1e3

    out_j, vjp = jax.vjp(jlayers.softmax_div, jnp.asarray(agg), jnp.asarray(den))
    ga_j, gd_j = vjp(jnp.asarray(g))

    a_t = torch.tensor(agg, requires_grad=True)
    d_t = torch.tensor(den, requires_grad=True)
    out_t = tlayers.softmax_div(a_t, d_t)
    ga_t, gd_t = torch.autograd.grad(out_t, (a_t, d_t), torch.from_numpy(g))
    for got, want in ((out_t.detach(), out_j), (ga_t, ga_j), (gd_t, gd_j)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
    if den_value <= tlayers.DEN_MIN:
        np.testing.assert_array_equal(gd_t.numpy(), 0.0)
