"""Fused GATv2 attention of the PyTorch port against the JAX package's
Pallas op (interpret mode, ``high`` precision): forward ``(out, den)`` and
the gradients of ``whi``, ``whj`` and ``a``; dead slots; argument checks."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import fused_stream as jfs
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import fused_stream as tfs

ALPHA = 0.2


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(5)
    n = 200
    s = np.concatenate([rng.integers(0, n, n * 5), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, n * 5), np.arange(n)])
    return (jbuild_graph(s, r, None, n),
            tbuild_graph(s, r, None, n, device="cpu"))


def _leaky(x):
    return np.where(x >= 0, x, ALPHA * x)


def _inputs(g, h, f, seed):
    """whi, whj, ub (the sign-split bound, as the layer builds it), a, keepq
    with dropout keep factors (p = 0.4), and cotangents, from one numpy
    seed."""
    rng = np.random.default_rng(seed)
    n, e = g.num_nodes_padded, g.num_edges_padded
    whi = rng.standard_normal((n, h * f)).astype(np.float32) * 0.5
    whj = rng.standard_normal((n, h * f)).astype(np.float32) * 0.5
    a = rng.standard_normal((h, f)).astype(np.float32) * 0.5
    mask = np.asarray(g.node_mask)[:, None]
    hi = np.where(mask, whj, -np.inf).max(0).reshape(1, h, f)
    lo = np.where(mask, whj, np.inf).min(0).reshape(1, h, f)
    whi3 = whi.reshape(n, h, f)
    ub = (np.einsum("nhf,hf->nh", _leaky(whi3 + hi), np.maximum(a, 0))
          + np.einsum("nhf,hf->nh", _leaky(whi3 + lo), np.minimum(a, 0)))
    keepq = np.where(rng.random((e, h)) < 0.6, 1.0 / 0.6, 0.0).astype(np.float32)
    g_out = rng.standard_normal((n, h * f)).astype(np.float32)
    g_den = rng.standard_normal((n, h)).astype(np.float32)
    return whi, whj, ub.astype(np.float32), a, keepq, g_out, g_den


@pytest.mark.parametrize("h,f", [(4, 8), (1, 7)])
def test_fused_v2_attention_matches_jax(graphs, h, f):
    gj, gt = graphs
    whi, whj, ub, a, keepq, g_out, g_den = _inputs(gj, h, f, 10 * h + f)

    def jfn(whi_, whj_, a_):
        return jfs.fused_v2_attention(
            whi_, whj_, jnp.asarray(ub), a_, jnp.asarray(keepq),
            gj.senders, gj.receivers, gj.r_local, gj.r_chunk, gj.c_slot,
            gj.c_local, gj.c_chunk, ALPHA, "high", True)

    @jax.jit  # interpret mode op by op costs several times the compile
    def run(whi_, whj_, a_):
        (out, den), vjp = jax.vjp(jfn, whi_, whj_, a_)
        return out, den, vjp((jnp.asarray(g_out), jnp.asarray(g_den)))

    out_j, den_j, grads_j = run(jnp.asarray(whi), jnp.asarray(whj),
                                jnp.asarray(a))

    leaves = [torch.tensor(v, requires_grad=True) for v in (whi, whj, a)]
    out_t, den_t = tfs.fused_v2_attention(
        leaves[0], leaves[1], torch.from_numpy(ub), leaves[2],
        torch.from_numpy(keepq), gt.senders, gt.receivers, gt.r_local,
        gt.r_chunk, gt.c_slot, gt.c_local, gt.c_chunk, ALPHA)
    grads_t = torch.autograd.grad((out_t, den_t), leaves,
                                  (torch.from_numpy(g_out),
                                   torch.from_numpy(g_den)))

    # tolerances of the v1 test: the JAX 'high' kernel keeps ~16 mantissa
    # bits in its scatter, the port sums in f32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(den_t.detach().numpy(), np.asarray(den_j),
                               atol=2e-4, rtol=1e-4)
    # the bound holds: no numerator exceeds 1, so den <= in-degree
    live = gt.r_local < 128
    deg = torch.zeros(gt.num_nodes_padded).index_add_(
        0, gt.receivers.long()[live], torch.ones(int(live.sum())))
    assert bool((den_t.detach() <= deg[:, None] * (1 + 1e-5)).all())
    for name, gt_, gj_ in zip(("whi", "whj", "a"), grads_t, grads_j):
        gj_ = np.asarray(gj_)
        scale = float(np.abs(gj_).max())
        np.testing.assert_allclose(gt_.numpy(), gj_, atol=5e-5 * scale,
                                   err_msg=name)


def test_v2_message_is_the_left_projection_at_the_sender(graphs):
    """With whj = 0 and a = 0 every live numerator is 1, so out is the plain
    neighbour sum of whi over senders (not of whj) and den the in-degree."""
    _, gt = graphs
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    h, f = 2, 3
    rng = np.random.default_rng(0)
    whi = torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32))
    out, den = tfs.fused_v2(
        whi, torch.zeros(n, h * f), torch.zeros(n, h), torch.zeros(h, f),
        torch.ones(e, h), gt.senders, gt.r_local, gt.r_chunk, ALPHA)
    live = gt.r_local < 128
    rcv, snd = gt.receivers.long()[live], gt.senders.long()[live]
    want = torch.zeros(n, h * f).index_add_(0, rcv, whi[snd])
    deg = torch.zeros(n).index_add_(0, rcv, torch.ones(rcv.shape[0]))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(den, deg[:, None].expand(n, h), rtol=0, atol=0)


def test_v2_dead_slots_are_killed_before_the_exp(graphs):
    """A dead slot whose logit would overflow the exp must contribute
    nothing (no inf * 0 = NaN), in the forward and the backward."""
    _, gt = graphs
    h, f = 2, 3
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    whj = torch.zeros(n, h * f)
    whj[n - 1] = 1e4  # the dummy row every dead slot points at
    whj.requires_grad_()
    whi = torch.zeros(n, h * f, requires_grad=True)
    a = torch.ones(h, f, requires_grad=True)
    out, den = tfs.fused_v2_attention(
        whi, whj, torch.zeros(n, h), a, torch.ones(e, h), gt.senders,
        gt.receivers, gt.r_local, gt.r_chunk, gt.c_slot, gt.c_local,
        gt.c_chunk, ALPHA)
    assert torch.isfinite(out).all() and torch.isfinite(den).all()
    (out.sum() + den.sum()).backward()
    for t in (whi, whj, a):
        assert torch.isfinite(t.grad).all()


def test_fused_v2_wrapper_rejects_bad_inputs(graphs):
    _, gt = graphs
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    args = [torch.zeros(n, 8), torch.zeros(n, 8), torch.zeros(n, 2),
            torch.zeros(2, 4), torch.zeros(e, 2), gt.senders, gt.r_local,
            gt.r_chunk, ALPHA]
    bad = list(args)
    bad[3] = torch.zeros(2, 3)  # H*F != table width
    with pytest.raises(ValueError, match="does not match"):
        tfs.fused_v2(*bad)
    bad = list(args)
    bad[1] = torch.zeros(n, 4)  # whj narrower than whi
    with pytest.raises(ValueError, match=r"\[N, HF\]"):
        tfs.fused_v2(*bad)
    bad = list(args)
    bad[4] = torch.zeros(e - 1, 2)
    with pytest.raises(ValueError, match="stream"):
        tfs.fused_v2(*bad)
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="float32"):
        tfs.fused_v2(*bad)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.fused_v2(*meta)
    assert tfs.fused_v2.launches == 0
