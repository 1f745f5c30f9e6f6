"""The PyTorch port's banded kernels (their plain versions, which the CPU
runs) against the JAX package's Pallas functions in interpret mode, on the
same graph and plan: ``expand`` and ``banded_take`` bit-exact,
``banded_sender_sum`` to f32 rounding, and the fused banded attention ops,
forward and the gradient of every differentiable input, at the tolerances
of tests/test_banded.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import banded as jbd
from pygat_tpu.ops.large import _expand_impl
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops.large import expand

ALPHA = 0.2
H, F = 4, 8


@pytest.fixture(scope="module")
def setup():
    """A clustered graph of 600 nodes whose plan has several chunks per
    tile, dead slots and all-dead padding chunks, in both packages."""
    rng = np.random.default_rng(3)
    n = 600
    base = np.repeat(np.arange(n, dtype=np.int64), 6)
    s = np.clip(base + rng.integers(-200, 200, base.shape[0]), 0, n - 1)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([base, np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    pj, pt = jbd.build_band_plan(gj, w=3), tbd.build_band_plan(gt, w=3)
    assert pt.num_chunks > gt.num_nodes_padded // 128  # several per tile
    return gj, gt, pj, pt


def test_expand_matches_jax_bit_exact(setup):
    _, gt, pj, pt = setup
    x = np.random.default_rng(0).standard_normal(
        (gt.num_nodes_padded, 11)).astype(np.float32)
    want = jax.jit(lambda v: _expand_impl(v, pj.r_local, pj.r_chunk, True))(
        jnp.asarray(x))
    got = expand(torch.from_numpy(x), pt.r_local, pt.r_chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_banded_take_matches_jax_bit_exact(setup):
    _, gt, pj, pt = setup
    table = np.random.default_rng(1).standard_normal(
        (gt.num_nodes_padded, 13)).astype(np.float32)
    want = jax.jit(lambda v: jbd.banded_take(v, pj, exact=True,
                                             interpret=True))(jnp.asarray(table))
    got = tbd.banded_take(torch.from_numpy(table), pt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_banded_sender_sum_matches_jax(setup):
    """Dead slots carry data too (it must be ignored). The JAX kernel sums
    two bf16 limbs (about 16 mantissa bits) where the port sums f32, so the
    sums agree to 2e-5 of the same sums over |data|."""
    _, gt, pj, pt = setup
    n_pad = gt.num_nodes_padded
    data = np.random.default_rng(2).standard_normal(
        (pt.num_slots, 9)).astype(np.float32)
    want = jax.jit(lambda d: jbd._banded_sender_sum_direct(
        d, pj.bs_band, pj.bs_chunk, pj.bs_sloc, pj.w, n_pad, "high",
        True))(jnp.asarray(data))
    got = tbd.banded_sender_sum(torch.from_numpy(data), pt)
    mag = tbd.banded_sender_sum(torch.from_numpy(np.abs(data)), pt)
    assert float(got.abs().max()) > 1.0  # the sums are not idle
    assert bool(((got - torch.from_numpy(np.array(want))).abs()
                 <= 2e-5 * mag + 1e-30).all())


def _operands(gt, pt, seed):
    """Node tables, the v1 bound and the v2 ub as tests/test_banded.py makes
    them, keep factors of dropout 0.4 over the banded slots, cotangents."""
    rng = np.random.default_rng(seed)
    n = gt.num_nodes_padded
    f32 = np.float32
    wh = rng.standard_normal((n, H * F)).astype(f32)
    whj = rng.standard_normal((n, H * F)).astype(f32)
    f_dst = rng.standard_normal((n, H)).astype(f32)
    bound = np.abs(f_dst) + 2.0
    a = (rng.standard_normal((H, F)) * 0.1).astype(f32)
    keepq = np.where(rng.random((pt.num_slots, H)) < 0.6, 1 / 0.6, 0).astype(f32)
    g_out = rng.standard_normal((n, H * F)).astype(f32)
    g_den = rng.standard_normal((n, H)).astype(f32)
    return wh, whj, f_dst, bound, a, keepq, g_out, g_den


def _vjp_jax(op, primals, cts):
    @jax.jit  # interpret mode op by op costs several times the compile
    def run(*p):
        (out, den), vjp = jax.vjp(op, *p)
        return out, den, vjp(cts)

    return run(*(jnp.asarray(p) for p in primals))


def _vjp_torch(op, primals, cts):
    leaves = [torch.tensor(p, requires_grad=True) for p in primals]
    out, den = op(*leaves)
    grads = torch.autograd.grad((out, den), leaves,
                                tuple(torch.from_numpy(c) for c in cts))
    return out.detach(), den.detach(), grads


def _assert_close(got, want):
    out_t, den_t, grads_t = got
    out_j, den_j, grads_j = want
    # outputs to 1e-5 of their largest value, gradients to rtol 2e-4 /
    # atol 2e-5: the JAX kernels scatter two bf16 limbs (about 16 mantissa
    # bits, so a sum is off by up to 1.5e-5 of its terms' magnitude) where
    # the port sums f32, both in other orders
    for got, want in ((out_t, out_j), (den_t, den_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))
    assert float(den_t.max()) > 0.1  # the comparison is not idle
    for i, (gt_, gj_) in enumerate(zip(grads_t, grads_j)):
        np.testing.assert_allclose(gt_.numpy(), np.asarray(gj_), rtol=2e-4,
                                   atol=2e-5, err_msg=f"gradient {i}")


def test_fused_v1_attention_banded_matches_jax(setup):
    _, gt, pj, pt = setup
    wh, _, f_dst, bound, a, keepq, g_out, g_den = _operands(gt, pt, 10)
    want = _vjp_jax(
        lambda w_, f_, a_: jbd.fused_v1_attention_banded(
            w_, f_, jnp.asarray(bound), a_, jnp.asarray(keepq), pj,
            alpha=ALPHA, precision="high", interpret=True),
        (wh, f_dst, a), (jnp.asarray(g_out), jnp.asarray(g_den)))
    got = _vjp_torch(
        lambda w_, f_, a_: tbd.fused_v1_attention_banded(
            w_, f_, torch.from_numpy(bound), a_, torch.from_numpy(keepq), pt,
            ALPHA),
        (wh, f_dst, a), (g_out, g_den))
    _assert_close(got, want)


def test_fused_v2_attention_banded_matches_jax(setup):
    _, gt, pj, pt = setup
    whi, whj, _, ub, a, keepq, g_out, g_den = _operands(gt, pt, 11)
    want = _vjp_jax(
        lambda i_, j_, a_: jbd.fused_v2_attention_banded(
            i_, j_, jnp.asarray(ub), a_, jnp.asarray(keepq), pj,
            alpha=ALPHA, precision="high", interpret=True),
        (whi, whj, a), (jnp.asarray(g_out), jnp.asarray(g_den)))
    got = _vjp_torch(
        lambda i_, j_, a_: tbd.fused_v2_attention_banded(
            i_, j_, torch.from_numpy(ub), a_, torch.from_numpy(keepq),
            pt, ALPHA),
        (whi, whj, a), (g_out, g_den))
    _assert_close(got, want)


def test_banded_dead_slots_are_killed_before_the_exp(setup):
    """A dead slot has no sender; its plain version reads the dummy row
    N_pad - 1, whose huge entries must not reach the outputs or the
    gradients (no inf * 0 = NaN)."""
    _, gt, _, pt = setup
    n = gt.num_nodes_padded
    wh = torch.zeros(n, H * F)
    wh[n - 1] = 1e4
    leaves = [wh.clone().requires_grad_(), torch.zeros(n, H * F,
                                                       requires_grad=True),
              torch.ones(H, F, requires_grad=True)]
    keepq = torch.ones(pt.num_slots, H)
    out1, den1 = tbd.fused_v1_attention_banded(
        leaves[0], torch.zeros(n, H), torch.zeros(n, H), leaves[2], keepq, pt,
        ALPHA)
    out2, den2 = tbd.fused_v2_attention_banded(
        leaves[1], leaves[0], torch.zeros(n, H), leaves[2], keepq, pt, ALPHA)
    total = out1.sum() + den1.sum() + out2.sum() + den2.sum()
    assert torch.isfinite(total)
    total.backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)


def test_banded_wrappers_reject_bad_inputs(setup):
    _, gt, _, pt = setup
    n = gt.num_nodes_padded
    with pytest.raises(ValueError, match=r"table must be"):
        tbd.banded_take(torch.zeros(n - 128, 4), pt)  # another graph's table
    with pytest.raises(ValueError, match=r"table must be"):
        tbd.banded_take(torch.zeros(n, 4, dtype=torch.float64), pt)
    with pytest.raises(ValueError, match="banded order"):
        tbd.banded_sender_sum(torch.zeros(pt.num_slots - 1, 4), pt)
    with pytest.raises(ValueError, match="float32"):
        expand(torch.zeros(n, 4, dtype=torch.float64), pt.r_local, pt.r_chunk)
    with pytest.raises(ValueError, match="stream"):
        tbd.fused_v1_banded(torch.zeros(n, 8), torch.zeros(n, 2),
                            torch.zeros(n, 2), torch.zeros(2, 4),
                            torch.zeros(pt.num_slots - 1, 2), pt, ALPHA)
    meta = pt.to("meta")
    for call in (lambda: tbd.banded_take(torch.zeros(n, 4, device="meta"),
                                         meta),
                 lambda: tbd.banded_sender_sum(
                     torch.zeros(pt.num_slots, 4, device="meta"), meta),
                 lambda: expand(torch.zeros(n, 4, device="meta"),
                                meta.r_local, meta.r_chunk),
                 lambda: tbd.fused_v2_banded(
                     *(torch.zeros(n, 8, device="meta") for _ in range(2)),
                     torch.zeros(n, 2, device="meta"),
                     torch.zeros(2, 4, device="meta"),
                     torch.zeros(pt.num_slots, 2, device="meta"), meta,
                     ALPHA)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    for fn in (tbd.banded_take, tbd.banded_sender_sum, expand,
               tbd.fused_v1_banded, tbd.fused_v2_banded):
        assert fn.launches == 0
