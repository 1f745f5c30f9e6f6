"""Stream segment sums of the PyTorch port against the JAX package's Pallas
kernel (interpret mode, ``high`` precision) and its custom VJPs.

On the CPU the port runs the kernel's plain version; the CUDA kernel itself
is held against that plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import stream as jstream
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import stream as tstream

# 'high' is two bf16 limbs (~1e-5 relative per term) on the JAX side and
# plain f32 on the port's side (tests/test_stream.py holds 'high' to the same
# bound against an XLA segment sum).
ATOL_REL = 5e-5


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(7)
    n = 300
    s = np.concatenate([rng.integers(0, n, 1400), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, 1400), np.arange(n)])
    return (jbuild_graph(s, r, None, n),
            tbuild_graph(s, r, None, n, device="cpu"))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("width", [1, 7, 8, 64])
def test_receiver_segment_sum_matches_jax(graphs, width):
    gj, gt = graphs
    rng = np.random.default_rng(width)
    n_pad = gj.num_nodes_padded
    data = rng.standard_normal((gj.num_edges_padded, width)).astype(np.float32)
    cot = rng.standard_normal((n_pad, width)).astype(np.float32)

    def f(d):
        return jstream.stream_segment_sum(d, gj.receivers, gj.r_local,
                                          gj.r_chunk, n_pad, "high", True)

    want, vjp = jax.vjp(f, jnp.asarray(data))
    (want_g,) = vjp(jnp.asarray(cot))

    d = torch.tensor(data, requires_grad=True)
    got = tstream.stream_segment_sum(d, gt.receivers, gt.r_local, gt.r_chunk,
                                     n_pad)
    (got_g,) = torch.autograd.grad(got, d, torch.from_numpy(cot))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_REL * scale)
    # the gradient of a segment sum is a gather: exact
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("width", [1, 7, 8, 64])
def test_sender_segment_sum_matches_jax(graphs, width):
    gj, gt = graphs
    rng = np.random.default_rng(100 + width)
    n_pad = gj.num_nodes_padded
    data = rng.standard_normal((gj.num_edges_padded, width)).astype(np.float32)
    cot = rng.standard_normal((n_pad, width)).astype(np.float32)

    def f(d):
        return jstream.stream_sender_segment_sum(
            d, gj.senders, gj.c_slot, gj.c_local, gj.c_chunk, None, n_pad,
            "high", True)

    want, vjp = jax.vjp(f, jnp.asarray(data))
    (want_g,) = vjp(jnp.asarray(cot))

    d = torch.tensor(data, requires_grad=True)
    got = tstream.stream_sender_segment_sum(d, gt.senders, gt.c_slot,
                                            gt.c_local, gt.c_chunk, n_pad)
    (got_g,) = torch.autograd.grad(got, d, torch.from_numpy(cot))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL_REL * scale)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))


def test_stream_scatter_matches_jax_kernel_with_empty_tile():
    """Direct kernel call: a tile with no live slot is written as zeros
    (one dead chunk), trailing padding chunks add nothing."""
    rng = np.random.default_rng(5)
    r = np.concatenate([rng.integers(0, 100, 500), rng.integers(256, 380, 500)])
    s = rng.integers(0, 383, 1000)
    gj = jbuild_graph(s, r, None, 383, n_pad=384)
    gt = tbuild_graph(s, r, None, 383, n_pad=384, device="cpu")
    data = rng.standard_normal((gj.num_edges_padded, 8)).astype(np.float32)
    want = np.asarray(jstream.stream_scatter(
        jnp.asarray(data), gj.r_local, gj.r_chunk, 384, precision="high",
        interpret=True))
    got = tstream.stream_scatter(_t(data), gt.r_local, gt.r_chunk, 384).numpy()
    np.testing.assert_array_equal(got[128:256], 0.0)
    np.testing.assert_allclose(got, want,
                               atol=ATOL_REL * float(np.abs(want).max()))


def test_sender_dead_slots_skipped_not_zeroed(graphs):
    """Dead sender-side slots point at edge 0 (c_slot is clipped to >= 0):
    they must be skipped by c_local alone, whatever edge 0 carries."""
    _, gt = graphs
    n_pad = gt.num_nodes_padded
    data = torch.zeros(gt.num_edges_padded, 3)
    data[0] = 1e6
    out = tstream.stream_scatter(data, gt.c_local, gt.c_chunk, n_pad,
                                 slot=gt.c_slot)
    assert int((gt.c_local == tstream.DEAD).sum()) > 0
    want = torch.zeros(n_pad, 3)
    want[int(gt.senders[0])] = 1e6
    torch.testing.assert_close(out, want)


def test_wrappers_reject_bad_inputs(graphs):
    _, gt = graphs
    n_pad = gt.num_nodes_padded
    e = gt.num_edges_padded
    with pytest.raises(ValueError, match="float32"):
        tstream.stream_scatter(torch.zeros(e, 2, dtype=torch.float64),
                               gt.r_local, gt.r_chunk, n_pad)
    with pytest.raises(ValueError, match="int32"):
        tstream.stream_scatter(torch.zeros(e, 2), gt.r_local.long(),
                               gt.r_chunk, n_pad)
    with pytest.raises(ValueError, match="multiple"):
        tstream.stream_scatter(torch.zeros(e, 2), gt.r_local, gt.r_chunk, 100)
    with pytest.raises(ValueError, match="stream order"):
        tstream.stream_scatter(torch.zeros(e + 1, 2), gt.r_local, gt.r_chunk,
                               n_pad)


def test_non_cpu_tensor_never_takes_the_plain_path(graphs, monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: the plain version
    is never a fallback. (A meta tensor stands in for one here.)"""
    _, gt = graphs

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(tstream, "stream_scatter_plain", boom)
    data = torch.zeros(gt.num_edges_padded, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tstream.stream_scatter(data, gt.r_local, gt.r_chunk,
                               gt.num_nodes_padded)
    assert tstream.stream_scatter.launches == 0
