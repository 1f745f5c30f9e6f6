"""The segment reductions and the segment softmax of the PyTorch port
(``pygat_tpu_torch/ops/segment.py``) against the JAX package's, forward and
gradients, with empty segments and padding edges under ``edge_mask``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.ops import segment as jseg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import ops as tops

N_SEG = 40
N_EDGE = 240
N_PAD_EDGES = 30  # the last edges are padding: masked, receiver N_SEG - 1


@pytest.fixture(scope="module")
def edges():
    """Receiver-sorted ids that leave segments empty (every fifth one, and
    the ones only padding edges reach), senders, the CSR offsets and the
    CSC view, an edge mask, and per-edge data [E, 3] with its cotangents."""
    rng = np.random.default_rng(11)
    used = np.array([i for i in range(N_SEG - 6) if i % 5])
    real = np.sort(rng.choice(used, N_EDGE - N_PAD_EDGES))
    recv = np.concatenate([real, np.full(N_PAD_EDGES, N_SEG - 1)])
    send = rng.integers(0, N_SEG, N_EDGE)
    mask = np.arange(N_EDGE) < N_EDGE - N_PAD_EDGES
    row_ptr = np.zeros(N_SEG + 1, np.int32)
    np.cumsum(np.bincount(recv, minlength=N_SEG), out=row_ptr[1:])
    col_perm = np.lexsort((recv, send)).astype(np.int32)
    col_ptr = np.zeros(N_SEG + 1, np.int32)
    np.cumsum(np.bincount(send, minlength=N_SEG), out=col_ptr[1:])
    data = rng.standard_normal((N_EDGE, 3)).astype(np.float32) * 3
    return dict(recv=recv.astype(np.int32), send=send.astype(np.int32),
                mask=mask, row_ptr=row_ptr, col_perm=col_perm,
                col_ptr=col_ptr, data=data,
                ct_n=rng.standard_normal((N_SEG, 3)).astype(np.float32),
                ct_e=rng.standard_normal((N_EDGE, 3)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(e, jfn, tfn, ct):
    """(JAX output, its vjp of ``ct``), (port output, its gradient) of
    ``fn(data)``."""
    out_j, vjp = jax.vjp(jfn, jnp.asarray(e["data"]))
    (grad_j,) = vjp(jnp.asarray(ct))
    x = _t(e["data"]).clone().requires_grad_()
    out_t = tfn(x)
    grad_t = None  # a detached output has no gradient
    if out_t.requires_grad:
        (grad_t,) = torch.autograd.grad(out_t, x, _t(ct))
    return (np.asarray(out_j), np.asarray(grad_j)), (out_t.detach().numpy(),
                                                      grad_t)


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def test_segment_max_matches_jax(edges):
    e = edges
    (out_j, grad_j), (out_t, grad_t) = _pair(
        e, lambda d: jseg.segment_max(d, jnp.asarray(e["recv"]), N_SEG),
        lambda d: tops.segment_max(d, _t(e["recv"]), N_SEG), e["ct_n"])
    empty = np.bincount(e["recv"], minlength=N_SEG) == 0
    assert empty.any() and np.isneginf(out_t[empty]).all()
    np.testing.assert_array_equal(out_t, out_j)
    _close(grad_t.numpy(), grad_j)  # no ties: each max takes its gradient


def test_sorted_segment_sum_matches_jax(edges):
    e = edges
    (out_j, grad_j), (out_t, grad_t) = _pair(
        e, lambda d: jseg.sorted_segment_sum(d, jnp.asarray(e["recv"]),
                                             jnp.asarray(e["row_ptr"])),
        lambda d: tops.sorted_segment_sum(d, _t(e["recv"]), _t(e["row_ptr"])),
        e["ct_n"])
    _close(out_t, out_j)
    np.testing.assert_array_equal(grad_t.numpy(), grad_j)  # a gather


def test_sorted_segment_max_fills_and_stops_the_gradient(edges):
    e = edges
    (out_j, grad_j), (out_t, grad_t) = _pair(
        e, lambda d: jseg.sorted_segment_max(d, jnp.asarray(e["recv"]),
                                             jnp.asarray(e["row_ptr"])),
        lambda d: tops.sorted_segment_max(d, _t(e["recv"]), _t(e["row_ptr"])),
        e["ct_n"])
    np.testing.assert_array_equal(out_t, out_j)
    empty = np.diff(e["row_ptr"]) == 0
    assert empty.any() and (out_t[empty] == -9e15).all()
    assert not np.asarray(grad_j).any()
    assert grad_t is None  # the port's output is detached


def test_sender_segment_sum_matches_jax(edges):
    e = edges
    args = [jnp.asarray(e[k]) for k in ("send", "col_perm", "col_ptr")]
    (out_j, grad_j), (out_t, grad_t) = _pair(
        e, lambda d: jseg.sender_segment_sum(d, *args),
        lambda d: tops.sender_segment_sum(
            d, *(_t(e[k]) for k in ("send", "col_perm", "col_ptr"))),
        e["ct_n"])
    _close(out_t, out_j)
    np.testing.assert_array_equal(grad_t.numpy(), grad_j)


@pytest.mark.parametrize("masked", [True, False], ids=["edge_mask", "no_mask"])
@pytest.mark.parametrize("sorted_scan", [True, False],
                         ids=["row_ptr", "no_row_ptr"])
def test_segment_softmax_stable_matches_jax(edges, masked, sorted_scan):
    """(num, den) and the gradient of num * ct_e + den[recv] * ct_e through
    both; padding edges give numerator 0 under the mask."""
    e = edges
    recv_j, recv_t = jnp.asarray(e["recv"]), _t(e["recv"])

    def jfn(d):
        num, den = jseg.segment_softmax_stable(
            d, recv_j, N_SEG,
            edge_mask=jnp.asarray(e["mask"])[:, None] if masked else None,
            row_ptr=jnp.asarray(e["row_ptr"]) if sorted_scan else None)
        return num + den[recv_j]

    def tfn(d):
        num, den = tops.segment_softmax_stable(
            d, recv_t, N_SEG, edge_mask=_t(e["mask"]) if masked else None,
            row_ptr=_t(e["row_ptr"]) if sorted_scan else None)
        return num + den[recv_t.long()]

    (out_j, grad_j), (out_t, grad_t) = _pair(e, jfn, tfn, e["ct_e"])
    _close(out_t, out_j)
    _close(grad_t.numpy(), grad_j, rtol=1e-5)
    num, den = tops.segment_softmax_stable(
        _t(e["data"]), recv_t, N_SEG,
        edge_mask=_t(e["mask"]) if masked else None)
    assert (den[np.bincount(e["recv"], minlength=N_SEG) == 0] == 0).all()
    if masked:
        assert (num[~e["mask"]] == 0).all()
        assert (den[N_SEG - 1] == 0).all()  # only padding edges reach it
