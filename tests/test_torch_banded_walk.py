"""The band plan's walk, in the form the port's tile-owner fused kernels
read it (``csrc/tile_fused.cuh``), against the JAX package's fused banded
attention forward in interpret mode, on a graph whose hub tile the plan
cuts into pieces.

The kernels walk each tile's slots with receivers ascending: by position
the sender row (``spmm_walk.rows``, -1 at dead slots), the banded slot
(``spmm_walk.order``, through which ``keepq`` is read) and the local row
(``spmm_walk.local``); a block takes a tile's first piece or one extra
piece of a cut tile, and within it each row's run ``row_ptr`` names,
clipped to the piece's chunks. These tests check on the CPU that this
partition covers every live slot once with its own receiver, and that the
plain versions fed the slots in walk order compute the JAX package's
forward: walking a tile's slots in the kernels' order, cut tile and dead
slots included, is the same function."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import banded as jbd
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops.fused_stream import fused_v1_plain, fused_v2_plain
from pygat_tpu_torch.ops.stream import EC, TILE

ALPHA = 0.2
H, F = 4, 8
HUB, HUB_EDGES = 300, 1000


@pytest.fixture(scope="module")
def setup():
    """A clustered graph of 600 nodes (6 in-edges each from within +-200,
    self loops) plus 1,000 in-edges of node 300 from anywhere, in both
    packages, and its w = 3 band plan, whose hub tile is cut."""
    rng = np.random.default_rng(8)
    n = 600
    base = np.repeat(np.arange(n, dtype=np.int64), 6)
    s = np.clip(base + rng.integers(-200, 200, base.shape[0]), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, HUB_EDGES), np.arange(n)])
    r = np.concatenate([base, np.full(HUB_EDGES, HUB), np.arange(n)])
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    pj, pt = jbd.build_band_plan(gj, w=3), tbd.build_band_plan(gt, w=3)
    assert pt.split_at.numel() > 0  # the hub's tile is walked in pieces
    return gj, gt, pj, pt


def _pieces(plan):
    """(tile, first chunk, end chunk) of every block's chunk range, as
    tile_pieces.cuh's tile_range gives them."""
    tile_ptr, cuts = plan.tile_ptr.numpy(), plan.split_at.numpy()
    n_tiles = tile_ptr.shape[0] - 1
    out = []
    for t in range(n_tiles):
        lo, hi = tile_ptr[t], tile_ptr[t + 1]
        inner = cuts[(cuts > lo) & (cuts < hi)]
        out.append((t, lo, inner[0] if inner.size else hi))
    for e, lo in enumerate(cuts):
        t = int(np.searchsorted(tile_ptr, lo, side="right")) - 1
        hi = tile_ptr[t + 1]
        if e + 1 < cuts.size and cuts[e + 1] < hi:
            hi = cuts[e + 1]
        out.append((t, lo, hi))
    return out


def _assert_walk_partition(plan):
    """Every block's rows' runs, clipped to its chunks, hold only slots of
    that row, and together cover each live position once and no dead
    one."""
    walk = plan.spmm_walk
    row_ptr, local = walk.row_ptr.numpy(), walk.local.numpy()
    assert row_ptr.shape == (plan.n_pad // TILE * (TILE + 1) + 1,)
    hits = np.zeros(plan.num_slots, np.int64)
    for t, c_lo, c_hi in _pieces(plan):
        for row in range(TILE):
            key = t * (TILE + 1) + row
            lo = max(row_ptr[key], c_lo * EC)
            hi = min(row_ptr[key + 1], c_hi * EC)
            if lo < hi:
                assert (local[lo:hi] == row).all()
                hits[lo:hi] += 1
    live = local < TILE
    assert (hits[live] == 1).all() and not hits[~live].any()
    assert (walk.rows.numpy()[live] >= 0).all()
    # the longest receiver run, past which the kernels cut runs into
    # segments: the hub's in-degree
    runs = np.diff(row_ptr).reshape(-1, TILE + 1)[:, :TILE]
    assert plan.max_run == runs.max() >= HUB_EDGES


def _operands(gt, pt, seed):
    rng = np.random.default_rng(seed)
    n = gt.num_nodes_padded
    f32 = np.float32
    wh = rng.standard_normal((n, H * F)).astype(f32)
    whj = rng.standard_normal((n, H * F)).astype(f32)
    f_dst = rng.standard_normal((n, H)).astype(f32)
    bound = np.abs(f_dst) + 2.0
    a = (rng.standard_normal((H, F)) * 0.1).astype(f32)
    keepq = np.where(rng.random((pt.num_slots, H)) < 0.6, 1 / 0.6,
                     0).astype(f32)
    return wh, whj, f_dst, bound, a, keepq


@pytest.mark.parametrize("which", ["v1", "v2"])
def test_walk_order_computes_the_banded_forward(setup, which):
    _, gt, pj, pt = setup
    _assert_walk_partition(pt)
    wh, whj, f_dst, bound, a, keepq = _operands(gt, pt, 12)
    walk = pt.spmm_walk
    # the slots as the kernel reads them: sender rows by position (the
    # dummy row at dead slots, which the plain version never reads into a
    # sum), local rows by position, keep factors through the slot order
    senders = torch.where(walk.rows >= 0, walk.rows,
                          gt.num_nodes_padded - 1).int()
    keep_w = torch.from_numpy(keepq)[walk.order.long()]
    t = torch.from_numpy
    if which == "v1":
        want = jax.jit(lambda *p: jbd.fused_v1_attention_banded(
            *p, pj, alpha=ALPHA, precision="high", interpret=True))(
                *(jnp.asarray(x) for x in (wh, f_dst, bound, a, keepq)))
        got = fused_v1_plain(t(wh), t(f_dst), t(bound), t(a), keep_w,
                             senders, walk.local, pt.r_chunk, ALPHA)
    else:
        want = jax.jit(lambda *p: jbd.fused_v2_attention_banded(
            *p, pj, alpha=ALPHA, precision="high", interpret=True))(
                *(jnp.asarray(x) for x in (wh, whj, bound, a, keepq)))
        got = fused_v2_plain(t(wh), t(whj), t(bound), t(a), keep_w, senders,
                             walk.local, pt.r_chunk, ALPHA)
    # to 1e-5 of the largest value, as tests/test_torch_banded.py holds the
    # forward (the JAX kernels scatter two bf16 limbs, the port sums f32)
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(
            g_.numpy(), w_, rtol=0, atol=1e-5 * max(1.0, float(np.abs(w_).max())))
    hub = got[1][HUB].numpy()
    assert float(hub.max()) > 10.0  # the cut hub row sums many terms
