"""Each output tile's chunk range and the cuts of a hub's tile, which the
port's tile-owner SpMM kernels walk (``tile_ptr`` and ``split_at`` of
``PanelLayout`` and ``BandPlan``, from ``ops.stream.tile_ranges``), the
band plan's SpMM walk in receiver order (``BandPlan.spmm_walk``), and the plain versions of those kernels on a
graph with a hub against the JAX package's SpMM.

The hub graph: 1500 nodes, 3 in-edges each from within +-200 plus self
loops, and 9000 more in-edges of node 700, whose tile owns 38 chunks of the
receiver stream and of a w = 4 band plan (tests/test_torch_cuda.py's hub,
which the kernels split on the card). The SpMM sums agree to 2e-5 of the
same sums over the terms' magnitudes (f32 in another order; the hub's row
has 9000 terms)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops.spmm import spmm as jspmm
from tests.test_torch_spmm import _assert_close
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch import ops
from pygat_tpu_torch.data.synthetic import hub_edges
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops import panel as tpanel
from pygat_tpu_torch.ops.stream import (
    DEAD,
    EC,
    HEAVY_CHUNKS,
    TILE,
    WARP_SLOTS,
    tile_ranges,
)

L = 16


@pytest.fixture(scope="module")
def hub():
    """The hub graph in both packages, its band plan and panel layout, node
    rows, per-edge values (padding edges too, which weigh 0) and the JAX
    package's SpMM of them."""
    rng = np.random.default_rng(9)
    s, r, n = hub_edges(rng)
    gj = jbuild_graph(s, r, None, n)
    gt = tbuild_graph(s, r, None, n, device="cpu")
    x = rng.standard_normal((gt.num_nodes_padded, L)).astype(np.float32)
    w = rng.standard_normal(gt.num_edges_padded).astype(np.float32)
    want = np.asarray(jax.jit(jspmm)(jnp.asarray(w), jnp.asarray(x),
                                     gj.senders, gj.receivers, gj.edge_mask))
    return (gt, tbd.build_band_plan(gt, w=4), tpanel.build_panel_layout(gt),
            x, w, want)


@pytest.mark.parametrize("hot", [False, True])
def test_tile_ranges(hot):
    """Tiles 1 and 5 own no chunk (empty ranges), tile 3 one chunk whose
    256 live slots are all one row's (one warp's load, not cut), tile 4
    owns 40 chunks: all dead, it is cut by its chunk count into
    ceil(40 / HEAVY_CHUNKS) pieces; every slot one row's (``hot``), into
    one piece per chunk."""
    chunk_tile = np.array([0, 0, 2, 2, 2, 3] + [4] * 40)
    local = np.full(chunk_tile.size * EC, DEAD, np.int32)
    local[5 * EC:6 * EC] = 7
    if hot:
        local[6 * EC:] = 3
    tile_ptr, split_at = tile_ranges(chunk_tile, local, 6)
    np.testing.assert_array_equal(tile_ptr, [0, 2, 2, 5, 6, 46, 46])
    assert tile_ptr.dtype == split_at.dtype == np.int32
    for t in range(6):
        np.testing.assert_array_equal(
            chunk_tile[tile_ptr[t]:tile_ptr[t + 1]], t)
    assert WARP_SLOTS == EC and HEAVY_CHUNKS == 16
    want = np.arange(7, 46) if hot else [6 + 40 // 3, 6 + 80 // 3]
    np.testing.assert_array_equal(split_at, want)
    with pytest.raises(ValueError, match="sorted"):
        tile_ranges(chunk_tile[::-1], local, 6)


@pytest.mark.parametrize("which", ["band plan", "panel layout"])
def test_tile_ptr_of_layouts_and_plans(hub, which):
    """tile_ptr is searchsorted of the chunk-to-tile map; only the hub's
    tile is cut, into pieces of equal chunk counts, enough of them that no
    warp adds more than WARP_SLOTS of the hub's 9000 slots; .to() moves the
    two fields with the rest."""
    gt, plan, layout, *_ = hub
    n_tiles = gt.num_nodes_padded // TILE
    r_chunk, r_local, obj = (
        (plan.r_chunk, plan.r_local, plan) if which == "band plan"
        else (gt.r_chunk, gt.r_local, layout))
    want = np.searchsorted(r_chunk.numpy(), np.arange(n_tiles + 1))
    ptr = obj.tile_ptr.numpy()
    np.testing.assert_array_equal(ptr, want)
    assert obj.tile_ptr.dtype == obj.split_at.dtype == torch.int32
    assert ptr[-1] == r_chunk.numel()
    hub_tile = 700 // TILE
    cuts = obj.split_at.numpy()
    assert ((cuts > ptr[hub_tile]) & (cuts < ptr[hub_tile + 1])).all()
    n_hub = int((r_local.view(-1, EC)[ptr[hub_tile]:ptr[hub_tile + 1]]
                 == 700 % TILE).sum())
    assert n_hub >= 9000 and cuts.size + 1 >= n_hub / WARP_SLOTS
    sizes = np.diff(np.concatenate([[ptr[hub_tile]], cuts,
                                    [ptr[hub_tile + 1]]]))
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    moved = obj.to("meta")
    assert moved.tile_ptr.device.type == moved.split_at.device.type == "meta"
    assert moved.split_at.shape == obj.split_at.shape


def test_band_plan_recv_order(hub):
    """The banded SpMM walks each tile's slots with receivers ascending:
    the walk's order permutes the slots within their tiles, stably, its rows
    and local rows are the sender rows (-1 dead) and local rows of the slots
    so walked; it is built once, at first use, and a plan moved by .to()
    builds its own on its device."""
    _, plan, *_ = hub
    walk = plan.spmm_walk
    assert plan.spmm_walk is walk
    order = walk.order.numpy()
    np.testing.assert_array_equal(walk.rows.numpy(),
                                  tbd.banded_senders(plan, -1).numpy()[order])
    np.testing.assert_array_equal(walk.local.numpy(),
                                  plan.r_local.numpy()[order])
    for t in walk:
        assert t.dtype == torch.int32 and t.is_contiguous()
    np.testing.assert_array_equal(np.sort(order), np.arange(plan.num_slots))
    tile = np.repeat(plan.r_chunk.numpy(), EC)
    np.testing.assert_array_equal(tile[order], tile)
    key = tile[order] * (TILE + 1) + plan.r_local.numpy()[order]
    assert (np.diff(key) >= 0).all()
    same = np.diff(key) == 0
    assert (np.diff(order)[same] > 0).all()  # stable
    moved = plan.to("cpu")
    assert "spmm_walk" not in moved.__dict__
    for a, b in zip(moved.spmm_walk, walk):
        assert a is not b and torch.equal(a, b)


@pytest.mark.parametrize("route", ["panel plain", "banded plain",
                                   "panel_spmm_graph", "spmm_banded"])
def test_plain_spmm_kernels_match_jax_on_the_hub(hub, route):
    """The plain versions of both SpMM kernels (the CPU's path), and the ops
    around them, against the JAX package's spmm on the same graph."""
    gt, plan, layout, x, w, want = hub
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    live = plan.perm >= 0
    w_b = np.zeros(plan.num_slots, np.float32)
    w_b[live] = w[plan.perm[live]]
    w_b = torch.from_numpy(w_b)
    args = (layout.panel_tiles, layout.g_idx, gt.edge_mask, gt.r_local,
            gt.r_chunk, layout.tile_ptr, layout.split_at)
    got = {"panel plain": lambda: tpanel.panel_weighted_sum_plain(
               wt, xt, *args),
           "banded plain": lambda: tbd.banded_weighted_sum_plain(
               w_b, xt, plan),
           "panel_spmm_graph": lambda: ops.panel_spmm_graph(
               wt, xt, gt, layout, precision="high"),
           "spmm_banded": lambda: ops.spmm_banded(w_b, xt, plan,
                                                  precision="high")}[route]()
    mag = ops.spmm(wt.abs(), xt.abs(), gt.senders, gt.receivers,
                   gt.edge_mask).numpy()
    assert float(mag.max()) > 1000.0  # the hub's row
    _assert_close(got.numpy(), want, route, mag)
