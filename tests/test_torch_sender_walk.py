"""The walks of the port's tile-owner segment sums (``csrc/tile_sum.cuh``,
kernel rows 1 and 6) in all four orders, on the CPU: the receiver stream's
(``Graph.stream_walk``), the graph's CSC stream (``Graph.sender_walk``,
whose dummy sender's run holds the receiver stream's padding slots), a band
plan's receiver walk (its SpMM walk) and its sender walk
(``BandPlan.sender_walk``, over the live banded slots only).

The kernels take a tile's first piece or one extra piece of a cut tile per
block and, within it, each row's run that ``row_ptr`` names, clipped to the
piece's chunks; position k reads the data row ``rows[k]`` (a slot map or the
walk's order) or k. These tests check that the partition covers every live
slot once and no dead one, that the pieces summed in that partition give
the plain versions' sums, and that the plain versions in float64
(``f64=True``, the kernels' oracle on the card) give the JAX package's
Pallas kernels' sums (interpret mode). The kernels themselves are held to
that oracle on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import banded as jbd
from pygat_tpu.ops import stream as jstream
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops import stream as tst
from pygat_tpu_torch.ops.stream import EC, TILE

N, HUB, HUB_EDGES = 383, 50, 600
L = 6
# the JAX kernels sum two bf16 limbs (about 16 mantissa bits), the plain
# versions float64: the sums agree to 2e-5 of the same sums over |data|
# (tests/test_torch_banded.py's bound)
JAX_RTOL = 2e-5
# the pieces summed in float64 against the plain version summed in float64
# and returned in float32 (rounded: half a float32 unit)
PIECES_RTOL = 6e-8


def _edges():
    """Tile 0's rows 0..99 and tile 2's rows 256..379 take edges from
    within +-60 (so a band plan of w = 2 holds them), node 50 600 more from
    tile 0; tile 1 (rows 128..255) has none."""
    rng = np.random.default_rng(21)
    r = np.concatenate([rng.integers(0, 100, 500),
                        rng.integers(256, 380, 500), np.full(HUB_EDGES, HUB)])
    s = np.clip(r + rng.integers(-60, 60, r.shape[0]), 0, N - 1)
    return s, r


@pytest.fixture(scope="module")
def graphs():
    s, r = _edges()
    gj = jbuild_graph(s, r, None, N, n_pad=384)
    gt = tbuild_graph(s, r, None, N, n_pad=384, device="cpu")
    return gj, gt, jbd.build_band_plan(gj, w=2), tbd.build_band_plan(gt, w=2)


def _orders(gt, pt):
    """name -> (walk, rows by position or None, number of data rows, the
    plain version of data)."""
    n_pad = gt.num_nodes_padded
    recv = tbd._receiver_walk("test", pt)
    return {
        "receiver stream": (gt.stream_walk, None, gt.num_edges_padded,
                            lambda d, **k: tst.stream_scatter_plain(
                                d, gt.r_local, gt.r_chunk, n_pad, **k)),
        "CSC stream by c_slot": (gt.sender_walk, gt.c_slot,
                                 gt.num_edges_padded,
                                 lambda d, **k: tst.stream_scatter_plain(
                                     d, gt.c_local, gt.c_chunk, n_pad,
                                     slot=gt.c_slot, **k)),
        "CSC stream in CSC order": (gt.sender_walk, None, gt.c_local.numel(),
                                    lambda d, **k: tst.stream_scatter_plain(
                                        d, gt.c_local, gt.c_chunk, n_pad,
                                        **k)),
        "band plan receivers": (recv, recv.order, pt.num_slots,
                                lambda d, **k: tst.stream_scatter_plain(
                                    d, pt.r_local, pt.r_chunk, n_pad, **k)),
        "band plan senders": (pt.sender_walk, pt.sender_walk.order,
                              pt.num_slots,
                              lambda d, **k: tbd.banded_sender_sum_plain(
                                  d, pt, **k)),
    }


def _pieces(walk):
    """(tile, first chunk, end chunk, piece) of every block, as
    tile_pieces.cuh's tile_range gives them (piece -1: the tile's first)."""
    tile_ptr, cuts = walk.tile_ptr.numpy(), walk.split_at.numpy()
    n_tiles = tile_ptr.shape[0] - 1
    out = []
    for t in range(n_tiles):
        lo, hi = tile_ptr[t], tile_ptr[t + 1]
        inner = cuts[(cuts > lo) & (cuts < hi)]
        out.append((t, lo, inner[0] if inner.size else hi, -1))
    for e, lo in enumerate(cuts):
        t = int(np.searchsorted(tile_ptr, lo, side="right")) - 1
        hi = tile_ptr[t + 1]
        if e + 1 < cuts.size and cuts[e + 1] < hi:
            hi = cuts[e + 1]
        out.append((t, lo, hi, e))
    return out


def _runs(walk):
    """(tile, row, first position, end position, piece) of every unit's
    clipped run, as tile_sum.cuh walks them."""
    row_ptr = walk.row_ptr.numpy()
    for t, c_lo, c_hi, piece in _pieces(walk):
        for row in range(TILE):
            key = t * (TILE + 1) + row
            lo = max(row_ptr[key], c_lo * EC)
            hi = min(row_ptr[key + 1], c_hi * EC)
            yield t, row, lo, hi, piece


def _walk_sum(walk, rows, data):
    """The kernel's sum in Python, float64: each unit sums its run's data
    rows into its row of the output or of its piece's part, then the parts
    are added into their tiles in order."""
    n_tiles = walk.tile_ptr.numel() - 1
    out = np.zeros((n_tiles * TILE, data.shape[1]))
    part = np.zeros((walk.split_at.numel(), TILE, data.shape[1]))
    idx = None if rows is None else rows.numpy()
    for t, row, lo, hi, piece in _runs(walk):
        pos = np.arange(lo, max(lo, hi))
        got = data[pos if idx is None else idx[pos]].sum(0)
        if piece < 0:
            out[t * TILE + row] = got
        else:
            part[piece, row] = got
    for t, _, _, piece in _pieces(walk):
        if piece >= 0:
            out[t * TILE:(t + 1) * TILE] += part[piece]
    return out


@pytest.mark.parametrize("order", ["receiver stream", "CSC stream by c_slot",
                                   "band plan receivers",
                                   "band plan senders"])
def test_walk_covers_every_live_slot_once(graphs, order):
    """Each live slot of the order is read once, by its own row's unit, and
    no dead slot is read."""
    _, gt, _, pt = graphs
    walk, rows, n_data, _ = _orders(gt, pt)[order]
    if order == "receiver stream":
        owner = gt.receivers.long()
        live = gt.r_local < TILE
    elif order == "CSC stream by c_slot":  # slot of the edge array
        owner = gt.senders.long()
        live = torch.ones(n_data, dtype=torch.bool)  # every edge, padding too
    else:
        owner = torch.from_numpy(pt.receivers if order.endswith("receivers")
                                 else pt.senders).long()
        live = pt.r_local < TILE
    hits = np.zeros(n_data, np.int64)
    for t, row, lo, hi, _ in _runs(walk):
        if lo >= hi:
            continue
        slots = np.arange(lo, hi) if rows is None else rows[lo:hi].numpy()
        np.add.at(hits, slots, 1)
        assert (owner[slots].numpy() == t * TILE + row).all()
    assert (hits[live.numpy()] == 1).all()
    assert not hits[~live.numpy()].any()


def test_band_sender_walk_leaves_out_dead_slots(graphs):
    """The plan's dead slots (which its CSC stream counts as the dummy
    sender's) are in no run of its sender walk; its runs hold the live
    slots, sorted by sender, each once."""
    _, gt, _, pt = graphs
    walk = pt.sender_walk
    dead = (pt.s_loc == pt.w * TILE).numpy()
    assert dead.sum() > 100  # the plan has dead slots to leave out
    n_read = sum(max(0, hi - lo) for *_, lo, hi, _ in _runs(walk))
    assert n_read == int((~dead).sum())
    # the dummy sender's run is empty, where the plan's CSC stream puts
    # every dead slot in it
    dummy = gt.num_nodes_padded - 1
    key = dummy // TILE * (TILE + 1) + dummy % TILE
    row_ptr = walk.row_ptr.numpy()
    assert row_ptr[key + 1] == row_ptr[key]
    assert int((pt.c_local < TILE).sum()) == pt.num_slots
    # its longest run is the largest live out-degree, not the dead slots'
    assert walk.max_run == np.bincount(pt.senders[~dead]).max()
    assert walk.to("meta").order.device.type == "meta"
    assert pt.to("meta").sender_walk.row_ptr.device.type == "meta"


def test_csc_walk_keeps_the_dummy_senders_padding_run(graphs):
    """On the graph's CSC side the dummy sender N_pad - 1 owns every
    padding slot of the receiver stream: a run the JAX kernel sums, which
    the walk keeps (past TS_SPLIT = 32 slots: the kernel cuts it into
    segments) and Graph.to carries."""
    _, gt, _, _ = graphs
    walk = gt.sender_walk
    dummy = gt.num_nodes_padded - 1
    n_padding = int((~gt.edge_mask).sum())
    key = dummy // TILE * (TILE + 1) + dummy % TILE
    row_ptr = walk.row_ptr.numpy()
    assert row_ptr[key + 1] - row_ptr[key] == n_padding > 32
    assert walk.max_run == n_padding
    assert walk.order is None  # the CSC stream is its own walk
    moved = gt.to("meta")
    assert moved.sender_walk.row_ptr.device.type == "meta"
    assert moved.stream_walk.row_ptr.device.type == "meta"


@pytest.mark.parametrize("order", ["receiver stream", "CSC stream by c_slot",
                                   "CSC stream in CSC order",
                                   "band plan receivers",
                                   "band plan senders"])
def test_walk_pieces_compute_the_plain_sums(graphs, order):
    """The sum by the walk's pieces, as the kernel forms it, equals the
    plain version in float64, dead slots carrying data."""
    _, gt, _, pt = graphs
    walk, rows, n_data, plain = _orders(gt, pt)[order]
    data = np.random.default_rng(len(order)).standard_normal(
        (n_data, L)).astype(np.float32)
    got = _walk_sum(walk, rows, data.astype(np.float64))
    want = plain(torch.from_numpy(data), f64=True).double().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PIECES_RTOL * max(
        1.0, float(np.abs(want).max())))
    if order != "band plan senders":
        assert walk.split_at.numel() > 0  # a cut tile: pieces combine


def _agree(got, want, mag):
    assert float(np.abs(want).max()) > 1.0  # the sums are not idle
    assert (np.abs(got - want) <= JAX_RTOL * mag + 1e-30).all()


def test_plain_sums_in_f64_match_the_jax_kernels(graphs):
    """``stream_scatter_plain`` (both sides) and ``banded_sender_sum_plain``
    with ``f64=True`` against the JAX package's Pallas kernels in interpret
    mode (``stream_scatter``, ``_banded_sender_sum_direct``, the function
    of row 6's TPU kernel) on the same seeded inputs, dead banded slots
    carrying data."""
    gj, gt, pj, pt = graphs
    n_pad = gt.num_nodes_padded
    rng = np.random.default_rng(8)
    data = rng.standard_normal((gt.num_edges_padded, L)).astype(np.float32)
    scatter = jax.jit(lambda d, local, chunk: jstream.stream_scatter(
        d, local, chunk, n_pad, precision="high", interpret=True))
    for local_j, chunk_j, slot_j, kw, mag_kw in (
            (gj.r_local, gj.r_chunk, None, {}, {}),
            (gj.c_local, gj.c_chunk, gj.c_slot, dict(slot=gt.c_slot),
             dict(slot=gt.c_slot))):
        local, chunk = ((gt.r_local, gt.r_chunk) if slot_j is None
                        else (gt.c_local, gt.c_chunk))
        d = jnp.asarray(data) if slot_j is None else jnp.take(
            jnp.asarray(data), slot_j, axis=0)
        want = np.asarray(scatter(d, local_j, chunk_j))
        got = tst.stream_scatter_plain(torch.from_numpy(data), local, chunk,
                                       n_pad, f64=True, **kw).numpy()
        mag = tst.stream_scatter_plain(torch.from_numpy(np.abs(data)), local,
                                       chunk, n_pad, **mag_kw).numpy()
        _agree(got, want, mag)
    data_b = rng.standard_normal((pt.num_slots, L)).astype(np.float32)
    want = np.asarray(jax.jit(lambda d: jbd._banded_sender_sum_direct(
        d, pj.bs_band, pj.bs_chunk, pj.bs_sloc, pj.w, n_pad, "high",
        True))(jnp.asarray(data_b)))
    got = tbd.banded_sender_sum_plain(torch.from_numpy(data_b), pt,
                                      f64=True).numpy()
    mag = tbd.banded_sender_sum_plain(torch.from_numpy(np.abs(data_b)),
                                      pt).numpy()
    _agree(got, want, mag)


def test_wrappers_off_the_cpu_need_a_walk(graphs, monkeypatch):
    """A tensor off the CPU goes to the kernel over a walk or raises: the
    plain version is never a fallback (a meta tensor stands in for a CUDA
    one, which the wrappers refuse as an unsupported device), and the walk
    check that a CUDA call passes refuses a missing walk or another
    graph's."""
    _, gt, _, pt = graphs

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(tst, "stream_scatter_plain", boom)
    monkeypatch.setattr(tbd, "banded_sender_sum_plain", boom)
    n_pad, e = gt.num_nodes_padded, gt.num_edges_padded
    meta = torch.zeros(e, 2, device="meta")
    for call in (
            lambda: tst.stream_scatter(meta, gt.r_local, gt.r_chunk, n_pad),
            lambda: tst.stream_segment_sum(meta, gt.receivers, gt.r_local,
                                           gt.r_chunk, n_pad),
            lambda: tst.stream_sender_segment_sum(
                meta, gt.senders, gt.c_slot, gt.c_local, gt.c_chunk, n_pad),
            lambda: tbd.banded_sender_sum(
                torch.zeros(pt.num_slots, 2, device="meta"), pt)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="needs the edge order's walk"):
        tst.stream_walk_arg("stream_scatter", None, n_pad, gt.r_chunk)
    small = tbuild_graph(np.arange(10), np.arange(10), None, 10,
                         device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tst.stream_walk_arg("stream_scatter", small.sender_walk, n_pad,
                            gt.c_chunk)
    with pytest.raises(ValueError, match="does not match"):
        tst.stream_walk_arg("stream_scatter", gt.sender_walk, n_pad,
                            gt.c_chunk.to("meta"))
    assert tst.stream_walk_arg("stream_scatter", gt.sender_walk, n_pad,
                               gt.c_chunk) is gt.sender_walk
    assert tst.stream_scatter.launches == 0
    assert tbd.banded_sender_sum.launches == 0
