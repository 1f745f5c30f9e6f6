"""The receiver stream's walk, in the form the port's tile-owner fused
kernels read it over the stream and over the corner path's windows
(``Graph.stream_walk``, ``csrc/tile_fused.cuh``), against the JAX
package's fused attention forwards in interpret mode, on a graph with a
hub whose tile the walk cuts into pieces and a tile without edges, built
with and without an explicit ``e_pad`` (static-shape bucketing, whose
trailing dead chunks the walk leaves out).

The kernels take a tile's first piece or one extra piece of a cut tile per
block and, within it, each row's run that ``row_ptr`` names, clipped to the
piece's chunks; slot k's sender is ``senders[k]`` (or row k of the window)
and its keep factors are row k of ``keepq``. These tests check on the CPU
that this partition covers every live slot once with its own receiver and
no dead one, and that the plain versions fed the slots piece by piece, in
that partition, compute the JAX package's forward."""

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
from pygat_tpu_torch.ops import fused_corner as tfc
from pygat_tpu_torch.ops import fused_stream as tfs
from pygat_tpu_torch.ops.large import plan_csc_to_csr
from pygat_tpu_torch.ops.stream import DEAD, EC, TILE, tile_ranges

ALPHA = 0.2
H, F = 4, 8
N, HUB, HUB_EDGES = 383, 50, 600
E_PAD = {"no e_pad": None, "e_pad": 4096}


def _edges():
    """Tile 0's rows 0..99 and tile 2's rows 256..379 take edges from
    anywhere, node 50 600 more; tile 1 (rows 128..255) has none."""
    rng = np.random.default_rng(21)
    r = np.concatenate([rng.integers(0, 100, 500),
                        rng.integers(256, 380, 500), np.full(HUB_EDGES, HUB)])
    s = rng.integers(0, N, r.shape[0])
    return s, r


@pytest.fixture(scope="module")
def graphs():
    """Both packages' graphs, each bucketing, with the JAX package's
    forwards of both models on one set of inputs and the port's corner
    plans."""
    s, r = _edges()
    out = {}
    for name, e_pad in E_PAD.items():
        gj = jbuild_graph(s, r, None, N, n_pad=384, e_pad=e_pad)
        gt = tbuild_graph(s, r, None, N, n_pad=384, e_pad=e_pad, device="cpu")
        ops = _operands(gt, 31)
        t = jnp.asarray
        stream = (gj.senders, gj.receivers, gj.r_local, gj.r_chunk,
                  gj.c_slot, gj.c_local, gj.c_chunk, ALPHA, "high", True)
        v1 = jax.jit(lambda *p: jfs.fused_v1_attention(*p, *stream))(
            t(ops["wh"]), t(ops["f_dst"]), t(ops["bound"]), t(ops["a"]),
            t(ops["keepq"]))
        v2 = jax.jit(lambda *p: jfs.fused_v2_attention(*p, *stream))(
            t(ops["wh"]), t(ops["whj"]), t(ops["bound"]), t(ops["a"]),
            t(ops["keepq"]))
        out[name] = dict(gt=gt, ops=ops, plans=plan_csc_to_csr(gt),
                         want={"v1": [np.asarray(x) for x in v1],
                               "v2": [np.asarray(x) for x in v2]})
    return out


def _operands(gt, seed):
    rng = np.random.default_rng(seed)
    n, e = gt.num_nodes_padded, gt.num_edges_padded
    f32 = np.float32
    f_dst = rng.standard_normal((n, H)).astype(f32)
    return dict(wh=rng.standard_normal((n, H * F)).astype(f32),
                whj=rng.standard_normal((n, H * F)).astype(f32),
                f_dst=f_dst, bound=np.abs(f_dst) + 2.0,
                a=(rng.standard_normal((H, F)) * 0.1).astype(f32),
                keepq=np.where(rng.random((e, H)) < 0.6, 1 / 0.6,
                               0).astype(f32))


def _pieces(walk):
    """(tile, first chunk, end chunk) of every block's chunk range, as
    tile_pieces.cuh's tile_range gives them."""
    tile_ptr, cuts = walk.tile_ptr.numpy(), walk.split_at.numpy()
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


def _piece_masks(walk, n_slots):
    """Per block, the stream positions its rows' clipped runs cover."""
    row_ptr = walk.row_ptr.numpy()
    masks = []
    for t, c_lo, c_hi in _pieces(walk):
        m = np.zeros(n_slots, bool)
        for row in range(TILE):
            key = t * (TILE + 1) + row
            m[max(row_ptr[key], c_lo * EC):min(row_ptr[key + 1], c_hi * EC)] = True
        masks.append(m)
    return masks


@pytest.mark.parametrize("bucket", sorted(E_PAD))
def test_stream_walk_covers_every_live_slot_once(graphs, bucket):
    gt = graphs[bucket]["gt"]
    walk = gt.stream_walk
    n_tiles = gt.num_nodes_padded // TILE
    local, chunk = gt.r_local.numpy(), gt.r_chunk.numpy()
    live = local < TILE
    assert walk.row_ptr.shape == (n_tiles * (TILE + 1) + 1,)
    hits = np.sum(_piece_masks(walk, local.shape[0]), axis=0)
    assert (hits[live] == 1).all() and not hits[~live].any()
    # each covered slot lies in its receiver's run
    row_ptr = walk.row_ptr.numpy()
    rcv = gt.receivers.numpy()
    for k in np.flatnonzero(live)[::7]:
        key = rcv[k] // TILE * (TILE + 1) + rcv[k] % TILE
        assert row_ptr[key] <= k < row_ptr[key + 1]
    # the tile ranges of the chunks up to the last live one: bucketing's
    # trailing dead chunks are left out
    n_chunks = int(np.flatnonzero(live)[-1]) // EC + 1
    tile_ptr, split_at = tile_ranges(chunk[:n_chunks], local[:n_chunks * EC],
                                     n_tiles)
    np.testing.assert_array_equal(walk.tile_ptr.numpy(), tile_ptr)
    np.testing.assert_array_equal(walk.split_at.numpy(), split_at)
    assert walk.split_at.numel() > 0  # the hub's tile is cut
    assert walk.tile_ptr[2] == walk.tile_ptr[1] + 1  # the empty tile's chunk
    if E_PAD[bucket] is not None:
        assert chunk.shape[0] > n_chunks + 8  # dead chunks past the tiles
    s, r = _edges()
    assert walk.max_run == np.bincount(r).max() >= HUB_EDGES > 32


def _by_pieces(plain, walk, r_local, args_before, args_after):
    """The sum over the walk's pieces of ``plain`` fed only the slots each
    piece covers (the others marked dead)."""
    total = None
    for m in _piece_masks(walk, r_local.shape[0]):
        local_p = torch.where(torch.from_numpy(m), r_local, DEAD).int()
        got = plain(*args_before, local_p, *args_after)
        total = got if total is None else [a + b for a, b in zip(total, got)]
    return total


def _assert_forward(got, want):
    # to 1e-5 of the largest value, as tests/test_torch_fused.py holds the
    # forward (the JAX kernels scatter two bf16 limbs, the port sums f32)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(
            g_.numpy(), w_, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(w_).max())))


@pytest.mark.parametrize("bucket", sorted(E_PAD))
@pytest.mark.parametrize("which", ["v1", "v2"])
def test_walk_pieces_compute_the_stream_forward(graphs, which, bucket):
    case = graphs[bucket]
    gt, o = case["gt"], {k: torch.from_numpy(v) for k, v in
                         case["ops"].items()}
    if which == "v1":
        got = _by_pieces(tfs.fused_v1_plain, gt.stream_walk, gt.r_local,
                         (o["wh"], o["f_dst"], o["bound"], o["a"], o["keepq"],
                          gt.senders), (gt.r_chunk, ALPHA))
    else:
        got = _by_pieces(tfs.fused_v2_plain, gt.stream_walk, gt.r_local,
                         (o["wh"], o["whj"], o["bound"], o["a"], o["keepq"],
                          gt.senders), (gt.r_chunk, ALPHA))
    _assert_forward(got, case["want"][which])
    assert float(got[1][HUB].max()) > 10.0  # the cut hub row sums many terms


@pytest.mark.parametrize("bucket", sorted(E_PAD))
@pytest.mark.parametrize("which", ["v1", "v2"])
def test_walk_pieces_compute_the_window_forward(graphs, which, bucket):
    case = graphs[bucket]
    gt, plans = case["gt"], case["plans"]
    o = {k: torch.from_numpy(v) for k, v in case["ops"].items()}
    if which == "v1":
        win = tfc.gather_corner(o["wh"], gt, plans.fwd)
        before = (win, o["f_dst"], o["bound"], o["a"], o["keepq"])
        plain = tfc.fused_v1_window_plain
    else:
        win = tfc.gather_corner(torch.cat([o["whj"], o["wh"]], 1), gt,
                                plans.fwd)
        before = (o["wh"], win, o["bound"], o["a"], o["keepq"])
        plain = tfc.fused_v2_window_plain
    got = _by_pieces(plain, gt.stream_walk, gt.r_local, before,
                     (gt.r_chunk, ALPHA))
    whole = plain(*before, gt.r_local, gt.r_chunk, ALPHA)
    _assert_forward(got, [x.numpy() for x in whole])
    _assert_forward(got, case["want"][which])
