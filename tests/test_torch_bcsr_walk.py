"""The walk of the BCSR attention kernel (``csrc/bcsr_attention.cu``,
kernel row 11) on the CPU: ``legacy_bcsr.tiles.BcsrWalk``, built with the
tiling by ``tile_graph``.

The kernel takes a row tile's first piece or one extra piece of a cut tile
per block and, within it, each receiver's run that ``row_ptr`` names,
clipped to the piece's chunks; position k reads the sender row ``rows[k]``
and the BCSR slot ``stream.order[k]`` (for ``drop``). A run longer than 32
positions is cut into segments of at least 8, each summed as an online
softmax state (max, denominator, sum) and merged in order into the larger
max, and a cut tile's pieces are merged the same way. These tests check
that the walk covers every valid slot once and no dead one, in receiver
runs that map back to the tiling, and that this partition and merge,
emulated in float64, give :func:`bcsr_attention_plain` in float64 (the
kernel's oracle on the card, where ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernel to it). ``tests/test_torch_bcsr.py``
holds the route against the JAX package."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data.synthetic import hub_edges
from pygat_tpu_torch.graph import build_graph
from pygat_tpu_torch.legacy_bcsr import fused_attention as bfa
from pygat_tpu_torch.legacy_bcsr import tiles as bt
from pygat_tpu_torch.legacy_bcsr.tiles import EDGE_CHUNK, TILE
from pygat_tpu_torch.ops.stream import EC

ALPHA = 0.2
SPLIT, SEG = 32, 8  # the kernel's BA_SPLIT and BA_SEG
# the emulation and the plain version both in float64, returned in float32
RTOL = 1e-6


def _empty_tile_graph():
    """Row tiles 0 and 2 take random edges, row tile 1 none."""
    rng = np.random.default_rng(4)
    r = np.concatenate([rng.integers(0, 100, 700),
                        rng.integers(256, 380, 700)])
    s = rng.integers(0, 383, 1400)
    return build_graph(s, r, None, 383, n_pad=384, device="cpu")


def _hub_graph():
    s, r, n = hub_edges()
    return build_graph(s, r, None, n, device="cpu")


_GRAPHS = {"hub": _hub_graph, "empty_tile": _empty_tile_graph}


@pytest.fixture(scope="module")
def tilings():
    return {k: bt.tile_graph(make()) for k, make in _GRAPHS.items()}


def _walk_np(tiles):
    w = tiles.walk
    st = w.stream
    return (st.row_ptr.numpy(), st.tile_ptr.numpy(), st.split_at.numpy(),
            st.order.numpy(), w.rows.numpy(), st.max_run)


def _slots(tiles):
    """Per flat BCSR slot: its receiver and sender rows, and valid."""
    rcv = (np.repeat(tiles.chunk_row.numpy(), EDGE_CHUNK) * TILE
           + tiles.recv_local.numpy().reshape(-1))
    snd = (np.repeat(tiles.chunk_col.numpy(), EDGE_CHUNK) * TILE
           + tiles.send_local.numpy().reshape(-1))
    return rcv, snd, tiles.valid.numpy().reshape(-1) > 0


@pytest.mark.parametrize("kind", list(_GRAPHS))
def test_walk_covers_each_valid_slot_once(tilings, kind):
    tiles = tilings[kind]
    row_ptr, tile_ptr, _, order, rows, _ = _walk_np(tiles)
    _, _, valid = _slots(tiles)
    n_tiles = tiles.n_tiles
    runs = np.concatenate([
        np.arange(row_ptr[t * (TILE + 1)], row_ptr[t * (TILE + 1) + TILE])
        for t in range(n_tiles)])
    assert np.array_equal(np.sort(order[runs]), np.flatnonzero(valid))
    dead = np.setdiff1d(np.arange(order.size), runs)
    assert (order[dead] == -1).all() and (rows[dead] == -1).all()
    # each tile's runs lie in its chunk range
    for t in range(n_tiles):
        k = t * (TILE + 1)
        assert tile_ptr[t] * EC <= row_ptr[k] <= row_ptr[k + TILE] \
            <= tile_ptr[t + 1] * EC


@pytest.mark.parametrize("kind", list(_GRAPHS))
def test_runs_are_receiver_sorted_and_map_back(tilings, kind):
    """Position k of row l's run in tile t stands for a valid slot of
    receiver t * 128 + l, whose sender is rows[k]; senders ascend within a
    run."""
    tiles = tilings[kind]
    row_ptr, _, _, order, rows, max_run = _walk_np(tiles)
    rcv, snd, _ = _slots(tiles)
    key = np.repeat(np.arange(tiles.n_tiles * (TILE + 1)), np.diff(row_ptr))
    live = key % (TILE + 1) < TILE
    pos = np.arange(row_ptr[-1])[live]
    want_r = key[live] // (TILE + 1) * TILE + key[live] % (TILE + 1)
    np.testing.assert_array_equal(rcv[order[pos]], want_r)
    np.testing.assert_array_equal(snd[order[pos]], rows[pos])
    same = want_r[1:] == want_r[:-1]
    assert (rows[pos][1:][same] >= rows[pos][:-1][same]).all()
    assert max_run == np.bincount(want_r).max()


def test_empty_row_tile_owns_an_empty_range(tilings):
    _, tile_ptr, _, _, _, _ = _walk_np(tilings["empty_tile"])
    assert tile_ptr[1] == tile_ptr[2] and tile_ptr[0] < tile_ptr[1]


def test_hub_tile_is_cut_into_pieces(tilings):
    """Node 700's 9,000 in-edges: its tile (5) is cut, and only it."""
    _, tile_ptr, split_at, _, _, max_run = _walk_np(tilings["hub"])
    assert split_at.size >= 8
    assert ((split_at > tile_ptr[5]) & (split_at < tile_ptr[6])).all()
    assert max_run > 9000


def test_walk_lives_with_the_tiling(tilings):
    """attach_walk rebuilds the same walk from the tensors; a tiling made
    of other tensors has none, so a CUDA call would raise."""
    tiles = tilings["empty_tile"]
    copy = bt.TiledGraph(*(t.clone() if isinstance(t, torch.Tensor) else t
                           for t in tiles))
    assert copy.walk is None
    got = bt.attach_walk(copy)
    assert copy.walk is got
    for a, b in zip(_walk_np(copy), _walk_np(tiles)):
        np.testing.assert_array_equal(a, b)


def _merge(a, b):
    """Two online softmax states (max [H], den [H], sum [H, F]) merged into
    the larger max."""
    m = np.maximum(a[0], b[0])
    with np.errstate(invalid="ignore"):
        sa = np.where(np.isneginf(a[0]), 0.0, np.exp(a[0] - m))
        sb = np.where(np.isneginf(b[0]), 0.0, np.exp(b[0] - m))
    return m, a[1] * sa + b[1] * sb, a[2] * sa[:, None] + b[2] * sb[:, None]


def _emulate(tiles, fd, fs, wh, drop):
    """(out, m, den) by the kernel's partition of the walk, in float64:
    pieces at split_at, each row's run clipped to a piece, runs longer than
    SPLIT cut into segments of SEG, each a state merged in order."""
    row_ptr, tile_ptr, split_at, order, rows, _ = _walk_np(tiles)
    h, n, f = wh.shape
    out, m, den = np.zeros((h, n, f)), np.zeros((h, n)), np.zeros((h, n))
    empty = (np.full(h, -np.inf), np.zeros(h), np.zeros((h, f)))
    for t in range(tiles.n_tiles):
        cuts = np.concatenate([[tile_ptr[t]], split_at[
            (split_at > tile_ptr[t]) & (split_at < tile_ptr[t + 1])],
            [tile_ptr[t + 1]]])
        for l in range(TILE):
            r, k = t * TILE + l, t * (TILE + 1) + l
            state = empty
            for c0, c1 in zip(cuts[:-1], cuts[1:]):
                lo = max(row_ptr[k], c0 * EC)
                hi = min(row_ptr[k + 1], c1 * EC)
                seg = SEG if hi - lo > SPLIT else max(hi - lo, 1)
                for a in range(lo, hi, seg):
                    p = np.arange(a, min(a + seg, hi))
                    pre = fd[:, r, None] + fs[:, rows[p]]  # [H, positions]
                    lg = np.where(pre >= 0, pre, ALPHA * pre)
                    mx = lg.max(1)
                    e = np.exp(lg - mx[:, None])
                    q = e if drop is None else e * drop[order[p]]
                    state = _merge(state, (mx, e.sum(1), np.einsum(
                        "hp,hpf->hf", q, wh[:, rows[p]])))
            has = state[1] > 0
            out[:, r] = np.where(has[:, None], state[2], 0.0) / np.where(
                has, state[1], 1.0)[:, None]
            m[:, r] = np.where(has, state[0], 0.0)
            den[:, r] = state[1]
    return out, m, den


@pytest.mark.parametrize("dropout", [False, True], ids=["no_drop", "drop"])
@pytest.mark.parametrize("kind", list(_GRAPHS))
def test_walk_emulation_equals_plain(tilings, kind, dropout):
    tiles = tilings[kind]
    rng = np.random.default_rng(7)
    h, n, f = 2, tiles.n_tiles * TILE, 3
    fd, fs = (rng.standard_normal((h, n)) for _ in range(2))
    wh = rng.standard_normal((h, n, f))
    drop = None
    if dropout:
        drop = np.where(rng.random(tiles.valid.numel()) < 0.6, 1 / 0.6, 0.0)
        drop *= tiles.valid.numpy().reshape(-1)
    args = [torch.from_numpy(x.astype(np.float32)) for x in (fd, fs, wh)]
    d_t = None if drop is None else torch.from_numpy(
        drop.astype(np.float32).reshape(tiles.valid.shape))
    got = _emulate(tiles, *(a.double().numpy() for a in args),
                   None if d_t is None else d_t.double().numpy().reshape(-1))
    want = bfa.bcsr_attention_plain(*args, tiles, ALPHA, d_t, f64=True)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.astype(np.float32), w.numpy(), rtol=0,
                                   atol=RTOL * scale)
    if kind == "empty_tile":
        assert not want[2][:, 128:256].any()
