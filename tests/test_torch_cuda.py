"""The port's CUDA kernels against their plain PyTorch versions, and the
CUDA-graph fast loop against the per-epoch loop, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one. This
file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The shapes are small and odd on purpose: widths that are not multiples of
4 or 8, more than 128 columns (several column slabs / head groups per
tile), heads of 64 to 256 features (one head per block above 128), a tile
without edges, and dead slots whose logits would overflow. The banded
kernels run on band plans with several chunks per tile, a tile without
edges, all-dead padding chunks (whose dead slots sit on the last band, one
row short of naming N_pad) and a window clipped to the table. The corner
kernels run on plans with several passes, an odd tile count, re-windowed
tiles and overflow rows (a small span cap), at ragged widths. The SpMM
kernels run on those band plans and on panel layouts with and without a
panel cap (overflow slots), with a tile without edges, and on a graph with a
hub whose tile the kernels split over several blocks, at L = 1, 2, 48, 65,
128 and 130 (widths and a table offset that break 16-byte alignment), over
node tables whose next row in memory is NaN (a row formed for a dead slot
past the table would show); two calls agree bit for bit, and every SpMM
op's backward runs card against CPU. The fused banded forwards (the
tile-owner body) run on those band plans, on the hub graph's plan (a cut
tile) and on Cora's (a grid under one wave), from H 1 F 4 to H 1 F 256;
two calls agree bit for bit there too, and a first call inside a
CUDA-graph capture, before the plan's walk is built, raises. The stream
and window fused forwards run on the same body over the graph's walk
(``Graph.stream_walk``): on the hub graph (its tile cut into pieces) and
a graph with an empty tile, from H 1 F 7 to H 1 F 256, two calls agree bit
for bit, a launch is capturable, and a CUDA call without the walk raises.
The segment sums (tile_sum.cuh) run over the receiver stream's walk, the
CSC stream's (``Graph.sender_walk``, by slot map and in CSC order) and a
band plan's two walks, on the hub graph (both sides' long runs cut into
segments, their tiles into pieces); two calls agree bit for bit, a launch
is capturable, and a CUDA call without a walk raises. The tile-owner
kernels are held to their plain versions evaluated in f64
(``f64=True``), since a hub row's 9,000-term f32 sum by index_add_ is
itself off by up to about 1e-5. The BCSR attention kernel (a walk over the
tiling's valid slots, ``TiledGraph.walk``) runs on tilings with a row tile
without edges and (I, J) pairs of several chunks, and on the hub graph (its
tile cut into pieces, the hub's run into segments), at H 8 F 8, H 1 F 7
and H 3 F 256, with and without a dropout mask, held to the plain version
in f64; two calls agree bit for bit, a launch is capturable, a CUDA call
without the walk raises, and its autograd Function runs card against CPU.
The receiver stream's kernels also run at the PPI preset's widths on a
block-diagonal batch (the fused forwards at H 4 F 256 and H 6 F 121, the
segment sums at L = 726 to 2,048), and a batch assembled from a PPI bank
on the card carries walks equal to those built from its fields.
The one-limb instantiations of the receiver stream's kernels (``precision=
"fastest"``: ``stream_scatter_bf16.cu``, ``fused_v1_bf16.cu``,
``fused_v2_bf16.cu``) run in every order and at the same odd widths,
against their plain versions under "fastest" in f64, counted apart from
the f32 kernels, capturable, and card against CPU through the autograd
Functions; those of the band plan and the corner plans
(``banded_take_bf16.cu``, ``banded_sender_sum_bf16.cu``,
``fused_v1_banded_bf16.cu``, ``fused_v2_banded_bf16.cu``,
``fused_v1_window_bf16.cu``, ``fused_v2_window_bf16.cu``) on Cora's and
the hub's band plans and on corner plans with several passes, at widths of
7 and 14 among others, against their plain versions under "fastest" in
f64, two calls bit for bit; and one Cora training step under "fastest"
over each order launches only the one-limb kernels (with expand and the
corner passes, f32 moves in both modes). chip_smoke.py covers the main
path's full-size shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from pygat_tpu_torch.data import synthetic
from pygat_tpu_torch.data.citation import CitationDataset
from pygat_tpu_torch.graph import build_graph
from pygat_tpu_torch.legacy_bcsr import fused_attention as bfa
from pygat_tpu_torch.legacy_bcsr import sparse_attention as bsa
from pygat_tpu_torch.legacy_bcsr.tiles import attach_walk, tile_graph
from pygat_tpu_torch.models.gat import GATConfig
from pygat_tpu_torch import ops
from pygat_tpu_torch.ops import banded as bd
from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops import corner as cn
from pygat_tpu_torch.ops import fused_corner as fc
from pygat_tpu_torch.ops import fused_stream as fs
from pygat_tpu_torch.ops import large
from pygat_tpu_torch.ops import panel as pn
from pygat_tpu_torch.ops import stream as st
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.train.loop import fit_transductive, fit_transductive_fast

pytestmark = pytest.mark.cuda

# f32 sums in another order (shared-memory atomics) than index_add_
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")


def _graph(device, empty_tile: bool):
    rng = np.random.default_rng(4)
    if empty_tile:
        r = np.concatenate([rng.integers(0, 100, 700),
                            rng.integers(256, 380, 700)])
        s = rng.integers(0, 383, 1400)
        return build_graph(s, r, None, 383, n_pad=384, device=device)
    n = 500
    s = np.concatenate([rng.integers(0, n, 4000), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, 4000), np.arange(n)])
    return build_graph(s, r, None, n, device=device)


def _close(got, want):
    assert torch.isfinite(got).all()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=RTOL * scale)


def _scatter_calls(g, data, data_c):
    """(kernel call, plain version in f64) of stream_scatter in each of the
    graph's orders: the receiver stream over its walk, the CSC stream by
    its slot map and in CSC order (the corner path's) over the sender
    walk."""
    n_pad = g.num_nodes_padded
    recv = (g.r_local, g.r_chunk, n_pad)
    send = (g.c_local, g.c_chunk, n_pad)
    return [
        (lambda: st.stream_scatter(data, *recv, walk=g.stream_walk),
         lambda: st.stream_scatter_plain(data, *recv, f64=True)),
        (lambda: st.stream_scatter(data, *send, slot=g.c_slot,
                                   walk=g.sender_walk),
         lambda: st.stream_scatter_plain(data, *send, slot=g.c_slot,
                                         f64=True)),
        (lambda: st.stream_scatter(data_c, *send, walk=g.sender_walk),
         lambda: st.stream_scatter_plain(data_c, *send, f64=True)),
    ]


@pytest.mark.parametrize("empty_tile", [False, True])
@pytest.mark.parametrize("width", [1, 7, 8, 64, 130, 300])
def test_stream_scatter_kernel_matches_plain(cuda, width, empty_tile):
    """The receiver and sender sides over the graph's walks, held to the
    plain version evaluated in f64."""
    g = _graph(cuda, empty_tile)
    gen = torch.Generator(device=cuda).manual_seed(width)
    data = torch.randn(g.num_edges_padded, width, generator=gen, device=cuda)
    data_c = torch.randn(g.c_local.numel(), width, generator=gen, device=cuda)
    before = st.stream_scatter.launches
    calls = _scatter_calls(g, data, data_c)
    got = [run() for run, _ in calls]
    torch.cuda.synchronize()
    assert st.stream_scatter.launches == before + 3
    for out, (_, plain) in zip(got, calls):
        _close(out, plain())
    if empty_tile:
        assert float(got[0][128:256].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["graph", "empty_tile", "hub"])
def test_stream_scatter_repeats_bit_for_bit(cuda, kind):
    """Every row is stored once by the unit that owns it, so two calls give
    the same bits (the hub graph: its receiver run cut into segments, its
    dummy sender's run too, both tiles cut into pieces)."""
    g = _hub(cuda) if kind == "hub" else _graph(cuda, kind == "empty_tile")
    if kind == "hub":
        assert g.stream_walk.max_run > 32 and g.sender_walk.max_run > 32
        assert g.stream_walk.split_at.numel() and g.sender_walk.split_at.numel()
    gen = torch.Generator(device=cuda).manual_seed(9)
    data = torch.randn(g.num_edges_padded, 64, generator=gen, device=cuda)
    data_c = torch.randn(g.c_local.numel(), 64, generator=gen, device=cuda)
    for run, plain in _scatter_calls(g, data, data_c):
        first, again = run(), run()
        assert torch.equal(first, again)
        _close(first, plain())


@pytest.mark.parametrize("width", [1, 4, 64])
def test_stream_scatter_hub_sender_side(cuda, width):
    """The hub graph's sender side: the dummy sender's run holds every
    padding slot of the receiver stream (live in the JAX kernel's sum) and
    its tile is cut into pieces; held to the f64 plain version
    elementwise, to RTOL of the same sums over |data|."""
    g = _hub(cuda)
    n_pad = g.num_nodes_padded
    dummy = n_pad - 1
    assert int((g.senders == dummy).sum()) > 32
    gen = torch.Generator(device=cuda).manual_seed(width)
    data = torch.randn(g.num_edges_padded, width, generator=gen, device=cuda)
    send = (g.c_local, g.c_chunk, n_pad)
    got = st.stream_scatter(data, *send, slot=g.c_slot, walk=g.sender_walk)
    want = st.stream_scatter_plain(data, *send, slot=g.c_slot, f64=True)
    mag = st.stream_scatter_plain(data.abs(), *send, slot=g.c_slot)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
    assert float(mag[dummy].max()) > 10.0  # the padding run is summed


def test_stream_scatter_launch_is_capturable(cuda):
    """A launch inside CUDA-graph capture, over the walks the graph built,
    replays to the plain version's result on fresh inputs."""
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(3)
    data = torch.randn(g.num_edges_padded, 8, generator=gen, device=cuda)
    data_c = torch.randn(g.c_local.numel(), 8, generator=gen, device=cuda)
    calls = _scatter_calls(g, data, data_c)
    for run, _ in calls:
        run()  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [run() for run, _ in calls]
    data.copy_(torch.randn(data.shape, generator=gen, device=cuda))
    data_c.copy_(torch.randn(data_c.shape, generator=gen, device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    for out, (_, plain) in zip(got, calls):
        _close(out, plain())


def test_segment_sums_raise_without_a_walk(cuda, monkeypatch):
    """On a CUDA tensor the segment sums launch over a walk or raise:
    without one, or with a walk of another order or device, never the
    plain version."""
    g = _graph(cuda, False)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(st, "stream_scatter_plain", boom)
    monkeypatch.setattr(bd, "banded_sender_sum_plain", boom)
    n_pad = g.num_nodes_padded
    data = torch.zeros(g.num_edges_padded, 3, device=cuda)
    other = _graph(cuda, True)
    for call in (
            lambda: st.stream_scatter(data, g.r_local, g.r_chunk, n_pad),
            lambda: st.stream_scatter(data, g.r_local, g.r_chunk, n_pad,
                                      walk=g.stream_walk.to("cpu")),
            lambda: st.stream_scatter(data, g.c_local, g.c_chunk, n_pad,
                                      slot=g.c_slot),
            lambda: st.stream_segment_sum(data, g.receivers, g.r_local,
                                          g.r_chunk, n_pad),
            lambda: st.stream_sender_segment_sum(
                data, g.senders, g.c_slot, g.c_local, g.c_chunk, n_pad,
                walk=other.sender_walk)):
        with pytest.raises(ValueError, match="walk"):
            call()
    _, plan = _band(cuda, "clustered")
    no_walk = dataclasses.replace(plan, sender_walk=None)
    with pytest.raises(ValueError, match="walk"):
        bd.banded_sender_sum(torch.zeros(plan.num_slots, 3, device=cuda),
                             no_walk)


def _fused_args(g, h, f, gen, device):
    n, e = g.num_nodes_padded, g.num_edges_padded
    wh = torch.randn(n, h * f, generator=gen, device=device) * 0.5
    a = torch.randn(h, 2 * f, generator=gen, device=device) * 0.5
    wh3 = wh.view(n, h, f)
    f_dst = torch.einsum("nho,ho->nh", wh3, a[:, :f]).contiguous()
    f_src = torch.einsum("nho,ho->nh", wh3, a[:, f:])
    m_src = torch.where(g.node_mask[:, None], f_src, float("-inf")).amax(0)
    raw = f_dst + m_src[None]
    bound = torch.where(raw >= 0, raw, 0.2 * raw).contiguous()
    keepq = torch.where(torch.rand(e, h, generator=gen, device=device) < 0.6,
                        1.0 / 0.6, 0.0)
    return [wh, f_dst, bound, a[:, f:].contiguous(), keepq, g.senders,
            g.r_local, g.r_chunk, 0.2]


@pytest.mark.parametrize("empty_tile", [False, True])
@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (3, 5), (20, 8), (2, 130),
                                 (1, 256)])
def test_fused_v1_kernel_matches_plain(cuda, h, f, empty_tile):
    g = _graph(cuda, empty_tile)
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    args = _fused_args(g, h, f, gen, cuda)
    before = fs.fused_v1.launches
    out, den = fs.fused_v1(*args, walk=g.stream_walk)
    torch.cuda.synchronize()
    assert fs.fused_v1.launches == before + 1
    out_p, den_p = fs.fused_v1_plain(*args)
    _close(out, out_p)
    _close(den, den_p)
    if empty_tile:
        assert float(out[128:256].abs().max()) == 0.0
        assert float(den[128:256].abs().max()) == 0.0


def test_fused_v1_kills_dead_slots_on_the_card(cuda):
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _fused_args(g, 2, 3, gen, cuda)
    args[0] = args[0].clone()
    args[0][-1] = 1e4  # the dummy row every dead slot points at
    out, den = fs.fused_v1(*args, walk=g.stream_walk)
    out_p, den_p = fs.fused_v1_plain(*args)
    _close(out, out_p)
    _close(den, den_p)


def test_fused_attention_gradients_card_vs_cpu(cuda):
    """The autograd Function on the card (kernel forward, kernel segment
    sums in the backward) against the same Function on the CPU."""
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = _fused_args(g, 4, 8, gen, cuda)
    g_cpu = g.to("cpu")
    grads = {}
    for dev, gg in (("cuda", g), ("cpu", g_cpu)):
        leaves = [args[i].detach().to(dev).requires_grad_() for i in (0, 1, 3)]
        out, den = fs.fused_v1_attention(
            leaves[0], leaves[1], args[2].to(dev), leaves[2], args[4].to(dev),
            gg.senders, gg.receivers, gg.r_local, gg.r_chunk, gg.c_slot,
            gg.c_local, gg.c_chunk, 0.2, gg.stream_walk, gg.sender_walk)
        (out.sin().sum() + den.cos().sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-30, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def _fused_v2_args(g, h, f, gen, device):
    n, e = g.num_nodes_padded, g.num_edges_padded
    whi = torch.randn(n, h * f, generator=gen, device=device) * 0.5
    whj = torch.randn(n, h * f, generator=gen, device=device) * 0.5
    a = torch.randn(h, f, generator=gen, device=device) * (2.0 / f) ** 0.5
    # the exact row maximum as the bound (the layer's sign-split bound grows
    # loose with F, and numerators of 1e-9 would make the comparison idle)
    rcv, snd = fs.stream_receivers(g.r_local, g.r_chunk), g.senders.long()
    logits = (fs.leaky_relu(whi[rcv] + whj[snd], 0.2).view(e, h, f) * a).sum(-1)
    logits = torch.where((g.r_local < 128)[:, None], logits, float("-inf"))
    ub = torch.full((n, h), float("-inf"), device=device).scatter_reduce(
        0, rcv[:, None].expand(e, h), logits, "amax")
    ub = torch.where(torch.isfinite(ub), ub, 0.0).contiguous()
    keepq = torch.where(torch.rand(e, h, generator=gen, device=device) < 0.6,
                        1.0 / 0.6, 0.0)
    return [whi, whj, ub, a, keepq, g.senders, g.r_local, g.r_chunk, 0.2]


@pytest.mark.parametrize("empty_tile", [False, True])
@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (8, 3), (3, 5), (20, 8),
                                 (1, 1), (2, 64), (3, 33), (2, 130), (1, 256),
                                 (2, 256)])
def test_fused_v2_kernel_matches_plain(cuda, h, f, empty_tile):
    g = _graph(cuda, empty_tile)
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    args = _fused_v2_args(g, h, f, gen, cuda)
    before = fs.fused_v2.launches
    out, den = fs.fused_v2(*args, walk=g.stream_walk)
    torch.cuda.synchronize()
    assert fs.fused_v2.launches == before + 1
    out_p, den_p = fs.fused_v2_plain(*args)
    assert float(den_p.max()) >= 1.0  # the comparison is not idle
    _close(out, out_p)
    _close(den, den_p)
    if empty_tile:
        assert float(out[128:256].abs().max()) == 0.0
        assert float(den[128:256].abs().max()) == 0.0


def test_fused_v2_kills_dead_slots_on_the_card(cuda):
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _fused_v2_args(g, 2, 3, gen, cuda)
    for i in (0, 1):  # the dummy row every dead slot points at
        args[i] = args[i].clone()
        args[i][-1] = 1e4
    out, den = fs.fused_v2(*args, walk=g.stream_walk)
    out_p, den_p = fs.fused_v2_plain(*args)
    _close(out, out_p)
    _close(den, den_p)


def test_fused_v2_rejects_too_wide_a_head(cuda):
    g = _graph(cuda, False)
    args = _fused_v2_args(g, 1, 257, torch.Generator(device=cuda), cuda)
    with pytest.raises(ValueError, match="exceeds 256"):
        fs.fused_v2(*args, walk=g.stream_walk)


def test_fused_v2_attention_gradients_card_vs_cpu(cuda):
    """The autograd Function on the card (kernel forward, kernel segment
    sums in the backward) against the same Function on the CPU."""
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = _fused_v2_args(g, 4, 8, gen, cuda)
    g_cpu = g.to("cpu")
    grads = {}
    for dev, gg in (("cuda", g), ("cpu", g_cpu)):
        leaves = [args[i].detach().to(dev).requires_grad_() for i in (0, 1, 3)]
        out, den = fs.fused_v2_attention(
            leaves[0], leaves[1], args[2].to(dev), leaves[2], args[4].to(dev),
            gg.senders, gg.receivers, gg.r_local, gg.r_chunk, gg.c_slot,
            gg.c_local, gg.c_chunk, 0.2, gg.stream_walk, gg.sender_walk)
        (out.sin().sum() + den.cos().sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-30, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("h,f", [(8, 8), (16, 8)])
def test_fused_v2_launch_is_capturable(cuda, h, f):
    """A launch inside CUDA-graph capture, with the walk the graph built,
    replays to the plain version's result on fresh inputs."""
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(2)
    args = _fused_v2_args(g, h, f, gen, cuda)
    fs.fused_v2(*args, walk=g.stream_walk)  # build and load outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, den = fs.fused_v2(*args, walk=g.stream_walk)
    fresh = _fused_v2_args(g, h, f, gen, cuda)
    for static, new in zip(args[:5], fresh[:5]):
        static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    out_p, den_p = fs.fused_v2_plain(*args)
    _close(out, out_p)
    _close(den, den_p)


def _planted(device):
    n = 200
    s, r, labels = synthetic.planted_partition_graph(n, 3, "fastfit",
                                                     avg_degree=8)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([r, np.arange(n)])
    g = build_graph(s, r, None, n, device=device)
    x = np.zeros((g.num_nodes_padded, 128), np.float32)
    x[:n, :16] = synthetic.class_features(labels, 16, "fastfit", density=0.2)
    lab = np.full(g.num_nodes_padded, -1, np.int32)
    lab[:n] = labels
    tr, va, te = (torch.arange(a, b, dtype=torch.int32, device=device)
                  for a, b in ((0, 100), (100, 150), (150, 200)))
    return CitationDataset(
        graph=g, features=torch.from_numpy(x).to(device),
        labels=torch.from_numpy(lab).to(device), idx_train=tr, idx_val=va,
        idx_test=te, num_classes=3, num_features=16, synthetic_parts=("all",))


def _quiet():
    import os

    return TrainLogger(stream=open(os.devnull, "w"))


@pytest.mark.parametrize("layer_type,fused", [("GAT_sparse", fs.fused_v1),
                                              ("GATv2_sparse", fs.fused_v2)])
def test_fit_fast_on_cuda_replays_a_graph_and_matches_classic(cuda, layer_type,
                                                              fused):
    """The fast loop on the card: one captured epoch replayed, the per-epoch
    loop's losses from the same seeds (dropout on: the graph-registered
    generator draws the masks the eager loop draws), a best model no worse.
    The wrappers count their own calls only (the eager warm-up epoch, the
    captured epoch, the test forward); what the replays launch is
    ``graph_replays`` x ``captured_launches``."""
    data = _planted(cuda)
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type=layer_type)
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=24, patience=100, seed=7,
              checkpoint_dir=None, logger=_quiet(), log_every=100)
    a = fit_transductive(cfg, data, **kw)
    before = (fused.launches, st.stream_scatter.launches)
    b = fit_transductive_fast(cfg, data, epoch_chunk=8, **kw)
    assert b.graph_replays == 24
    other = "fused_v1" if fused is fs.fused_v2 else "fused_v2"
    assert b.captured_launches[other] == 0
    assert {k: v for k, v in b.captured_launches.items() if v} == {
        "stream_scatter": 4, fused.__name__: 4}
    assert fused.launches - before[0] == 4 + 4 + 2
    assert st.stream_scatter.launches - before[1] == 4 + 4
    # atomics reorder every sum, and the capturable Adam rounds its bias
    # correction on the device
    np.testing.assert_allclose(b.history, a.history, rtol=1e-4)
    assert b.best_val_loss <= a.best_val_loss * (1 + 1e-4)
    assert b.state.step == 24 and np.isfinite(b.test_loss)


def test_fit_fast_on_cuda_fastmode(cuda):
    """--fastmode under capture: validation reads the training forward, so
    an epoch launches each layer's fused kernel once."""
    data = _planted(cuda)
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type="GATv2_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=6, patience=100, seed=3,
              checkpoint_dir=None, logger=_quiet(), fastmode=True)
    a = fit_transductive(cfg, data, **kw)
    before = fs.fused_v2.launches
    b = fit_transductive_fast(cfg, data, epoch_chunk=3, **kw)
    assert b.graph_replays == 6
    assert b.captured_launches["fused_v2"] == 2
    assert fs.fused_v2.launches - before == 2 + 2 + 2
    np.testing.assert_allclose(b.history, a.history, rtol=1e-4)


def test_fit_fast_on_cuda_resumes_exactly(cuda, tmp_path):
    data = _planted(cuda)
    cfg = GATConfig(nlayers=2, nheads=(3, 1), nfeats=(128, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type="GATv2_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, patience=100, seed=72,
              epoch_chunk=3, log_every=100, logger=_quiet(), dataset_tag="u")
    full = fit_transductive_fast(cfg, data, epochs=12,
                                 checkpoint_dir=str(tmp_path / "full"), **kw)
    part_dir = str(tmp_path / "part")
    fit_transductive_fast(cfg, data, epochs=6, checkpoint_dir=part_dir, **kw)
    res = fit_transductive_fast(cfg, data, epochs=12, checkpoint_dir=part_dir,
                                resume=True, **kw)
    assert res.graph_replays == 6
    np.testing.assert_allclose(res.history, full.history, rtol=1e-4)
    assert res.best_epoch == full.best_epoch


# In a fresh process, the first launch of each kernel at a size where the
# block-per-chunk bodies the tile-owner ones replaced had static plus
# dynamic shared memory past 48 KB and the dynamic part alone not:
# stream_scatter from L = 32, banded_sender_sum at L = 48. The opt-in to more
# than 48 KB stays set on a kernel once a larger launch set it, so only a
# first launch shows a missing one. The tile-owner bodies (tile_sum.cuh,
# tile_fused.cuh) hold under 10 KB of shared memory at any width, in their
# instantiation that cuts long runs (the segment sums' first launches here
# are the sender side's, whose dummy sender's run takes it); the fused
# forwards' first launches are where the block-per-chunk body they replaced
# passed 48 KB (fused_v1 at H 1 F 92, fused_v2 at H 1 F 90) or held about
# 130 KiB (the banded ones at H 1 F 256).
_FIRST_LAUNCHES = """
import torch
from tests.test_torch_cuda import (_banded_v1_args, _banded_v2_args, _close,
                                   _fused_args, _fused_v2_args, _graph)
from pygat_tpu_torch.ops import banded as bd, fused_stream as fs
from pygat_tpu_torch.ops import stream as st

dev = torch.device("cuda")
g = _graph(dev, False)
gen = torch.Generator(device=dev).manual_seed(0)
n_pad = g.num_nodes_padded
data = torch.randn(g.num_edges_padded, 48, generator=gen, device=dev)
assert g.sender_walk.max_run > 32
_close(st.stream_scatter(data, g.c_local, g.c_chunk, n_pad, slot=g.c_slot,
                         walk=g.sender_walk),
       st.stream_scatter_plain(data, g.c_local, g.c_chunk, n_pad,
                               slot=g.c_slot, f64=True))
_close(st.stream_scatter(data, g.r_local, g.r_chunk, n_pad,
                         walk=g.stream_walk),
       st.stream_scatter_plain(data, g.r_local, g.r_chunk, n_pad, f64=True))
plan = bd.build_band_plan(g, w=2)
data = torch.randn(plan.num_slots, 48, generator=gen, device=dev)
_close(bd.banded_sender_sum(data, plan),
       bd.banded_sender_sum_plain(data, plan, f64=True))
walk = dict(walk=g.stream_walk)
for kernel, plain, args, kw in (
        (fs.fused_v1, fs.fused_v1_plain, _fused_args(g, 1, 92, gen, dev), walk),
        (fs.fused_v2, fs.fused_v2_plain, _fused_v2_args(g, 1, 90, gen, dev),
         walk),
        (bd.fused_v1_banded, bd.fused_v1_banded_plain,
         _banded_v1_args(g, plan, 1, 256, gen, dev), {}),
        (bd.fused_v2_banded, bd.fused_v2_banded_plain,
         _banded_v2_args(g, plan, 1, 256, gen, dev), {})):
    for got, want in zip(kernel(*args, **kw), plain(*args)):
        _close(got, want)
torch.cuda.synchronize()
print("first launches ok")
"""


def test_first_launch_at_48_kb_of_shared_memory_opts_in(cuda):
    """Each kernel's first launch in a fresh process at a size whose
    static and dynamic shared memory together just pass 48 KB."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _FIRST_LAUNCHES], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "first launches ok" in run.stdout


def test_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    g = _graph(cuda, False)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(st, "stream_scatter_plain", boom)
    monkeypatch.setattr(fs, "fused_v1_plain", boom)
    monkeypatch.setattr(fs, "fused_v2_plain", boom)
    data = torch.zeros(4, g.num_edges_padded, device=cuda).T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        st.stream_scatter(data, g.r_local, g.r_chunk, g.num_nodes_padded,
                          walk=g.stream_walk)
    args = _fused_args(g, 2, 3, torch.Generator(device=cuda), cuda)
    args[0] = args[0].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_v1(*args, walk=g.stream_walk)
    args = _fused_v2_args(g, 2, 3, torch.Generator(device=cuda), cuda)
    fs.fused_v2(*args, walk=g.stream_walk)  # the kernel, never the plain
    args[1] = args[1].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_v2(*args, walk=g.stream_walk)


# -- the banded kernels --------------------------------------------------------


def _hub(device):
    """The hub graph (``data.synthetic.hub_edges``): its hub's tile owns 38
    chunks of the receiver stream and of a w = 4 band plan, well over
    HEAVY_CHUNKS, so the SpMM kernels split it."""
    s, r, n = synthetic.hub_edges()
    return build_graph(s, r, None, n, device=device)


def _cora(device):
    """The Cora stand-in's graph (``load_citation``): 22 tiles, whose band
    plan's grid is under one wave of the fused banded kernels."""
    from pygat_tpu_torch.data.citation import load_citation

    return load_citation("cora", device=device).graph


def _plan(device, kind):
    """(graph, band plan): ``clustered`` has several chunks per tile,
    ``empty_tile`` a tile without edges, ``clipped`` asks for a window wider
    than the table, ``hub`` a tile of 38 chunks, ``cora`` the Cora
    stand-in's 22 tiles, ``heavy`` 67 receivers of 40 to 65 in-edges in
    uncut tiles (runs the fused forwards cut into segments). Each plan ends in all-dead padding chunks on the
    last band, so a dead slot there would name row N_pad if formed
    first."""
    rng = np.random.default_rng(5)
    if kind == "empty_tile":
        return _graph(device, True), 2
    if kind == "hub":
        return _hub(device), 4
    if kind == "cora":
        return _cora(device), 4
    if kind == "heavy":  # 67 receivers with 35-60 more in-edges each
        n = 600
        base = np.repeat(np.arange(n), 4)
        heavy = np.repeat(np.arange(0, n, 9), rng.integers(35, 60, 67))
        s = np.clip(np.concatenate([base, heavy])
                    + rng.integers(-150, 150, base.size + heavy.size), 0,
                    n - 1)
        s = np.concatenate([s, np.arange(n)])
        r = np.concatenate([base, heavy, np.arange(n)])
        return build_graph(s, r, None, n, device=device), 3
    if kind == "clipped":
        n, deg, spread, w = 100, 3, 100, 64
    else:
        n, deg, spread, w = 600, 6, 200, 3
    base = np.repeat(np.arange(n), deg)
    s = np.clip(base + rng.integers(-spread, spread, base.shape[0]), 0, n - 1)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([base, np.arange(n)])
    return build_graph(s, r, None, n, device=device), w


def _band(device, kind):
    g, w = _plan(device, kind)
    plan = bd.build_band_plan(g, w=w)
    dead_last = (plan.band.repeat_interleave(256) == plan.n_pad // 128 - plan.w) & (
        plan.s_loc == plan.w * 128)
    assert bool(dead_last.any())  # a dead slot on the last band
    if kind == "empty_tile":
        assert bool((plan.r_chunk == 1).any())  # the empty tile has a chunk
    if kind == "clipped":
        assert plan.w == plan.n_pad // 128
    if kind == "hub":  # the SpMM kernel splits the hub's tile
        assert plan.split_at.numel() >= 2
    if kind == "heavy":  # long runs, no cut tile
        assert plan.max_run > 32 and plan.split_at.numel() == 0
    return g, plan


BAND_KINDS = ["clustered", "empty_tile", "clipped"]


@pytest.mark.parametrize("kind", BAND_KINDS)
@pytest.mark.parametrize("width", [4, 7, 10, 33, 144])
def test_gather_kernels_match_plain_bit_exact(cuda, kind, width):
    """expand (receiver side) and banded_take (sender side) copy rows: the
    kernel equals its plain version bit for bit, zeros at dead slots."""
    _, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(width)
    table = torch.randn(plan.n_pad, width, generator=gen, device=cuda)
    before = (large.expand.launches, bd.banded_take.launches)
    got_e = large.expand(table, plan.r_local, plan.r_chunk)
    got_t = bd.banded_take(table, plan)
    torch.cuda.synchronize()
    assert (large.expand.launches, bd.banded_take.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got_e, large.expand_plain(table, plan.r_local,
                                                 plan.r_chunk))
    assert torch.equal(got_t, bd.banded_take_plain(table, plan))
    dead = plan.s_loc == plan.w * 128
    assert float(got_t[dead].abs().max()) == 0.0


@pytest.mark.parametrize("kind", BAND_KINDS)
@pytest.mark.parametrize("width", [4, 7, 10, 33, 144])
def test_banded_sender_sum_kernel_matches_plain(cuda, kind, width):
    """Dead slots carry data, which must be ignored; the sums over the
    plan's sender walk agree to RTOL of the same sums over |data| with the
    plain version evaluated in f64, and a second call gives the same bits.
    The receiver side of the same data (stream_scatter over the plan's
    receiver walk) is held the same way."""
    _, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(width)
    data = torch.randn(plan.num_slots, width, generator=gen, device=cuda)
    before = bd.banded_sender_sum.launches
    got = bd.banded_sender_sum(data, plan)
    torch.cuda.synchronize()
    assert bd.banded_sender_sum.launches == before + 1
    want = bd.banded_sender_sum_plain(data, plan, f64=True)
    mag = bd.banded_sender_sum_plain(data.abs(), plan)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
    assert float(mag.max()) > 1.0  # the comparison is not idle
    assert torch.equal(got, bd.banded_sender_sum(data, plan))
    recv = (plan.r_local, plan.r_chunk, plan.n_pad)
    got_r = bd._receiver_sum(data, plan)
    want_r = st.stream_scatter_plain(data, *recv, f64=True)
    mag_r = st.stream_scatter_plain(data.abs(), *recv)
    assert bool(((got_r - want_r).abs() <= RTOL * mag_r + 1e-30).all())
    assert torch.equal(got_r, bd._receiver_sum(data, plan))


def _banded_rows(plan):
    """[E_b] int64 receiver and sender rows of the banded slots (the plan's
    host copies: dummy rows at dead slots) and the live mask."""
    dev = plan.s_loc.device
    rcv = torch.from_numpy(plan.receivers).to(dev).long()
    snd = torch.from_numpy(plan.senders).to(dev).long()
    return rcv, snd, plan.r_local < 128


def _banded_v1_args(g, plan, h, f, gen, device):
    args = _fused_args(g, h, f, gen, device)[:5]
    args[4] = torch.where(torch.rand(plan.num_slots, h, generator=gen,
                                     device=device) < 0.6, 1.0 / 0.6, 0.0)
    return args + [plan, 0.2]


def _banded_v2_args(g, plan, h, f, gen, device):
    n, e = g.num_nodes_padded, plan.num_slots
    whi = torch.randn(n, h * f, generator=gen, device=device) * 0.5
    whj = torch.randn(n, h * f, generator=gen, device=device) * 0.5
    a = torch.randn(h, f, generator=gen, device=device) * (2.0 / f) ** 0.5
    rcv, snd, live = _banded_rows(plan)
    logits = (fs.leaky_relu(whi[rcv] + whj[snd], 0.2).view(e, h, f) * a).sum(-1)
    logits = torch.where(live[:, None], logits, float("-inf"))
    ub = torch.full((n, h), float("-inf"), device=device).scatter_reduce(
        0, rcv[:, None].expand(e, h), logits, "amax")
    ub = torch.where(torch.isfinite(ub), ub, 0.0).contiguous()
    keepq = torch.where(torch.rand(e, h, generator=gen, device=device) < 0.6,
                        1.0 / 0.6, 0.0)
    return [whi, whj, ub, a, keepq, plan, 0.2]


BANDED_FUSED = [(bd.fused_v1_banded, bd.fused_v1_banded_plain, _banded_v1_args),
                (bd.fused_v2_banded, bd.fused_v2_banded_plain, _banded_v2_args)]


@pytest.mark.parametrize("kind", BAND_KINDS + ["hub", "cora", "heavy"])
@pytest.mark.parametrize("h,f", [(8, 8), (1, 4), (1, 7), (2, 5), (3, 11),
                                 (16, 8), (8, 3), (1, 256)])
@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_fused_banded_kernels_match_plain(cuda, kind, h, f, which):
    """On every plan kind, the hub's cut tile, long runs cut into segments
    and Cora's grid under one wave included, from one-lane units (H 1 F 4)
    to whole-warp heads (H 1 F 256, shuffled logits)."""
    kernel, plain, make_args = BANDED_FUSED[which]
    g, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    args = make_args(g, plan, h, f, gen, cuda)
    before = kernel.launches
    out, den = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    # the plain version in float64: the hub's rows sum 9,000 terms, whose
    # float32 sum by index_add_ moves by up to 1e-5 of the row by itself
    out_p, den_p = plain(*args, f64=True)
    assert float(den_p.max()) >= 1.0  # the comparison is not idle
    _close(out, out_p)
    _close(den, den_p)
    if kind == "empty_tile":
        assert float(out[128:256].abs().max()) == 0.0
        assert float(den[128:256].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["clustered", "hub", "cora", "heavy"])
@pytest.mark.parametrize("h,f", [(8, 8), (1, 4), (3, 11)])
@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_fused_banded_kernels_repeat_bit_for_bit(cuda, kind, h, f, which):
    """Two calls on the same inputs give the same bits: a row's run sums in
    one unit's registers in walk order, a cut tile's pieces add in order,
    and there is no atomic."""
    kernel, _, make_args = BANDED_FUSED[which]
    g, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(h + f)
    args = make_args(g, plan, h, f, gen, cuda)
    (o1, d1), (o2, d2) = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(d1, d2)
    assert float(d1.max()) >= 1.0  # the comparison is not idle


@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_fused_banded_builds_its_walk_outside_capture(cuda, which):
    """The fused banded forwards read the plan's walk, built at the first
    CUDA call on the plan: a first call inside a CUDA-graph capture raises,
    and a call after it may be captured."""
    kernel, plain, make_args = BANDED_FUSED[which]
    g, plan = _band(cuda, "clustered")
    gen = torch.Generator(device=cuda).manual_seed(8)
    args = make_args(g, plan, 8, 8, gen, cuda)
    assert "spmm_walk" not in plan.__dict__
    with pytest.raises(RuntimeError, match="must not be captured"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            kernel(*args)
    kernel(*args)
    walk = plan.spmm_walk
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, den = kernel(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert plan.spmm_walk is walk
    out_p, den_p = plain(*args)
    _close(out, out_p)
    _close(den, den_p)


@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_banded_attention_gradients_card_vs_cpu(cuda, which):
    """The banded autograd Function on the card (all five banded kernels
    and stream_scatter) against the same Function on the CPU."""
    g, plan = _band(cuda, "clustered")
    gen = torch.Generator(device=cuda).manual_seed(1)
    make_args = BANDED_FUSED[which][2]
    args = make_args(g, plan, 4, 8, gen, cuda)
    op = (bd.fused_v1_attention_banded, bd.fused_v2_attention_banded)[which]
    diff = (0, 1, 3)  # the node tables and a; the bound takes none
    grads = {}
    for dev, p in (("cuda", plan), ("cpu", plan.to("cpu"))):
        call = [t.detach().to(dev) for t in args[:5]] + [p, 0.2]
        for i in diff:
            call[i].requires_grad_()
        out, den = op(*call)
        (out.sin().sum() + den.cos().sum()).backward()
        grads[dev] = [call[i].grad.cpu() for i in diff]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-30, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def _banded_calls(g, plan, gen, device):
    """One call of each banded kernel's wrapper, with its arguments, at
    widths above 48 KB of shared memory where the kernel has it."""
    table = torch.randn(plan.n_pad, 64, generator=gen, device=device)
    data = torch.randn(plan.num_slots, 64, generator=gen, device=device)
    return [
        (large.expand, large.expand_plain, [table, plan.r_local, plan.r_chunk]),
        (bd.banded_take, bd.banded_take_plain, [table, plan]),
        (bd.banded_sender_sum, bd.banded_sender_sum_plain, [data, plan]),
        (bd.fused_v1_banded, bd.fused_v1_banded_plain,
         _banded_v1_args(g, plan, 16, 8, gen, device)),
        (bd.fused_v2_banded, bd.fused_v2_banded_plain,
         _banded_v2_args(g, plan, 16, 8, gen, device)),
    ]


@pytest.mark.parametrize("i", range(5), ids=["expand", "banded_take",
                                             "banded_sender_sum",
                                             "fused_v1_banded",
                                             "fused_v2_banded"])
def test_banded_launch_is_capturable(cuda, i):
    """One launch inside CUDA-graph capture replays to the plain version's
    result on fresh inputs."""
    g, plan = _band(cuda, "clustered")
    gen = torch.Generator(device=cuda).manual_seed(3)
    kernel, plain, args = _banded_calls(g, plan, gen, cuda)[i]
    kernel(*args)  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kernel(*args)
    fresh = _banded_calls(g, plan, gen, cuda)[i][2]
    for static, new in zip(args, fresh):
        if isinstance(static, torch.Tensor) and static.dtype == torch.float32:
            static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    want = plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(a, b)


def test_banded_wrappers_never_call_plain_on_the_card(cuda, monkeypatch):
    g, plan = _band(cuda, "empty_tile")
    gen = torch.Generator(device=cuda).manual_seed(4)
    calls = _banded_calls(g, plan, gen, cuda)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((large, "expand_plain"), (bd, "banded_take_plain"),
                      (bd, "banded_sender_sum_plain"),
                      (bd, "fused_v1_banded_plain"),
                      (bd, "fused_v2_banded_plain"),
                      (bd, "fused_v1_plain"), (bd, "fused_v2_plain")):
        monkeypatch.setattr(mod, name, boom)
    for kernel, _, args in calls:
        before = kernel.launches
        kernel(*args)
        assert kernel.launches == before + 1
    torch.cuda.synchronize()
    table = calls[1][2][0].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        bd.banded_take(table, plan)


def test_fit_fast_on_cuda_with_a_plan(cuda, monkeypatch):
    """Both trainers pick the band plan by themselves past the threshold;
    the fast loop replays an epoch of the five banded kernels and
    stream_scatter, never the stream's fused kernels, and its losses equal
    the per-epoch loop's from the same seeds."""
    data = synthetic.clustered_citation(600, 64, 3, "banded-cuda", 60,
                                        device=cuda)
    for name in ("_BAND_MODE", "_BAND_N", "_BAND_W"):
        monkeypatch.setattr(bd, name, getattr(bd, name))
    bd.set_band("auto", n=data.graph.num_nodes_padded, w=2)
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(64, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type="GAT_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=6, patience=100, seed=7,
              checkpoint_dir=None, logger=_quiet(), log_every=100)
    a = fit_transductive(cfg, data, **kw)
    before = {n: w.launches for n, w in
              (("fused_v1", fs.fused_v1), ("fused_v1_banded", bd.fused_v1_banded),
               ("banded_take", bd.banded_take))}
    b = fit_transductive_fast(cfg, data, epoch_chunk=3, **kw)
    assert b.graph_replays == 6
    want = {"fused_v1_banded": 4, "banded_take": 2, "expand": 2,
            "stream_scatter": 2, "banded_sender_sum": 2}
    assert {k: v for k, v in b.captured_launches.items() if v} == want
    # the warm-up epoch, the captured epoch and the test forward
    assert bd.fused_v1_banded.launches - before["fused_v1_banded"] == 4 + 4 + 2
    assert bd.banded_take.launches - before["banded_take"] == 2 + 2
    assert fs.fused_v1.launches == before["fused_v1"]
    np.testing.assert_allclose(b.history, a.history, rtol=1e-4)
    assert np.isfinite(b.test_loss)


# -- the corner kernels --------------------------------------------------------


def _corner(device):
    """(graph, corner plans with a span cap of 3 tiles: several passes,
    re-windowed tiles and overflow rows in both directions)."""
    g = _graph(device, False)
    plans = large.plan_csc_to_csr(g, p_cap=3)
    assert len(plans.fwd.passes) >= 3
    assert plans.fwd.overflow_total > 0 and plans.inv.overflow_total > 0
    return g, plans


@pytest.mark.parametrize("width", [4, 7, 8, 10, 14, 64, 130])
def test_permute_pass_kernel_matches_plain_bit_exact(cuda, width):
    """Every pass of a 4-pass plan of an odd tile count (63) and of a
    graph's corner plans, one by one and chained with the fix-up, equal to
    the plain versions bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(width)
    rng = np.random.default_rng(width)
    perm = cn.plan_corner_turn(rng.permutation(128 * 63), 3).to(cuda)
    assert len(perm.passes) == 4 and perm.overflow_total > 0
    _, plans = _corner(cuda)
    for plan in (perm, plans.fwd, plans.inv):
        x = torch.randn(plan.n_rows, width, generator=gen, device=cuda)
        src = x
        for cp in plan.passes:
            before = cn.permute_pass.launches
            got = cn.permute_pass(src, cp)
            torch.cuda.synchronize()
            assert cn.permute_pass.launches == before + 1
            assert got.shape == (cp.lo.shape[0] * 128, width)
            assert torch.equal(got, cn.permute_pass_plain(src, cp))
            src = got
        got = cn.corner_permute(x, plan)
        want = cn.corner_permute(x.cpu(), plan.to("cpu"))
        assert torch.equal(got.cpu(), want)
    x = torch.randn(perm.n_rows, width, generator=gen, device=cuda)
    out = cn.corner_permute(x, perm)
    dest = torch.from_numpy(np.random.default_rng(width).permutation(128 * 63))
    assert torch.equal(out.cpu()[dest], x.cpu())


def _window_args(g, plans, h, f, gen, device, which):
    """The window forward's arguments, its window built by gather_corner
    from node tables as the stream forward's test builds them."""
    if which == 0:
        wh, f_dst, bound, a_src, keepq = _fused_args(g, h, f, gen, device)[:5]
        return [fc.gather_corner(wh, g, plans.fwd), f_dst, bound, a_src, keepq,
                g.r_local, g.r_chunk, 0.2]
    whi, whj, ub, a, keepq = _fused_v2_args(g, h, f, gen, device)[:5]
    win = fc.gather_corner(torch.cat([whj, whi], 1), g, plans.fwd)
    return [whi, win, ub, a, keepq, g.r_local, g.r_chunk, 0.2]


WINDOW_FUSED = [(fc.fused_v1_window, fc.fused_v1_window_plain),
                (fc.fused_v2_window, fc.fused_v2_window_plain)]


@pytest.mark.parametrize("h,f", [(8, 8), (1, 4), (1, 7), (3, 5), (20, 8),
                                 (2, 130)])
@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_window_kernels_match_plain(cuda, h, f, which):
    kernel, plain = WINDOW_FUSED[which]
    g, plans = _corner(cuda)
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    args = _window_args(g, plans, h, f, gen, cuda, which)
    before = kernel.launches
    out, den = kernel(*args, walk=g.stream_walk)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    out_p, den_p = plain(*args)
    assert float(den_p.max()) >= 1.0  # the comparison is not idle
    _close(out, out_p)
    _close(den, den_p)


@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_corner_attention_gradients_card_vs_cpu(cuda, which):
    """The corner autograd Function on the card (permute_pass, expand, the
    window forward, stream_scatter) against the same Function on the CPU."""
    g, plans = _corner(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    make = (_fused_args, _fused_v2_args)[which]
    args = make(g, 4, 8, gen, cuda)[:5]
    op = (fc.fused_v1_attention_corner, fc.fused_v2_attention_corner)[which]
    diff = (0, 1, 3)  # the node tables and a; the bound takes none
    grads = {}
    for dev in ("cuda", "cpu"):
        call = [t.detach().to(dev) for t in args]
        for i in diff:
            call[i].requires_grad_()
        out, den = op(*call, g.to(dev), plans.to(dev), 0.2)
        (out.sin().sum() + den.cos().sum()).backward()
        grads[dev] = [call[i].grad.cpu() for i in diff]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-30, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_corner_attention_is_capturable(cuda, which):
    """Forward and backward of the corner op (passes, fix-ups, window
    forward) inside CUDA-graph capture, replayed on fresh node tables, give
    what the op gives eagerly."""
    g, plans = _corner(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    make = (_fused_args, _fused_v2_args)[which]
    op = (fc.fused_v1_attention_corner, fc.fused_v2_attention_corner)[which]
    args = [t.detach() for t in make(g, 16, 8, gen, cuda)[:5]]
    leaf = args[0].clone().requires_grad_()

    def run():
        out, den = op(leaf, *args[1:], g, plans, 0.2)
        (grad,) = torch.autograd.grad(out.sin().sum() + den.cos().sum(), leaf)
        return out.detach(), grad

    run()  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = run()
    with torch.no_grad():
        leaf.copy_(make(g, 16, 8, gen, cuda)[0])
    graph.replay()
    torch.cuda.synchronize()
    want = run()
    for a, b in zip(got, want):
        _close(a, b)


def test_corner_wrappers_never_call_plain_on_the_card(cuda, monkeypatch):
    g, plans = _corner(cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    calls = [(fc.fused_v1_window, _window_args(g, plans, 8, 8, gen, cuda, 0)),
             (fc.fused_v2_window, _window_args(g, plans, 8, 8, gen, cuda, 1))]

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((cn, "permute_pass_plain"),
                      (fc, "fused_v1_window_plain"),
                      (fc, "fused_v2_window_plain"),
                      (fc, "v1_plain_core"), (fc, "v2_plain_core")):
        monkeypatch.setattr(mod, name, boom)
    x = torch.randn(plans.fwd.n_rows, 8, generator=gen, device=cuda)
    before = cn.permute_pass.launches
    cn.corner_permute(x, plans.fwd)
    assert cn.permute_pass.launches == before + len(plans.fwd.passes)
    for kernel, args in calls:
        before = kernel.launches
        kernel(*args, walk=g.stream_walk)
        assert kernel.launches == before + 1
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="contiguous"):
        cn.permute_pass(x.T.contiguous().T, plans.fwd.passes[0])


# -- the stream and window forwards over the graph's walk ----------------------

STREAM_WINDOW = ["v1", "v2", "v1_window", "v2_window"]


def _stream_case(kind, which, h, f, gen, device):
    """(kernel, plain, args, graph) of a receiver-stream forward (``v1``,
    ``v2``) or a window forward (``v1_window``, ``v2_window``, over the
    graph's corner plans) on the graph ``kind``: ``hub`` (its hub's tile
    cut into pieces, runs past 32 slots), ``empty_tile`` or ``random``."""
    g = _hub(device) if kind == "hub" else _graph(device, kind == "empty_tile")
    i = 0 if which.startswith("v1") else 1
    if which.endswith("window"):
        kernel, plain = WINDOW_FUSED[i]
        args = _window_args(g, large.plan_csc_to_csr(g), h, f, gen, device, i)
    else:
        kernel, plain = ((fs.fused_v1, fs.fused_v1_plain),
                         (fs.fused_v2, fs.fused_v2_plain))[i]
        args = (_fused_args, _fused_v2_args)[i](g, h, f, gen, device)
    if kind == "hub":
        assert g.stream_walk.split_at.numel() >= 2
        assert g.stream_walk.max_run > 32
    return kernel, plain, args, g


@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (1, 256)])
@pytest.mark.parametrize("which", STREAM_WINDOW)
@pytest.mark.parametrize("kind", ["hub", "empty_tile"])
def test_stream_and_window_kernels_match_plain(cuda, kind, which, h, f):
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    kernel, plain, args, g = _stream_case(kind, which, h, f, gen, cuda)
    before = kernel.launches
    out, den = kernel(*args, walk=g.stream_walk)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    # the plain version in float64, as for the banded kernels
    out_p, den_p = plain(*args, f64=True)
    _close(out, out_p)
    _close(den, den_p)
    if kind == "empty_tile":
        assert float(out[128:256].abs().max()) == 0.0
        assert float(den[128:256].abs().max()) == 0.0


@pytest.mark.parametrize("h,f", [(8, 8), (1, 4), (3, 11)])
@pytest.mark.parametrize("which", STREAM_WINDOW)
@pytest.mark.parametrize("kind", ["hub", "random"])
def test_stream_and_window_kernels_repeat_bit_for_bit(cuda, kind, which, h,
                                                      f):
    gen = torch.Generator(device=cuda).manual_seed(h + f)
    kernel, _, args, g = _stream_case(kind, which, h, f, gen, cuda)
    first = kernel(*args, walk=g.stream_walk)
    again = kernel(*args, walk=g.stream_walk)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", STREAM_WINDOW)
def test_stream_and_window_launches_are_capturable(cuda, which):
    """The walk is built with the graph, before any capture: a launch inside
    CUDA-graph capture replays to the plain version's result on fresh
    inputs."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    kernel, plain, args, g = _stream_case("hub", which, 8, 8, gen, cuda)
    kernel(*args, walk=g.stream_walk)  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, den = kernel(*args, walk=g.stream_walk)
    fresh = _stream_case("hub", which, 8, 8, gen, cuda)[2]
    for static, new in zip(args[:5], fresh[:5]):
        static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    out_p, den_p = plain(*args)
    _close(out, out_p)
    _close(den, den_p)


@pytest.mark.parametrize("which", STREAM_WINDOW)
def test_stream_and_window_kernels_raise_without_a_walk(cuda, which,
                                                        monkeypatch):
    """On a CUDA tensor the wrapper launches over the graph's walk or
    raises: without one, or with another graph's, never the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    kernel, _, args, g = _stream_case("random", which, 8, 8, gen, cuda)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((fs, "fused_v1_plain"), (fs, "fused_v2_plain"),
                      (fc, "fused_v1_window_plain"),
                      (fc, "fused_v2_window_plain")):
        monkeypatch.setattr(mod, name, boom)
    before = kernel.launches
    with pytest.raises(ValueError, match="walk"):
        kernel(*args)
    with pytest.raises(ValueError, match="walk"):
        kernel(*args, walk=_graph(cuda, True).stream_walk.to("cpu"))
    assert kernel.launches == before


def test_fit_fast_on_cuda_with_corner_plans(cuda, monkeypatch):
    """Under set_corner("on") both trainers take the corner plans; the fast
    loop replays an epoch of the corner kernels (per layer: the forward's
    expand and passes and window kernel twice, the backward's two expands,
    forward and inverse passes and two stream_scatters), never a stream or
    banded fused kernel, and its losses equal the per-epoch loop's."""
    data = synthetic.clustered_citation(600, 64, 3, "corner-cuda", 60,
                                        device=cuda)
    monkeypatch.setattr(bd, "_BAND_MODE", "off")
    monkeypatch.setattr(large, "_CORNER_MODE", "on")
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(64, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type="GATv2_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=6, patience=100, seed=7,
              checkpoint_dir=None, logger=_quiet(), log_every=100)
    a = fit_transductive(cfg, data, **kw)
    before = {n: w.launches for n, w in (("fused_v2", fs.fused_v2),
                                         ("fused_v2_window", fc.fused_v2_window))}
    b = fit_transductive_fast(cfg, data, epoch_chunk=3, **kw)
    assert b.graph_replays == 6
    plans = large.plan_csc_to_csr(data.graph)
    k_f, k_i = len(plans.fwd.passes), len(plans.inv.passes)
    want = {"fused_v2_window": 4, "expand": 8, "stream_scatter": 4,
            "corner_permute": 6 * k_f + 2 * k_i}
    assert {k: v for k, v in b.captured_launches.items() if v} == want
    # the warm-up epoch, the captured epoch and the test forward
    assert fc.fused_v2_window.launches - before["fused_v2_window"] == 4 + 4 + 2
    assert fs.fused_v2.launches == before["fused_v2"]
    np.testing.assert_allclose(b.history, a.history, rtol=1e-4)
    assert np.isfinite(b.test_loss)


# -- the SpMM kernels and ops ----------------------------------------------------


def _nan_tail(rows, width, gen, device):
    """[rows, width] random f32 rows, a contiguous view whose next row in
    memory is NaN: a row formed for a dead slot past the table would show."""
    buf = torch.randn(rows + 1, width, generator=gen, device=device)
    buf[rows] = float("nan")
    return buf[:rows]


def _close_sums(got, want, mag):
    """f32 sums in another order: RTOL of the same sums over magnitudes."""
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
    assert float(mag.max()) > 1.0  # the comparison is not idle


# 2 and 130 are not multiples of 4: the kernels read such rows by scalars
SPMM_WIDTHS = [1, 2, 48, 65, 128, 130]


@pytest.mark.parametrize("kind", BAND_KINDS + ["hub"])
@pytest.mark.parametrize("width", SPMM_WIDTHS)
def test_spmm_banded_kernel_matches_plain(cuda, kind, width):
    """Values on dead slots too (ignored), dead slots on the last band; the
    hub's tile split over three blocks."""
    _, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(width)
    vals = torch.randn(plan.num_slots, generator=gen, device=cuda)
    x = _nan_tail(plan.n_pad, width, gen, cuda)
    before = bd.banded_weighted_sum.launches
    got = bd.banded_weighted_sum(vals, x, plan)
    torch.cuda.synchronize()
    assert bd.banded_weighted_sum.launches == before + 1
    _close_sums(got, bd.banded_weighted_sum_plain(vals, x, plan),
                bd.banded_weighted_sum_plain(vals.abs(), x.abs(), plan))


def _panel_layout(device, kind):
    """(graph, layout): ``clustered`` fits every slot in its tile's panels,
    ``capped`` keeps one panel per tile (most slots overflow),
    ``empty_tile`` has an output tile without edges, and ``hub`` a tile of
    38 chunks, which the kernel splits."""
    if kind == "empty_tile":
        g = _graph(device, True)
    elif kind == "hub":
        g = _hub(device)
    else:
        g, _ = _plan(device, "clustered")
    layout = pn.build_panel_layout(g, p_max=1 if kind == "capped" else None)
    assert (layout.n_overflow > 0) == (kind == "capped")
    assert (layout.split_at.numel() > 0) == (kind == "hub")
    return g, layout


PANEL_KINDS = ["clustered", "capped", "empty_tile", "hub"]


@pytest.mark.parametrize("kind", PANEL_KINDS)
@pytest.mark.parametrize("width", SPMM_WIDTHS)
def test_panel_spmm_kernel_matches_plain(cuda, kind, width):
    """Overflow and dead slots add nothing, nor do live slots whose edge
    mask is false (a fifth of them here); empty tiles give zeros; the hub's
    tile is split over three blocks."""
    g, layout = _panel_layout(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(width)
    vals = torch.randn(g.num_edges_padded, generator=gen, device=cuda)
    mask = g.edge_mask & (torch.rand(g.num_edges_padded, generator=gen,
                                     device=cuda) > 0.2)
    x = _nan_tail(g.num_nodes_padded, width, gen, cuda)
    args = (layout.panel_tiles, layout.g_idx, mask, g.r_local, g.r_chunk,
            layout.tile_ptr, layout.split_at)
    before = pn.panel_weighted_sum.launches
    got = pn.panel_weighted_sum(vals, x, *args)
    torch.cuda.synchronize()
    assert pn.panel_weighted_sum.launches == before + 1
    _close_sums(got, pn.panel_weighted_sum_plain(vals, x, *args),
                pn.panel_weighted_sum_plain(vals.abs(), x.abs(), *args))
    if kind == "empty_tile":
        assert not got[128:256].any()


def _spmm_setup(capped=False):
    """The clustered graph on the CPU, with its band plan (w = 3), a panel
    layout (one panel per tile if ``capped``) and corner plans with a span
    cap of 3 tiles (several passes, overflow rows)."""
    g, w = _plan("cpu", "clustered")
    layout = pn.build_panel_layout(g, p_max=1 if capped else None)
    return (g, bd.build_band_plan(g, w=w), layout,
            large.plan_csc_to_csr(g, p_cap=3))


SPMM_ROUTES = {
    "spmm": lambda v, x, g, p: ops.spmm(v, x, g.senders, g.receivers,
                                        g.edge_mask),
    "spmm_graph": lambda v, x, g, p: ops.spmm_graph(v, x, g),
    "panel": lambda v, x, g, p: ops.panel_spmm_graph(v, x, g, p[1],
                                                     precision="high"),
    "panel_capped": lambda v, x, g, p: ops.panel_spmm_graph(
        v, x, g, p[1], precision="high"),
    "panel_corner": lambda v, x, g, p: ops.panel_spmm_graph(
        v, x, g, p[1], plans=p[2], precision="high"),
    "corner": lambda v, x, g, p: ops.spmm_corner_graph(v, x, g, p[2]),
    "banded": lambda v, x, g, p: ops.spmm_banded(v, x, p[0],
                                                 precision="high"),
    "banded_two_pass": lambda v, x, g, p: ops.spmm_banded(
        v, x, p[0], fused=False, precision="high"),
    "sddmm_graph": lambda a, b, g, p: ops.sddmm_graph(a, b, g),
}


@pytest.mark.parametrize("route", list(SPMM_ROUTES))
def test_spmm_ops_card_vs_cpu(cuda, route):
    """Forward and both gradients of every SpMM op (and the SDDMM) on the
    card against the same op on the CPU, from one seed; the banded ops take
    their values in banded order."""
    g, plan, layout, plans = _spmm_setup(capped=route == "panel_capped")
    rng = np.random.default_rng(7)
    n_pad, width = g.num_nodes_padded, 48
    e = plan.num_slots if route.startswith("banded") else g.num_edges_padded
    first = (rng.standard_normal((n_pad, width)) if route == "sddmm_graph"
             else rng.standard_normal(e))
    x = rng.standard_normal((n_pad, width))
    ct = rng.standard_normal(e if route == "sddmm_graph" else (n_pad, width))
    if route.startswith("banded"):
        first = np.where(plan.perm >= 0, first, 0.0)  # 0 on dead slots
    results = []
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(a, dtype=torch.float32, device=dev,
                               requires_grad=True) for a in (first, x)]
        parts = (plan.to(dev), layout.to(dev), plans.to(dev))
        out = SPMM_ROUTES[route](*leaves, g.to(dev), parts)
        grads = torch.autograd.grad(out, leaves, torch.tensor(
            ct, dtype=torch.float32, device=dev))
        results.append([t.detach().cpu() for t in (out, *grads)])
    for got, want in zip(results[1], results[0]):
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        assert err <= RTOL * max(1.0, float(want.abs().max())), (route, err)


def test_spmm_routes_agree_on_the_card(cuda):
    """The panel, banded and corner routes against spmm_graph on the card,
    forward and gradients, the banded values permuted from edge order."""
    g, plan, layout, plans = (t.to(cuda) for t in _spmm_setup())
    g_cap = _spmm_setup(capped=True)[2].to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    w = torch.randn(g.num_edges_padded, generator=gen, device=cuda)
    w = torch.where(g.edge_mask, w, 0.0)
    x = torch.randn(g.num_nodes_padded, 48, generator=gen, device=cuda)
    ct = torch.randn(g.num_nodes_padded, 48, generator=gen, device=cuda)
    perm = torch.from_numpy(plan.perm).to(cuda)
    live = perm >= 0
    w_b = torch.where(live, w[perm.clamp(min=0)], 0.0)

    def run(fn, v):
        v, xx = v.clone().requires_grad_(), x.clone().requires_grad_()
        out = fn(v, xx)
        return (out.detach(), *torch.autograd.grad(out, (v, xx), ct))

    ref = run(lambda v, xx: ops.spmm_graph(v, xx, g), w)
    for name, fn, v in (
            ("panel", lambda v, xx: ops.panel_spmm_graph(
                v, xx, g, layout, precision="high"), w),
            ("panel capped", lambda v, xx: ops.panel_spmm_graph(
                v, xx, g, g_cap, precision="high"), w),
            ("panel corner", lambda v, xx: ops.panel_spmm_graph(
                v, xx, g, layout, plans=plans, precision="high"), w),
            ("corner", lambda v, xx: ops.spmm_corner_graph(v, xx, g, plans), w),
            ("banded", lambda v, xx: ops.spmm_banded(v, xx, plan,
                                                     precision="high"), w_b)):
        out, dv, dx = run(fn, v)
        if name == "banded":
            dv = torch.zeros_like(w).index_put_((perm[live],), dv[live])
        for got, want in ((out, ref[0]), (dv, ref[1] * g.edge_mask),
                          (dx, ref[2])):
            err = float((got - want).abs().max())
            assert err <= RTOL * max(1.0, float(want.abs().max())), (name, err)


def _spmm_kernel(cuda, which, gen):
    """(kernel, plain version, values, the arguments after x, graph) of the
    banded or panel SpMM kernel: over the clustered graph's band plan or
    capped panel layout, or (``*_hub``) over the hub graph's."""
    hub = which.endswith("_hub")
    if hub:
        g = _hub("cpu")
        plan, layout = bd.build_band_plan(g, w=4), pn.build_panel_layout(g)
    else:
        g, plan, layout, _ = _spmm_setup(capped=True)
    g, plan, layout = g.to(cuda), plan.to(cuda), layout.to(cuda)
    if which.startswith("banded"):
        vals = torch.randn(plan.num_slots, generator=gen, device=cuda)
        return (bd.banded_weighted_sum, bd.banded_weighted_sum_plain, vals,
                (plan,), g)
    vals = torch.randn(g.num_edges_padded, generator=gen, device=cuda)
    return (pn.panel_weighted_sum, pn.panel_weighted_sum_plain, vals,
            (layout.panel_tiles, layout.g_idx, g.edge_mask, g.r_local,
             g.r_chunk, layout.tile_ptr, layout.split_at), g)


@pytest.mark.parametrize("which", ["banded", "panel", "banded_hub",
                                   "panel_hub"])
def test_spmm_launch_is_capturable(cuda, which):
    """One launch inside CUDA-graph capture replays to the plain version's
    result on fresh inputs; with the hub, the capture holds the split tile's
    second kernel too. The hub's 9000-term row is held to RTOL of the same
    sum over magnitudes (its f32 reordering moves it by some 4e-5 of its
    value)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    kernel, plain, vals, rest, g = _spmm_kernel(cuda, which, gen)
    x = torch.randn(g.num_nodes_padded, 96, generator=gen, device=cuda)
    kernel(vals, x, *rest)  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kernel(vals, x, *rest)
    vals.copy_(torch.randn(vals.shape, generator=gen, device=cuda))
    x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    if which.endswith("_hub"):
        _close_sums(got, plain(vals, x, *rest),
                    plain(vals.abs(), x.abs(), *rest))
    else:
        _close(got, plain(vals, x, *rest))


@pytest.mark.parametrize("which", ["banded_hub", "panel_hub"])
@pytest.mark.parametrize("offset", [0, 1])
def test_spmm_kernels_repeat_bit_for_bit(cuda, which, offset):
    """Two calls on the same inputs give the same bits (each tile's rows are
    summed by one warp in slot order, the split tile's pieces added in
    order), over a table that starts 16-byte aligned (float4 loads) or one
    float past it (scalar loads), at L = 128; and both agree with the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(offset)
    kernel, plain, vals, rest, g = _spmm_kernel(cuda, which, gen)
    n_pad = g.num_nodes_padded
    buf = torch.randn(n_pad * 128 + offset, generator=gen, device=cuda)
    x = buf[offset:].view(n_pad, 128)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    a, b = kernel(vals, x, *rest), kernel(vals, x, *rest)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _close_sums(a, plain(vals, x, *rest), plain(vals.abs(), x.abs(), *rest))


def test_spmm_banded_builds_its_walk_outside_capture(cuda):
    """A band plan builds its SpMM walk at its first CUDA call, which
    refuses to run inside a CUDA-graph capture (the walk would hold values
    that only a replay computes); the walk is built once and kept."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    kernel, _, vals, (plan,), g = _spmm_kernel(cuda, "banded", gen)
    x = torch.randn(g.num_nodes_padded, 32, generator=gen, device=cuda)
    assert "spmm_walk" not in plan.__dict__
    with pytest.raises(RuntimeError, match="must not be captured"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            kernel(vals, x, plan)
    kernel(vals, x, plan)
    walk = plan.spmm_walk
    assert walk.order.device == x.device
    kernel(vals, x, plan)
    assert plan.spmm_walk is walk


def test_spmm_wrappers_never_call_plain_on_the_card(cuda, monkeypatch):
    """The SpMM ops on the card launch their kernels, forward and backward,
    and never a plain version; the launch counts per call are as stated."""
    g, plan, layout, plans = (t.to(cuda) for t in _spmm_setup())

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((bd, "banded_weighted_sum_plain"),
                      (pn, "panel_weighted_sum_plain"),
                      (bd, "banded_take_plain"), (large, "expand_plain"),
                      (bd, "banded_sender_sum_plain"),
                      (cn, "permute_pass_plain"),
                      (st, "stream_scatter_plain")):
        monkeypatch.setattr(mod, name, boom)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(g.num_nodes_padded, 48, generator=gen, device=cuda,
                    requires_grad=True)
    k_f, k_i = len(plans.fwd.passes), len(plans.inv.passes)
    for fn, e, want in (
            (lambda v: ops.spmm_banded(v, x, plan, precision="high"),
             plan.num_slots,
             {"spmm_banded": 1, "banded_take": 1, "expand": 1,
              "banded_sender_sum": 1}),
            (lambda v: ops.panel_spmm_graph(v, x, g, layout, plans=plans,
                                            precision="high"),
             g.num_edges_padded,
             {"panel_spmm": 1, "expand": 2, "corner_permute": k_f + k_i,
              "stream_scatter": 1}),
            (lambda v: ops.spmm_corner_graph(v, x, g, plans),
             g.num_edges_padded,
             {"expand": 2, "corner_permute": k_f + k_i,
              "stream_scatter": 2}),
            (lambda v: ops.spmm_graph(v, x, g), g.num_edges_padded,
             {"stream_scatter": 2})):
        v = torch.randn(e, generator=gen, device=cuda, requires_grad=True)
        before = build.launch_counts()
        torch.autograd.grad(fn(v).sum(), (v, x))
        torch.cuda.synchronize()
        after = build.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == want
    with pytest.raises(ValueError, match="contiguous"):
        bd.banded_weighted_sum(torch.zeros(plan.num_slots, device=cuda),
                               x.detach().T.contiguous().T, plan)


def _bcsr_args(g, tiles, h, f, gen, device, dropout):
    n = g.num_nodes_padded
    keep = None
    if dropout:
        keep = torch.where(torch.rand(g.num_edges_padded, generator=gen,
                                      device=device) < 0.6, 1.0 / 0.6, 0.0)
    drop = None if keep is None else (
        keep[tiles.edge_perm.long().clamp(min=0)] * tiles.valid)
    return ([torch.randn(h, n, generator=gen, device=device),
             torch.randn(h, n, generator=gen, device=device),
             torch.randn(h, n, f, generator=gen, device=device)], keep, drop)


def _bcsr_graph(device, kind):
    return _hub(device) if kind == "hub" else _graph(device,
                                                     kind == "empty_tile")


@pytest.mark.parametrize("dropout", [False, True], ids=["no_drop", "drop"])
@pytest.mark.parametrize("kind", ["graph", "empty_tile", "hub"])
@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (3, 256)])
def test_bcsr_attention_kernel_matches_plain(cuda, h, f, kind, dropout):
    """The walk kernel, one launch, against the plain version in f64: on a
    tiling with a row tile without edges, and on the hub graph (its tile
    cut into pieces, the hub's run into segments: both merges run)."""
    g = _bcsr_graph(cuda, kind)
    tiles = tile_graph(g)
    if kind == "hub":
        assert tiles.walk.stream.split_at.numel() and \
            tiles.walk.stream.max_run > 32
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    (fd, fs_, wh), _, drop = _bcsr_args(g, tiles, h, f, gen, cuda, dropout)
    before = bfa.bcsr_attention.launches
    got = bfa.bcsr_attention(fd, fs_, wh, tiles, 0.2, drop)
    torch.cuda.synchronize()
    assert bfa.bcsr_attention.launches == before + 1
    want = bfa.bcsr_attention_plain(fd, fs_, wh, tiles, 0.2, drop, f64=True)
    for a, b in zip(got, want):
        _close(a, b)
    if kind == "empty_tile":
        assert not got[0][:, 128:256].any() and not got[2][:, 128:256].any()


@pytest.mark.parametrize("kind", ["graph", "hub"])
@pytest.mark.parametrize("h,f", [(8, 8), (3, 256)])
def test_bcsr_attention_repeats_bit_for_bit(cuda, h, f, kind):
    """The walk fixes the summation order: a second call, with a dropout
    mask, gives the same bits."""
    g = _bcsr_graph(cuda, kind)
    tiles = tile_graph(g)
    gen = torch.Generator(device=cuda).manual_seed(h + f)
    (fd, fs_, wh), _, drop = _bcsr_args(g, tiles, h, f, gen, cuda, True)
    first = bfa.bcsr_attention(fd, fs_, wh, tiles, 0.2, drop)
    second = bfa.bcsr_attention(fd, fs_, wh, tiles, 0.2, drop)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bcsr_attention_without_a_walk_raises(cuda):
    """A tiling not built by tile_graph has no walk: a CUDA call raises
    (it never builds one), and runs once attach_walk has built it."""
    g = _graph(cuda, False)
    tiles = tile_graph(g)
    copy = type(tiles)(*(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in tiles))
    gen = torch.Generator(device=cuda).manual_seed(2)
    (fd, fs_, wh), _, _ = _bcsr_args(g, tiles, 2, 8, gen, cuda, False)
    before = bfa.bcsr_attention.launches
    with pytest.raises(ValueError, match="walk"):
        bfa.bcsr_attention(fd, fs_, wh, copy, 0.2)
    assert bfa.bcsr_attention.launches == before
    attach_walk(copy)
    for a, b in zip(bfa.bcsr_attention(fd, fs_, wh, copy, 0.2),
                    bfa.bcsr_attention(fd, fs_, wh, tiles, 0.2)):
        assert torch.equal(a, b)


def test_bcsr_attention_gradients_card_vs_cpu(cuda, monkeypatch):
    """gat_attention_v1's fused route on the card (one bcsr_attention
    launch forward, two stream_scatter launches backward, no plain
    version) against the same route on the CPU, with a dropout mask."""
    g = _graph(cuda, True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    args, keep, _ = _bcsr_args(g, tile_graph(g), 4, 8, gen, cuda, True)
    outs, grads = {}, {}
    for dev in ("cpu", "cuda"):
        gd = g.to(dev)
        call = [t.detach().to(dev).requires_grad_() for t in args]
        if dev == "cuda":
            def boom(*a, **k):
                raise AssertionError("plain version called for a CUDA tensor")
            monkeypatch.setattr(bfa, "bcsr_attention_plain", boom)
            monkeypatch.setattr(st, "stream_scatter_plain", boom)
            before = build.launch_counts()
        out = bsa._gat_attention_v1(*call, gd, tile_graph(gd), alpha=0.2,
                                    backend="pallas",
                                    keep_scaled=keep.to(dev))
        (out.sin().sum()).backward()
        outs[dev] = out.detach().cpu()
        grads[dev] = [t.grad.cpu() for t in call]
    torch.cuda.synchronize()
    after = build.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {"bcsr_attention": 1, "stream_scatter": 2}
    _close(outs["cuda"], outs["cpu"])
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-30, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def test_bcsr_attention_is_capturable(cuda):
    """After its first call has derived the tile offsets, the wrapper
    launches inside a CUDA graph capture (chip_smoke.py times it so)."""
    g = _graph(cuda, False)
    tiles = tile_graph(g)
    gen = torch.Generator(device=cuda).manual_seed(4)
    (fd, fs_, wh), _, _ = _bcsr_args(g, tiles, 2, 8, gen, cuda, False)
    want = bfa.bcsr_attention(fd, fs_, wh, tiles, 0.2)[0]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = bfa.bcsr_attention(fd, fs_, wh, tiles, 0.2)[0]
    graph.replay()
    torch.cuda.synchronize()
    _close(got, want)


# -- the PPI shapes: block-diagonal batches and the bank -----------------------


def _ppi_data():
    from tests.torch_ppi_data import synth_ppi
    from pygat_tpu_torch.data import ppi

    return ppi, synth_ppi(ppi.PPIGraph, ppi.PPIData, n_feat=50, n_labels=121)


def _ppi_batch(device):
    """The first train batch of the tiny PPI problem, built on the host by
    ``make_batches`` (block-diagonal, with its walks)."""
    ppi, data = _ppi_data()
    n_pad, e_pad = ppi.batch_bounds(data.train, 2)
    return next(ppi.make_batches(data.train, 2, n_pad=n_pad, e_pad=e_pad,
                                 device=device)).batch.graph


@pytest.mark.parametrize("h,f", [(4, 256), (6, 121)])
@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_fused_kernels_at_ppi_widths(cuda, which, h, f):
    """The PPI preset's heads (H 4 F 256: rows of 1,024 floats; H 6 F 121:
    columns not a multiple of 4, rows of 726 floats) on a block-diagonal
    batch, held to the f64 plain version; a second call equal bit for
    bit."""
    g = _ppi_batch(cuda)
    gen = torch.Generator(device=cuda).manual_seed(h * f)
    kernel, plain = ((fs.fused_v1, fs.fused_v1_plain),
                     (fs.fused_v2, fs.fused_v2_plain))[which]
    args = (_fused_args, _fused_v2_args)[which](g, h, f, gen, cuda)
    out, den = kernel(*args, walk=g.stream_walk)
    again = kernel(*args, walk=g.stream_walk)
    out_p, den_p = plain(*args, f64=True)
    torch.cuda.synchronize()
    _close(out, out_p)
    _close(den, den_p)
    assert torch.equal(out, again[0]) and torch.equal(den, again[1])


@pytest.mark.parametrize("width", [726, 1024, 1452, 2048])
def test_stream_scatter_at_ppi_widths(cuda, width):
    """The segment sums of the PPI backward (H F = 726 and 1,024, and
    GATv2's sender side at 2 H F): past 256 columns the slabs run along
    the grid, and 726 is not a multiple of 4 (no float4 path). Each side
    held to the f64 plain version, to RTOL of the same sums over |data|;
    a second call equal bit for bit."""
    g = _ppi_batch(cuda)
    n_pad = g.num_nodes_padded
    gen = torch.Generator(device=cuda).manual_seed(width)
    data = torch.randn(g.num_edges_padded, width, generator=gen, device=cuda)
    data = data * (g.r_local < 128)[:, None]
    for walk, args, kw in (
            (g.stream_walk, (g.r_local, g.r_chunk), {}),
            (g.sender_walk, (g.c_local, g.c_chunk), {"slot": g.c_slot})):
        got = st.stream_scatter(data, *args, n_pad, walk=walk, **kw)
        again = st.stream_scatter(data, *args, n_pad, walk=walk, **kw)
        want = st.stream_scatter_plain(data, *args, n_pad, f64=True, **kw)
        mag = st.stream_scatter_plain(data.abs(), *args, n_pad, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
        assert torch.equal(got, again)


@pytest.mark.parametrize("idx,live", [([3, 1], [True, True]),
                                      ([2, 0, 3], [True, True, False])],
                         ids=["b2", "b3_dead"])
def test_banked_batch_walks_on_the_card(cuda, idx, live):
    """A batch assembled from a bank on the card carries walks on the card
    equal to ``build_stream_walk`` of its own fields (a dead member keeps
    its walk), and the fused forward over them matches its plain
    version."""
    ppi, data = _ppi_data()
    n_pg, e_pg = ppi.bank_bounds([data.train, data.valid, data.test])
    bank = ppi.build_bank(data.train, n_pg, e_pg, device=cuda)
    _, g, _ = ppi.assemble_banked_batch(bank, idx, live)
    n_tiles = g.num_nodes_padded // 128
    for local, chunk, walk in ((g.r_local, g.r_chunk, g.stream_walk),
                               (g.c_local, g.c_chunk, g.sender_walk)):
        ref = st.build_stream_walk(local.cpu().numpy(), chunk.cpu().numpy(),
                                   n_tiles, cuda)
        assert walk.row_ptr.device.type == "cuda"
        for f in ("row_ptr", "tile_ptr", "split_at"):
            assert torch.equal(getattr(walk, f), getattr(ref, f)), f
        assert walk.max_run == ref.max_run
    gen = torch.Generator(device=cuda).manual_seed(5)
    args = _fused_args(g, 4, 256, gen, cuda)
    out, den = fs.fused_v1(*args, walk=g.stream_walk)
    out_p, den_p = fs.fused_v1_plain(*args, f64=True)
    _close(out, out_p)
    _close(den, den_p)


# ---------------------------------------------------------------------------
# The dense layers, the unfused branches and the segment impls on the card
# ---------------------------------------------------------------------------

# model on the card against the same model on the CPU (chip_smoke's
# MODEL_RTOL: sums in other orders, a softmax in between)
MODEL_RTOL = 1e-4


@pytest.mark.parametrize("width", [1, 8, 72, 732, 1028])
def test_stream_scatter_at_unfused_widths(cuda, width):
    """The unfused branches' segment sums on a block-diagonal PPI batch:
    the receiver sum of [E, H F + H] (72 at Cora's layer 1, 1,028 and 732
    at PPI's), the [E, H] receiver sum of the head-major gather's backward
    (8, and 1 on the scalar path), each a contiguous transpose of an [H, E]
    tensor as the layer hands it over, and the sender side at the same
    widths; held to the f64 plain version and equal bit for bit on a
    second call."""
    g = _ppi_batch(cuda)
    n_pad = g.num_nodes_padded
    gen = torch.Generator(device=cuda).manual_seed(width + 1)
    data = torch.randn(width, g.num_edges_padded, generator=gen,
                       device=cuda).t().contiguous()
    data = data * (g.r_local < 128)[:, None]
    for walk, args, kw in (
            (g.stream_walk, (g.r_local, g.r_chunk), {}),
            (g.sender_walk, (g.c_local, g.c_chunk), {"slot": g.c_slot})):
        got = st.stream_scatter(data, *args, n_pad, walk=walk, **kw)
        again = st.stream_scatter(data, *args, n_pad, walk=walk, **kw)
        want = st.stream_scatter_plain(data, *args, n_pad, f64=True, **kw)
        mag = st.stream_scatter_plain(data.abs(), *args, n_pad, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
        assert torch.equal(got, again)


def _model_card_vs_cpu(cfg, data, impl=None):
    """Forward and parameter gradients of ``cfg``'s model (eval) on the
    card against the CPU; returns the card run's wrapper launches."""
    from pygat_tpu_torch.models.gat import apply_gat, init_gat, parameters
    from pygat_tpu_torch.ops import segment

    results, launches = {}, None
    for dev in ("cuda", "cpu"):
        params = init_gat(cfg, torch.Generator().manual_seed(5), device=dev)
        g = data.graph.to(dev)
        before = build.launch_counts()
        with segment.use_impl(impl):
            out = apply_gat(params, cfg, data.features.to(dev), g, None,
                            train=False)
            torch.sin(out[g.node_mask]).sum().backward()
        if dev == "cuda":
            launches = {k: v - before[k]
                        for k, v in build.launch_counts().items()
                        if v != before[k]}
        results[dev] = (out.detach().cpu(),
                        [p.grad.cpu() for p in parameters(params)])
    (out_c, grads_c), (out_p, grads_p) = results["cuda"], results["cpu"]
    assert bool(torch.isfinite(out_c).all())
    torch.testing.assert_close(out_c, out_p, rtol=0, atol=MODEL_RTOL * max(
        1.0, float(out_p.abs().max())))
    _close_grads(cfg, grads_c, grads_p)
    return launches


def _close_grads(cfg, got, want):
    """Each gradient within MODEL_RTOL of its largest entry; the dense
    GATv2's ``a`` gradients, zero in exact arithmetic (its per-receiver
    logit is constant along the softmax row: the reference's [N, 1] quirk)
    and so rounding noise on either side, within MODEL_RTOL of the model's
    largest gradient of zero."""
    top = max(float(g.abs().max()) for g in want)
    per_layer = 2 + cfg.skip_connection
    for i, (a, b) in enumerate(zip(got, want)):
        if cfg.layer_type == "GATv2" and i % per_layer == 1:
            assert float(a.abs().max()) <= MODEL_RTOL * top
            assert float(b.abs().max()) <= MODEL_RTOL * top
            continue
        torch.testing.assert_close(a, b, rtol=0, atol=MODEL_RTOL * max(
            1e-30, float(b.abs().max())))


@pytest.mark.parametrize("layer_type", ["GAT", "GATv2"])
def test_dense_model_card_vs_cpu(cuda, layer_type):
    """The dense model (skip connections, 3 + 2 heads) on the card against
    the CPU; it launches none of the port's kernels."""
    cfg = GATConfig(nlayers=2, nheads=(3, 2), nfeats=(128, 8, 3),
                    dropout=0.0, alpha=0.2, layer_type=layer_type,
                    skip_connection=True)
    assert _model_card_vs_cpu(cfg, _planted(cuda)) == {}


@pytest.mark.parametrize("impl", ["stream", "scatter"])
@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_unfused_model_card_vs_cpu(cuda, layer_type, impl):
    """The sparse models through the unfused branch (fused attention off)
    on the card against the CPU: under the stream impl every segment sum
    is ``stream_scatter`` (per layer 1 forward, and backward 2 for GATv1,
    3 for GATv2); under scatter none is, and no fused kernel runs."""
    cfg = GATConfig(nlayers=2, nheads=(3, 1), nfeats=(128, 8, 3),
                    dropout=0.0, alpha=0.2, layer_type=layer_type)
    fs.set_fused_attention("off")
    try:
        launches = _model_card_vs_cpu(cfg, _planted(cuda), impl)
    finally:
        fs.set_fused_attention("auto")
    per_layer = 4 if layer_type == "GATv2_sparse" else 3
    assert launches == ({"stream_scatter": 2 * per_layer}
                        if impl == "stream" else {})


def test_backend_xla_launches_no_stream_scatter(cuda):
    """``--backend xla`` is the scatter impl: a run of the trainer under it
    takes the unfused branch with index_add_ sums, and launches no kernel
    of the port."""
    from pygat_tpu_torch.ops import segment

    data = _planted(cuda)
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3),
                    dropout=0.4, alpha=0.2, layer_type="GAT_sparse")
    before = build.launch_counts()
    with segment.use_impl("scatter"):
        res = fit_transductive(cfg, data, lr=0.01, weight_decay=5e-4,
                               epochs=3, patience=100, seed=1,
                               checkpoint_dir=None, logger=_quiet())
    assert build.launch_counts() == before
    assert np.isfinite(res.test_loss)


@pytest.mark.parametrize("remat", [False, True], ids=["batched", "remat"])
@pytest.mark.parametrize("layer_type", ["GAT", "GATv2"])
def test_dense_fast_loop_captures(cuda, layer_type, remat, monkeypatch):
    """The fast loop captures the dense epoch (the dense adjacency, the
    masks from the graph-registered generator, the softmax), the batched
    heads and the rematerialized ones (threshold 0), and replays it: the
    per-epoch loop's losses from the same seeds, dropout on."""
    from pygat_tpu_torch.models import gat

    if remat:
        monkeypatch.setattr(gat, "_DENSE_VMAP_BYTES", 0)
    data = _planted(cuda)
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3),
                    dropout=0.4, alpha=0.2, layer_type=layer_type)
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=8, patience=100, seed=7,
              checkpoint_dir=None, logger=_quiet(), log_every=100)
    a = fit_transductive(cfg, data, **kw)
    b = fit_transductive_fast(cfg, data, epoch_chunk=4, **kw)
    assert b.graph_replays == 8
    assert not any(b.captured_launches.values())
    np.testing.assert_allclose(b.history, a.history, rtol=1e-4)


@pytest.mark.parametrize("layer_type", ["GAT", "GATv2"])
def test_dense_remat_matches_batched_on_the_card(cuda, layer_type):
    """With dropout on and the same masks, the rematerialized heads give the
    batched heads' output and gradients on the card."""
    from pygat_tpu_torch.models import gat, layers

    data = _planted(cuda)
    cfg = GATConfig(nlayers=1, nheads=(4,), nfeats=(128, 8), dropout=0.5,
                    alpha=0.2, layer_type=layer_type, skip_connection=True)
    (p,) = gat.init_gat(cfg, torch.Generator().manual_seed(2), device=cuda)
    n = data.graph.num_nodes_padded
    masks = layers.draw_masks(torch.Generator(device=cuda).manual_seed(3),
                              layer_type, 0.5, n=n, f_in=128, f_out=8, e=0,
                              heads=4)
    neighborhood = data.graph.to_dense(binary=True) > 0
    results = []
    for remat in (False, True):
        out = gat.dense_heads(cfg, p, data.features, neighborhood, masks,
                              concat=True, train=True, remat=remat)
        grads = torch.autograd.grad(torch.sin(out).sum(), [t for t in p
                                                            if t is not None])
        results.append((out.detach(), grads))
    (out_b, grads_b), (out_r, grads_r) = results
    torch.testing.assert_close(out_r, out_b, rtol=0, atol=MODEL_RTOL * max(
        1.0, float(out_b.abs().max())))
    _close_grads(cfg, grads_r, grads_b)


# -- the ring (pygat_tpu_torch.parallel): the per-hop kernels on blocks ----


def _ring_blocks(device, d, drop=None):
    """The blocks of every shard of a ``d``-shard partition of 900 nodes
    over 1,024 rows (few edges a node, so a halo buffer has fewer rows than
    a shard); ``drop`` = (sender range, receiver range) empties a block."""
    from pygat_tpu_torch.parallel.partition import partition_edges, shard_blocks

    rng = np.random.default_rng(21)
    s = np.concatenate([rng.integers(0, 900, 1800), np.arange(900)])
    r = np.concatenate([rng.integers(0, 900, 1800), np.arange(900)])
    if drop is not None:
        (s0, s1), (r0, r1) = drop
        keep = ~((s >= s0) & (s < s1) & (r >= r0) & (r < r1))
        s, r = s[keep], r[keep]
    g = build_graph(s, r, None, 900, n_pad=1024, device="cpu")
    part = partition_edges(g, d)
    return part, [shard_blocks(part, k, device) for k in range(d)]


def _parts_case(cuda, blk, n_local, h, f, v2, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda) * 0.5

    e = blk.recv.shape[0]
    keep = torch.where(torch.rand(e, h, generator=gen, device=cuda) < 0.4,
                       2.5, 0.0)
    if v2:
        return (fs.fused_v2_parts, fs.fused_v2_parts_plain,
                (rnd(n_local, h * f), rnd(n_local, h) + 2.0,
                 rnd(blk.n_rows, h * f), rnd(blk.n_rows, h * f), rnd(h, f),
                 keep, blk.senders, blk.local, blk.chunk, 0.2))
    return (fs.fused_v1_parts, fs.fused_v1_parts_plain,
            (rnd(blk.n_rows, h * f), rnd(n_local, h), rnd(n_local, h) + 2.0,
             rnd(h, f), keep, blk.senders, blk.local, blk.chunk, 0.2))


@pytest.mark.parametrize("halo", [False, True], ids=["rotation", "halo"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (3, 130)])
def test_parts_kernels_match_plain_on_the_card(cuda, v2, halo, h, f):
    """The ring's per-hop forwards on a (dst 0, src 1) block, the sender
    buffer a whole shard (n_buf = n_local) or the halo buffer (n_buf <
    n_local), against their f64 plain versions; two calls bit-equal."""
    part, blocks = _ring_blocks(cuda, 2)
    blk = blocks[0].block(1, halo)
    assert (blk.n_rows < part.n_local) == halo
    kernel, plain, args = _parts_case(cuda, blk, part.n_local, h, f, v2,
                                      10 * h + f)
    out, den = kernel(*args, walk=blk.walk)
    again = kernel(*args, walk=blk.walk)
    out_p, den_p = plain(*args, f64=True)
    torch.cuda.synchronize()
    for got, want in ((out, out_p), (den, den_p)):
        torch.testing.assert_close(got, want, rtol=0, atol=RTOL * max(
            1.0, float(want.abs().max())))
    assert torch.equal(out, again[0]) and torch.equal(den, again[1])
    with pytest.raises(ValueError, match="walk"):
        kernel(*args)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_parts_kernels_on_an_empty_block(cuda, v2):
    """A block with no edge (all dead chunks, a walk without a slot): every
    row of its output is written, all zeros."""
    part, blocks = _ring_blocks(cuda, 4, ((256, 512), (512, 768)))
    blk = blocks[2].block(1)
    assert not bool(blk.mask.any()) and blk.walk.max_run == 0
    kernel, _, args = _parts_case(cuda, blk, part.n_local, 8, 8, v2, 3)
    out, den = kernel(*args, walk=blk.walk)
    torch.cuda.synchronize()
    assert out.shape == (part.n_local, 64) and not bool(out.any())
    assert not bool(den.any())


@pytest.mark.parametrize("side", ["recv", "send", "halo"])
def test_row1_over_the_ring_block_views(cuda, side):
    """stream_scatter over a block's receiver stream (n_local rows), its
    sender view and its halo view (h_rows rows) against its f64 plain
    version; two calls bit-equal."""
    part, blocks = _ring_blocks(cuda, 2)
    blk = blocks[0].block(1, side == "halo")
    gen = torch.Generator(device=cuda).manual_seed(5)
    data = torch.randn(blk.recv.shape[0], 67, generator=gen, device=cuda)
    if side == "recv":
        data = data * blk.mask[:, None]
        view = (blk.local, blk.chunk, blk.n_local, None, blk.walk)
    else:
        view = (blk.s_local, blk.s_chunk, blk.n_rows, blk.s_slot,
                blk.sender_walk)
    local, chunk, n_rows, slot, walk = view
    got = st.stream_scatter(data, local, chunk, n_rows, slot=slot, walk=walk)
    again = st.stream_scatter(data, local, chunk, n_rows, slot=slot,
                              walk=walk)
    want = st.stream_scatter_plain(data, local, chunk, n_rows, slot=slot,
                                   f64=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=RTOL * max(
        1.0, float(want.abs().max())))
    assert torch.equal(got, again)


def test_ring_at_world_size_one_matches_the_single_device(cuda, monkeypatch):
    """An NCCL group of one: ring_apply_gat over the one shard's blocks
    against apply_gat on the same graph, output and gradients."""
    import socket

    import torch.distributed as dist

    from pygat_tpu_torch.data.citation import interleave_citation
    from pygat_tpu_torch.models.gat import apply_gat, init_gat, parameters
    from pygat_tpu_torch.parallel.mesh import initialize_distributed
    from pygat_tpu_torch.parallel.partition import partition_edges, shard_blocks
    from pygat_tpu_torch.parallel.ring_model import ring_apply_gat

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    data = interleave_citation(_planted(cuda), 1)
    blocks = shard_blocks(partition_edges(data.graph, 1), 0, cuda)
    assert initialize_distributed()
    try:
        for layer_type in ("GAT_sparse", "GATv2_sparse"):
            cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3),
                            dropout=0.0, alpha=0.2, layer_type=layer_type)
            results = []
            for ring in (True, False):
                params = init_gat(cfg, torch.Generator().manual_seed(2),
                                  device=cuda)
                out = (ring_apply_gat(params, cfg, data.features, blocks,
                                      None, train=True) if ring else
                       apply_gat(params, cfg, data.features, data.graph,
                                 None, train=True))
                grads = torch.autograd.grad(
                    torch.sin(out[data.graph.node_mask]).sum(),
                    parameters(params))
                results.append((out.detach(), grads))
            (out_r, grads_r), (out_s, grads_s) = results
            torch.testing.assert_close(out_r, out_s, rtol=0, atol=MODEL_RTOL)
            _close_grads(cfg, grads_r, grads_s)
    finally:
        dist.destroy_process_group()


def test_a_refused_capture_under_a_group_runs_eagerly(cuda, monkeypatch):
    """An NCCL group of one whose fast-loop capture is refused: the chunk
    keeps the error, puts the state back and runs its epochs eagerly, to
    the metrics of a chunk whose capture held."""
    import contextlib
    import os
    import socket

    import torch.distributed as dist

    from pygat_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from pygat_tpu_torch.tools.profile_epoch import epoch_runners
    from pygat_tpu_torch.train.loop import _ring_setup

    @contextlib.contextmanager
    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")
        yield

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3),
                    dropout=0.0, alpha=0.2, layer_type="GAT_sparse")
    assert initialize_distributed()
    try:
        with open(os.devnull, "w") as quiet:
            local, ring = _ring_setup(cfg, _planted(cuda), make_mesh(1, 1),
                                      TrainLogger(stream=quiet))
        metrics = []
        for refused in (True, False):
            _, chunk = epoch_runners(cfg, local, 3, ring=ring)
            with monkeypatch.context() as m:
                if refused:
                    m.setattr(torch.cuda, "graph", refuse)
                metrics.append(chunk.run())
            if refused:
                assert chunk.capture_error == "RuntimeError: capture refused"
                assert chunk.graph_replays == 0
            else:
                assert chunk.capture_error is None
                assert chunk.graph_replays == 3
        torch.testing.assert_close(torch.tensor(metrics[0]),
                                   torch.tensor(metrics[1]), rtol=0,
                                   atol=MODEL_RTOL)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_reorder_cli_trains_on_the_card(cuda, layer_type, tmp_path):
    """``--reorder`` through the CLI on the card: Cora relabelled in RCM
    order trains two epochs by the per-epoch loop through the stream
    kernels (the fused forward of the model and both segment sums), and no
    other kernel."""
    import contextlib
    import io
    import json

    from pygat_tpu_torch.cli.train import main

    fused = "fused_v2" if layer_type == "GATv2_sparse" else "fused_v1"
    for fn in build.WRAPPERS.values():
        fn.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--dataset", "cora", "--model", layer_type, "--reorder",
                   "--epochs", "2", "--no-checkpoint", "--jsonl",
                   str(tmp_path / "m.jsonl")])
    assert rc == 0 and "start training on cuda" in out.getvalue()
    got = {k: v for k, v in build.launch_counts().items() if v}
    assert got == {fused: 2 * 2 * 2 + 2, "stream_scatter": 2 * 2 * 2}
    with open(tmp_path / "m.jsonl") as fh:
        losses = [json.loads(line)["loss_train"] for line in fh
                  if json.loads(line)["kind"] == "epoch"]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_fit_inductive_fast_card_vs_cpu(cuda, layer_type):
    """The stacked PPI loop on the card against the same loop on the CPU
    and against the per-batch loop on the card, dropout off: the
    validation history within 1e-4, the same best epoch; the card's run
    launches the fused forward and the segment sums."""
    from pygat_tpu_torch.data.ppi import PPIData, PPIGraph
    from pygat_tpu_torch.train.inductive import (
        fit_inductive,
        fit_inductive_fast,
    )
    from tests.torch_ppi_data import CFG, synth_ppi

    cfg = GATConfig(layer_type=layer_type, **CFG)
    data = synth_ppi(PPIGraph, PPIData)
    kw = dict(batch_size=2, lr=0.01, weight_decay=5e-4, epochs=4,
              patience=10, seed=3, logger=_quiet())
    before = build.launch_counts()
    card = fit_inductive_fast(cfg, data, device=cuda, **kw)
    launched = {k: v - before[k] for k, v in build.launch_counts().items()
                if v - before[k]}
    fused = "fused_v2" if layer_type == "GATv2_sparse" else "fused_v1"
    assert set(launched) == {fused, "stream_scatter"}
    cpu = fit_inductive_fast(cfg, data, device="cpu", **kw)
    per_batch = fit_inductive(cfg, data, device=cuda, log_batches=False,
                              **kw)
    for ref in (cpu, per_batch):
        np.testing.assert_allclose(card.history, ref.history, rtol=1e-4)
        assert card.best_epoch == ref.best_epoch


# -- the one-limb kernels (precision="fastest") -------------------------------

# A one-limb message rounded from an f32 value that differs in its last bit
# (another exp, another order of the logit's terms) may land on the
# neighbouring bf16 value, one bf16 step away: at most 2^-7 of the
# message. The fused forwards' out is held to that share of the same sum
# over |message| (``magnitude=True``; however many of a row's messages
# flip), plus RTOL of it for the order of the f32 sum; den and the segment
# sums, whose inputs round alike on both sides, to RTOL.
FASTEST_RTOL = 2.0 ** -7


@pytest.mark.parametrize("kind", ["graph", "empty_tile", "hub"])
@pytest.mark.parametrize("width", [1, 7, 8, 64, 130, 300])
def test_stream_scatter_bf16_kernel_matches_plain(cuda, width, kind):
    """``stream_scatter_bf16.cu`` in each of the graph's orders against the
    plain version of the same bf16-rounded data summed in f64, to RTOL of
    the same sums over |data|; counted apart from the f32 kernel; two
    calls equal bit for bit."""
    g = _hub(cuda) if kind == "hub" else _graph(cuda, kind == "empty_tile")
    gen = torch.Generator(device=cuda).manual_seed(width)
    data = torch.randn(g.num_edges_padded, width, generator=gen, device=cuda)
    data_c = torch.randn(g.c_local.numel(), width, generator=gen, device=cuda)
    n_pad = g.num_nodes_padded
    orders = [(data, (g.r_local, g.r_chunk, n_pad), {}, g.stream_walk),
              (data, (g.c_local, g.c_chunk, n_pad), dict(slot=g.c_slot),
               g.sender_walk),
              (data_c, (g.c_local, g.c_chunk, n_pad), {}, g.sender_walk)]
    before = (st.stream_scatter.launches, st.stream_scatter_bf16.launches)
    for d, lay, kw, walk in orders:
        got = st.stream_scatter(d, *lay, walk=walk, precision="fastest",
                                **kw)
        again = st.stream_scatter_bf16(d, *lay, walk=walk, **kw)
        want = st.stream_scatter_plain(d, *lay, f64=True, precision="fastest",
                                       **kw)
        mag = st.stream_scatter_plain(d.abs(), *lay, precision="fastest", **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
        high = st.stream_scatter_plain(d, *lay, f64=True, **kw)
        assert float((got - high).abs().max()) > 1e-5 * float(mag.max())
    assert (st.stream_scatter.launches,
            st.stream_scatter_bf16.launches) == (before[0], before[1] + 6)


def _bf16_cases(g, which, h, f, gen, device):
    """(kernel, bf16 wrapper, plain, args) of a one-limb stream forward:
    row 2 or 3 on the graph, or its ring-hop form over a sender table of
    other rows (the graph's table with one row more)."""
    if which.startswith("v1"):
        args = _fused_args(g, h, f, gen, device)
        if which == "v1":
            return fs.fused_v1, fs.fused_v1_bf16, fs.fused_v1_plain, args
        wh, f_dst, bound, a_src, *tail = args
        w_buf = torch.cat([wh, wh[:1]])
        return (fs.fused_v1_parts, fs.fused_v1_parts_bf16,
                fs.fused_v1_parts_plain, [w_buf, f_dst, bound, a_src, *tail])
    args = _fused_v2_args(g, h, f, gen, device)
    if which == "v2":
        return fs.fused_v2, fs.fused_v2_bf16, fs.fused_v2_plain, args
    whi, whj, ub, a, *tail = args
    return (fs.fused_v2_parts, fs.fused_v2_parts_bf16, fs.fused_v2_parts_plain,
            [whi, ub, torch.cat([whi, whi[:1]]), torch.cat([whj, whj[:1]]),
             a, *tail])


@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (3, 5), (2, 130), (1, 256)])
@pytest.mark.parametrize("which", ["v1", "v2", "v1_parts", "v2_parts"])
@pytest.mark.parametrize("kind", ["hub", "empty_tile"])
def test_fused_bf16_kernels_match_plain(cuda, kind, which, h, f):
    """``fused_v1_bf16.cu`` / ``fused_v2_bf16.cu`` (through the stream
    forwards and the ring's hop forms) against their plain versions under
    'fastest' in f64: out to FASTEST_RTOL of the same sum over |message|,
    den to RTOL; each launch counted on its one-limb wrapper only; two
    calls equal bit for bit; apart from the f32 kernel's result."""
    g = _hub(cuda) if kind == "hub" else _graph(cuda, True)
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    kernel, bf16, plain, args = _bf16_cases(g, which, h, f, gen, cuda)
    counts = (kernel.launches, bf16.launches)
    out, den = kernel(*args, walk=g.stream_walk, precision="fastest")
    again = bf16(*args, walk=g.stream_walk)
    torch.cuda.synchronize()
    assert (kernel.launches, bf16.launches) == (counts[0], counts[1] + 2)
    assert torch.equal(out, again[0]) and torch.equal(den, again[1])
    out_p, den_p = plain(*args, f64=True, precision="fastest")
    mag, _ = plain(*args, f64=True, precision="fastest", magnitude=True)
    assert torch.isfinite(out).all()
    allowed = (FASTEST_RTOL + RTOL) * mag + 1e-30
    assert bool(((out - out_p).abs() <= allowed).all())
    _close(den, den_p)
    out_h, _ = kernel(*args, walk=g.stream_walk)
    assert float((out - out_h).abs().max()) > 1e-5 * float(mag.max())
    if kind == "empty_tile":
        assert float(out[128:256].abs().max()) == 0.0


@pytest.mark.parametrize("which", ["v1", "v2"])
def test_fused_bf16_launch_is_capturable(cuda, which):
    """A one-limb launch inside CUDA-graph capture (the table's bf16 cast
    captured with it) replays to the plain version's result on fresh
    inputs."""
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(4)
    kernel, _, plain, args = _bf16_cases(g, which, 8, 8, gen, cuda)
    kernel(*args, walk=g.stream_walk, precision="fastest")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, den = kernel(*args, walk=g.stream_walk, precision="fastest")
    args[0].copy_(torch.randn(args[0].shape, generator=gen, device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    out_p, den_p = plain(*args, f64=True, precision="fastest")
    mag, _ = plain(*args, f64=True, precision="fastest", magnitude=True)
    allowed = (FASTEST_RTOL + RTOL) * mag + 1e-30
    assert bool(((out - out_p).abs() <= allowed).all())
    _close(den, den_p)


@pytest.mark.parametrize("which", ["v1", "v2"])
def test_fused_bf16_attention_gradients_card_vs_cpu(cuda, which):
    """The autograd Functions under 'fastest' on the card (one-limb
    forward, one-limb segment sums in the backward) against the same
    Functions on the CPU: out to FASTEST_RTOL of its scale, the gradients
    to FASTEST_RTOL of theirs."""
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(6)
    _, _, _, args = _bf16_cases(g, which, 4, 8, gen, cuda)
    gc = torch.Generator(device=cuda).manual_seed(7)
    g_out = torch.randn(g.num_nodes_padded, 32, generator=gc, device=cuda)
    g_den = torch.randn(g.num_nodes_padded, 4, generator=gc, device=cuda)
    op = fs.fused_v1_attention if which == "v1" else fs.fused_v2_attention
    res = {}
    for dev in ("cuda", "cpu"):
        gd = g.to(dev)
        x0, x1, shift, x3, keepq = (t.to(dev) for t in args[:5])
        leaves = [t.clone().requires_grad_() for t in (x0, x1, x3)]
        before = build.launch_counts()
        out, den = op(leaves[0], leaves[1], shift, leaves[2], keepq,
                      gd.senders, gd.receivers, gd.r_local, gd.r_chunk,
                      gd.c_slot, gd.c_local, gd.c_chunk, 0.2,
                      gd.stream_walk, gd.sender_walk, precision="fastest")
        grads = torch.autograd.grad((out, den), leaves,
                                    (g_out.to(dev), g_den.to(dev)))
        if dev == "cuda":
            launched = {k: v - before[k]
                        for k, v in build.launch_counts().items()
                        if v - before[k]}
            assert launched == {f"fused_{which}_bf16": 1,
                                "stream_scatter_bf16": 2}
        res[dev] = [t.detach().cpu() for t in (out, den, *grads)]
    for got, want in zip(res["cuda"], res["cpu"]):
        scale = max(1e-30, float(want.abs().max()))
        assert float((got - want).abs().max()) <= FASTEST_RTOL * scale


def test_bf16_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    """Under 'fastest' on a CUDA tensor the wrappers launch the one-limb
    kernels or raise: never the plain version, never the f32 kernel."""
    g = _graph(cuda, False)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for mod, name in ((st, "stream_scatter_plain"), (fs, "fused_v1_plain"),
                      (fs, "fused_v2_plain"), (fs, "fused_v1_parts_plain"),
                      (fs, "fused_v2_parts_plain")):
        monkeypatch.setattr(mod, name, boom)
    n_pad = g.num_nodes_padded
    data = torch.zeros(g.num_edges_padded, 3, device=cuda)
    with pytest.raises(ValueError, match="walk"):
        st.stream_scatter(data, g.r_local, g.r_chunk, n_pad,
                          precision="fastest")
    gen = torch.Generator(device=cuda).manual_seed(1)
    before = build.launch_counts()
    for which in ("v1", "v2", "v1_parts", "v2_parts"):
        kernel, _, _, args = _bf16_cases(g, which, 2, 3, gen, cuda)
        kernel(*args, walk=g.stream_walk, precision="fastest")
        with pytest.raises(ValueError, match="walk"):
            kernel(*args, precision="fastest")
    st.stream_scatter(data, g.r_local, g.r_chunk, n_pad, walk=g.stream_walk,
                      precision="fastest")
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in build.launch_counts().items()
                if v - before[k]}
    assert launched == {"fused_v1_bf16": 1, "fused_v2_bf16": 1,
                        "fused_v1_parts_bf16": 1, "fused_v2_parts_bf16": 1,
                        "stream_scatter_bf16": 1}


# -- the one-limb kernels over a band plan and the corner plans ---------------


@pytest.mark.parametrize("width", [4, 7, 14, 64])
@pytest.mark.parametrize("kind", ["cora", "hub"])
def test_banded_bf16_kernels_match_plain(cuda, kind, width):
    """``banded_take_bf16.cu`` equal to its plain version under 'fastest'
    (the table's rows rounded to bf16, zeros at dead slots), and
    ``banded_sender_sum_bf16.cu`` against the plain version of the same
    rounded data summed in f64, to RTOL of the same sums over |data|, on
    Cora's band plan and the hub's (its tile cut into pieces, its long run
    into segments); each counted apart from the f32 kernel; two calls equal
    bit for bit."""
    g, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(width)
    table = torch.randn(plan.n_pad, width, generator=gen, device=cuda)
    data = torch.randn(plan.num_slots, width, generator=gen, device=cuda)
    before = build.launch_counts()
    got_t = bd.banded_take(table, plan, precision="fastest")
    again_t = bd.banded_take_bf16(table, plan)
    got_s = bd.banded_sender_sum(data, plan, precision="fastest")
    again_s = bd.banded_sender_sum_bf16(data, plan)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in build.launch_counts().items()
                if v - before[k]}
    assert launched == {"banded_take_bf16": 2, "banded_sender_sum_bf16": 2}
    assert got_t.dtype == torch.bfloat16
    assert torch.equal(got_t, again_t) and torch.equal(got_s, again_s)
    assert torch.equal(got_t, bd.banded_take_plain(table, plan,
                                                   precision="fastest"))
    want = bd.banded_sender_sum_plain(data, plan, f64=True,
                                      precision="fastest")
    mag = bd.banded_sender_sum_plain(data.abs(), plan, precision="fastest")
    assert torch.isfinite(got_s).all()
    assert bool(((got_s - want).abs() <= RTOL * mag + 1e-30).all())
    high = bd.banded_sender_sum_plain(data, plan, f64=True)
    assert float((got_s - high).abs().max()) > 1e-5 * float(mag.max())


def _bf16_forward_cases(kind, which, h, f, gen, device):
    """(kernel, bf16 wrapper, plain, args, call keywords) of a one-limb
    banded forward on ``kind``'s band plan, or of a one-limb window forward
    over the corner plans (``kind`` 'corner')."""
    if kind == "corner":
        g, plans = _corner(device)
        args = _window_args(g, plans, h, f, gen, device, which)
        kernel, plain = WINDOW_FUSED[which]
        bf16 = (fc.fused_v1_window_bf16 if which == 0
                else fc.fused_v2_window_bf16)
        return kernel, bf16, plain, args, dict(walk=g.stream_walk)
    g, plan = _band(device, kind)
    kernel, plain, make_args = BANDED_FUSED[which]
    bf16 = bd.fused_v1_banded_bf16 if which == 0 else bd.fused_v2_banded_bf16
    return kernel, bf16, plain, make_args(g, plan, h, f, gen, device), {}


@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (2, 7), (1, 256)])
@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
@pytest.mark.parametrize("kind", ["cora", "hub", "corner"])
def test_fused_banded_and_window_bf16_kernels_match_plain(cuda, kind, which,
                                                          h, f):
    """``fused_v1_banded_bf16.cu`` / ``fused_v2_banded_bf16.cu`` on Cora's
    and the hub's band plans, and ``fused_v1_window_bf16.cu`` /
    ``fused_v2_window_bf16.cu`` over corner plans with several passes,
    against their plain versions under 'fastest' in f64: out to
    FASTEST_RTOL of the same sum over |message|, den to RTOL; each launch
    counted on its one-limb wrapper only; two calls equal bit for bit;
    apart from the f32 kernel's result."""
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    kernel, bf16, plain, args, kw = _bf16_forward_cases(kind, which, h, f,
                                                        gen, cuda)
    counts = (kernel.launches, bf16.launches)
    out, den = kernel(*args, precision="fastest", **kw)
    again = bf16(*args, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, bf16.launches) == (counts[0], counts[1] + 2)
    assert torch.equal(out, again[0]) and torch.equal(den, again[1])
    out_p, den_p = plain(*args, f64=True, precision="fastest")
    mag, _ = plain(*args, f64=True, precision="fastest", magnitude=True)
    assert torch.isfinite(out).all()
    assert float(den_p.max()) >= 1.0  # the comparison is not idle
    allowed = (FASTEST_RTOL + RTOL) * mag + 1e-30
    assert bool(((out - out_p).abs() <= allowed).all())
    _close(den, den_p)
    out_h, _ = kernel(*args, **kw)
    assert float((out - out_h).abs().max()) > 1e-5 * float(mag.max())


@pytest.mark.parametrize("over", ["band plan", "corner plans"])
@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_fastest_training_step_over_each_order(cuda, layer_type, over,
                                               monkeypatch):
    """One Adam step of the Cora preset under the 'fastest' module default
    over Cora's band plan or its corner plans launches only the one-limb
    kernels of its order (and the f32 moves of both modes: expand and the
    corner passes), as many as the f32 ones under 'high'; its loss is
    finite and within FASTEST_RTOL of the CPU's step."""
    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.gat import init_gat
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops import segment as sg
    from pygat_tpu_torch.train.loop import make_transductive_steps
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

    data = load_citation("cora", device=cuda)
    plan = (bd.build_band_plan(data.graph, w=4) if over == "band plan"
            else large.plan_csc_to_csr(data.graph))
    cfg = GATConfig(layer_type=layer_type, **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(int(data.features.shape[1]),) + cfg.nfeats[1:],
                       dropout=0.0)
    v = "v2" if layer_type == "GATv2_sparse" else "v1"
    if over == "band plan":
        want = {f"fused_{v}_banded_bf16": 2, "banded_take_bf16": 2,
                "expand": 2, "stream_scatter_bf16": 2,
                "banded_sender_sum_bf16": 2}
    else:
        k_f, k_i = len(plan.fwd.passes), len(plan.inv.passes)
        want = {f"fused_{v}_window_bf16": 2, "expand": 6,
                "corner_permute": 2 * (2 * k_f + k_i),
                "stream_scatter_bf16": 4}
    monkeypatch.setattr(sg, "_STREAM_PRECISION", "fastest")
    losses = {}
    for dev in ("cuda", "cpu"):
        params = init_gat(cfg, make_generator("cpu", 72), device=dev)
        state = init_state(params, make_optimizer(params, 0.005, 5e-4),
                           make_generator(dev, 73))
        train_step, _ = make_transductive_steps(cfg, plan.to(dev))
        before = build.launch_counts()
        _, loss, _, _ = train_step(state, data.features.to(dev),
                                   data.graph.to(dev), data.labels.to(dev),
                                   data.idx_train.to(dev))
        losses[dev] = float(loss)
        if dev == "cuda":
            torch.cuda.synchronize()
            launched = {k: n - before[k]
                        for k, n in build.launch_counts().items()
                        if n - before[k]}
            assert launched == want
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= FASTEST_RTOL * abs(
        losses["cpu"])


def test_plan_bf16_wrappers_never_call_plain_on_the_card(cuda, monkeypatch):
    """Under 'fastest' on CUDA tensors the band plan's and the corner
    plans' wrappers launch their one-limb kernels, never a plain version
    and never the f32 kernel."""

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    gen = torch.Generator(device=cuda).manual_seed(2)
    calls = []
    for kind in ("cora", "corner"):
        for which in (0, 1):
            kernel, _, _, args, kw = _bf16_forward_cases(kind, which, 2, 3,
                                                         gen, cuda)
            calls.append(lambda k=kernel, a=args, w=kw: k(
                *a, precision="fastest", **w))
    g, plan = _band(cuda, "cora")
    table = torch.randn(plan.n_pad, 5, generator=gen, device=cuda)
    data = torch.randn(plan.num_slots, 5, generator=gen, device=cuda)
    calls += [lambda: bd.banded_take(table, plan, precision="fastest"),
              lambda: bd.banded_sender_sum(data, plan, precision="fastest")]
    for mod, name in ((bd, "banded_take_plain"),
                      (bd, "banded_sender_sum_plain"),
                      (bd, "fused_v1_banded_plain"),
                      (bd, "fused_v2_banded_plain"),
                      (fc, "fused_v1_window_plain"),
                      (fc, "fused_v2_window_plain"),
                      (fs, "fused_v1_plain"), (fs, "fused_v2_plain"),
                      (st, "stream_scatter_plain")):
        monkeypatch.setattr(mod, name, boom)
    before = build.launch_counts()
    for call in calls:
        call()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in build.launch_counts().items()
                if v - before[k]}
    assert launched == {"fused_v1_banded_bf16": 1, "fused_v2_banded_bf16": 1,
                        "fused_v1_window_bf16": 1, "fused_v2_window_bf16": 1,
                        "banded_take_bf16": 1, "banded_sender_sum_bf16": 1}


# -- the one-limb SpMM kernels ---------------------------------------------------


@pytest.mark.parametrize("which", ["banded", "panel"])
@pytest.mark.parametrize("width", [7, 128])
@pytest.mark.parametrize("kind", ["clustered", "hub"])
def test_spmm_bf16_kernels_match_plain(cuda, kind, width, which):
    """``spmm_banded_bf16.cu`` / ``panel_spmm_bf16.cu`` (through the SpMM
    wrappers under 'fastest' and their one-limb twins) against their plain
    versions under 'fastest' in f64, to RTOL of the same sums over
    |message|: both sides round each message alike, so only the order of
    the f32 sums differs. On the clustered graph's band plan and capped
    panel layout, and on the hub's (its tile split over several blocks), at
    an odd width (scalar loads) and at 128 (8-byte loads); counted apart
    from the f32 kernels; two calls equal bit for bit; apart from 'high'."""
    gen = torch.Generator(device=cuda).manual_seed(width)
    kernel, plain, vals, rest, g = _spmm_kernel(cuda, f"{which}_hub"
                                                if kind == "hub" else which,
                                                gen)
    bf16 = {bd.banded_weighted_sum: bd.banded_weighted_sum_bf16,
            pn.panel_weighted_sum: pn.panel_weighted_sum_bf16}[kernel]
    x = _nan_tail(g.num_nodes_padded, width, gen, cuda)
    before = build.launch_counts()
    got = kernel(vals, x, *rest, precision="fastest")
    again = bf16(vals, x, *rest)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in build.launch_counts().items()
                if v - before[k]}
    assert launched == {bf16.kernel: 2}
    assert torch.equal(got, again)
    want = plain(vals, x, *rest, precision="fastest", f64=True)
    mag = plain(vals, x, *rest, precision="fastest", magnitude=True)
    assert bool(torch.isfinite(got).all()) and float(mag.max()) > 1.0
    assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
    high = plain(vals, x, *rest, f64=True)
    assert float((got - high).abs().max()) > 1e-5 * float(mag.max())


SPMM_BF16_ROUTES = {
    "banded": (lambda v, x, g, p: ops.spmm_banded(v, x, p[0]),
               {"spmm_banded_bf16": 1, "banded_take_bf16": 1, "expand": 1,
                "banded_sender_sum_bf16": 1}),
    "banded_two_pass": (lambda v, x, g, p: ops.spmm_banded(v, x, p[0],
                                                           fused=False),
                        {"banded_take_bf16": 2, "stream_scatter_bf16": 1,
                         "expand": 1, "banded_sender_sum_bf16": 1}),
    "panel": (lambda v, x, g, p: ops.panel_spmm_graph(v, x, g, p[1]),
              {"panel_spmm_bf16": 1}),
    "panel_corner": (lambda v, x, g, p: ops.panel_spmm_graph(v, x, g, p[1],
                                                             plans=p[2]),
                     {"panel_spmm_bf16": 1, "expand": 2,
                      "stream_scatter_bf16": 1}),
    "corner": (lambda v, x, g, p: ops.spmm_corner_graph(v, x, g, p[2],
                                                        precision="fastest"),
               {"expand": 2, "stream_scatter_bf16": 2}),
}


@pytest.mark.parametrize("route", list(SPMM_BF16_ROUTES))
def test_spmm_ops_fastest_card_vs_cpu(cuda, route):
    """Forward and both gradients of the SpMM ops under 'fastest' (the
    default of spmm_banded and panel_spmm_graph) through their autograd
    Functions, on the card against the same op on the CPU, from one seed:
    one call launches the one-limb kernels as the route states (the corner
    passes besides) and no f32 SpMM kernel or f32 segment sum."""
    g, plan, layout, plans = _spmm_setup()
    rng = np.random.default_rng(8)
    n_pad, width = g.num_nodes_padded, 48
    e = plan.num_slots if route.startswith("banded") else g.num_edges_padded
    first = rng.standard_normal(e)
    if route.startswith("banded"):
        first = np.where(plan.perm >= 0, first, 0.0)  # 0 on dead slots
    x = rng.standard_normal((n_pad, width))
    ct = rng.standard_normal((n_pad, width))
    fn, want = SPMM_BF16_ROUTES[route]
    k_passes = len(plans.fwd.passes) + len(plans.inv.passes)
    if "corner" in route:
        want = dict(want, corner_permute=k_passes)
    results = []
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(a, dtype=torch.float32, device=dev,
                               requires_grad=True) for a in (first, x)]
        parts = (plan.to(dev), layout.to(dev), plans.to(dev))
        before = build.launch_counts()
        out = fn(*leaves, g.to(dev), parts)
        grads = torch.autograd.grad(out, leaves, torch.tensor(
            ct, dtype=torch.float32, device=dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            launched = {k: v - before[k]
                        for k, v in build.launch_counts().items()
                        if v - before[k]}
            assert launched == want, (route, launched)
        results.append([t.detach().cpu() for t in (out, *grads)])
    for got, ref in zip(results[1], results[0]):
        _close(got, ref)

