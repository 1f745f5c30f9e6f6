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
row short of naming N_pad) and a window clipped to the table.
chip_smoke.py covers the main path's full-size shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pygat_tpu_torch.data import synthetic
from pygat_tpu_torch.data.citation import CitationDataset
from pygat_tpu_torch.graph import build_graph
from pygat_tpu_torch.models.gat import GATConfig
from pygat_tpu_torch.ops import banded as bd
from pygat_tpu_torch.ops import fused_stream as fs
from pygat_tpu_torch.ops import large
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


@pytest.mark.parametrize("empty_tile", [False, True])
@pytest.mark.parametrize("width", [1, 7, 8, 64, 130, 300])
def test_stream_scatter_kernel_matches_plain(cuda, width, empty_tile):
    g = _graph(cuda, empty_tile)
    gen = torch.Generator(device=cuda).manual_seed(width)
    n_pad = g.num_nodes_padded
    data = torch.randn(g.num_edges_padded, width, generator=gen, device=cuda)
    before = st.stream_scatter.launches
    got = st.stream_scatter(data, g.r_local, g.r_chunk, n_pad)
    got_s = st.stream_scatter(data, g.c_local, g.c_chunk, n_pad, slot=g.c_slot)
    torch.cuda.synchronize()
    assert st.stream_scatter.launches == before + 2
    _close(got, st.stream_scatter_plain(data, g.r_local, g.r_chunk, n_pad))
    _close(got_s, st.stream_scatter_plain(data, g.c_local, g.c_chunk, n_pad,
                                          slot=g.c_slot))
    if empty_tile:
        assert float(got[128:256].abs().max()) == 0.0


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
@pytest.mark.parametrize("h,f", [(8, 8), (1, 7), (3, 5), (20, 8), (2, 130)])
def test_fused_v1_kernel_matches_plain(cuda, h, f, empty_tile):
    g = _graph(cuda, empty_tile)
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    args = _fused_args(g, h, f, gen, cuda)
    before = fs.fused_v1.launches
    out, den = fs.fused_v1(*args)
    torch.cuda.synchronize()
    assert fs.fused_v1.launches == before + 1
    out_p, den_p = fs.fused_v1_plain(*args)
    _close(out, out_p)
    _close(den, den_p)


def test_fused_v1_kills_dead_slots_on_the_card(cuda):
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _fused_args(g, 2, 3, gen, cuda)
    args[0] = args[0].clone()
    args[0][-1] = 1e4  # the dummy row every dead slot points at
    out, den = fs.fused_v1(*args)
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
            gg.c_local, gg.c_chunk, 0.2)
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
    out, den = fs.fused_v2(*args)
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
    out, den = fs.fused_v2(*args)
    out_p, den_p = fs.fused_v2_plain(*args)
    _close(out, out_p)
    _close(den, den_p)


def test_fused_v2_rejects_too_wide_a_head(cuda):
    g = _graph(cuda, False)
    args = _fused_v2_args(g, 1, 257, torch.Generator(device=cuda), cuda)
    with pytest.raises(ValueError, match="exceeds 256"):
        fs.fused_v2(*args)


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
            gg.c_local, gg.c_chunk, 0.2)
        (out.sin().sum() + den.cos().sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        scale = max(1e-30, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("h,f", [(8, 8), (16, 8)])
def test_fused_v2_launch_is_capturable(cuda, h, f):
    """A launch inside CUDA-graph capture (at (16, 8) with more than 48 KB
    of shared memory, so the attribute call sits inside the capture too)
    replays to the plain version's result on fresh inputs."""
    g = _graph(cuda, False)
    gen = torch.Generator(device=cuda).manual_seed(2)
    args = _fused_v2_args(g, h, f, gen, cuda)
    fs.fused_v2(*args)  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, den = fs.fused_v2(*args)
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


def test_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    g = _graph(cuda, False)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(st, "stream_scatter_plain", boom)
    monkeypatch.setattr(fs, "fused_v1_plain", boom)
    monkeypatch.setattr(fs, "fused_v2_plain", boom)
    data = torch.zeros(4, g.num_edges_padded, device=cuda).T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        st.stream_scatter(data, g.r_local, g.r_chunk, g.num_nodes_padded)
    args = _fused_args(g, 2, 3, torch.Generator(device=cuda), cuda)
    args[0] = args[0].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_v1(*args)
    args = _fused_v2_args(g, 2, 3, torch.Generator(device=cuda), cuda)
    fs.fused_v2(*args)  # launches the kernel, never the plain version
    args[1] = args[1].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_v2(*args)


# -- the banded kernels --------------------------------------------------------


def _plan(device, kind):
    """(graph, band plan): ``clustered`` has several chunks per tile,
    ``empty_tile`` a tile without edges, ``clipped`` asks for a window wider
    than the table. Each plan ends in all-dead padding chunks on the last
    band, so a dead slot there would name row N_pad if formed first."""
    rng = np.random.default_rng(5)
    if kind == "empty_tile":
        return _graph(device, True), 2
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
    """Dead slots carry data, which must be ignored; the sums agree to
    RTOL of the same sums over |data| (f32 in another order)."""
    _, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(width)
    data = torch.randn(plan.num_slots, width, generator=gen, device=cuda)
    before = bd.banded_sender_sum.launches
    got = bd.banded_sender_sum(data, plan)
    torch.cuda.synchronize()
    assert bd.banded_sender_sum.launches == before + 1
    want = bd.banded_sender_sum_plain(data, plan)
    mag = bd.banded_sender_sum_plain(data.abs(), plan)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= RTOL * mag + 1e-30).all())
    assert float(mag.max()) > 1.0  # the comparison is not idle


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


@pytest.mark.parametrize("kind", BAND_KINDS)
@pytest.mark.parametrize("h,f", [(8, 8), (1, 4), (1, 7), (2, 5), (3, 11),
                                 (16, 8)])
@pytest.mark.parametrize("which", [0, 1], ids=["v1", "v2"])
def test_fused_banded_kernels_match_plain(cuda, kind, h, f, which):
    kernel, plain, make_args = BANDED_FUSED[which]
    g, plan = _band(cuda, kind)
    gen = torch.Generator(device=cuda).manual_seed(10 * h + f)
    args = make_args(g, plan, h, f, gen, cuda)
    before = kernel.launches
    out, den = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    out_p, den_p = plain(*args)
    assert float(den_p.max()) >= 1.0  # the comparison is not idle
    _close(out, out_p)
    _close(den, den_p)
    if kind == "empty_tile":
        assert float(out[128:256].abs().max()) == 0.0
        assert float(den[128:256].abs().max()) == 0.0


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
