"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without one. This
file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The shapes are small and odd on purpose: widths that are not multiples of
4 or 8, more than 128 columns (several column slabs / head groups per
tile), a tile without edges, and dead slots whose logits would overflow.
chip_smoke.py covers the main path's full-size shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pygat_tpu_torch.graph import build_graph
from pygat_tpu_torch.ops import fused_stream as fs
from pygat_tpu_torch.ops import stream as st

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


def test_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    g = _graph(cuda, False)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(st, "stream_scatter_plain", boom)
    monkeypatch.setattr(fs, "fused_v1_plain", boom)
    data = torch.zeros(4, g.num_edges_padded, device=cuda).T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        st.stream_scatter(data, g.r_local, g.r_chunk, g.num_nodes_padded)
    args = _fused_args(g, 2, 3, torch.Generator(device=cuda), cuda)
    args[0] = args[0].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_v1(*args)
