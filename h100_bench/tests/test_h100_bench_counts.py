"""The FLOP count and the kernels' byte counts against counts by brute
force on small graphs, and the trace's arithmetic on a stretch made by
hand."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_cases import tiny_cell
from h100_bench import core
from h100_bench.reference import gat
from h100_bench.trace import Stretch, base_name, port_kernels
from h100_bench.weights import init_weights, layers

FLOPS = core.load_module("flops", "gat")


def _graph(n=40, deg=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    dst = torch.arange(n).repeat_interleave(deg)
    src = torch.randint(0, n, (n * deg,), generator=g)
    loops = torch.arange(n)
    return torch.cat([src, loops]), torch.cat([dst, loops])


@pytest.mark.parametrize("skip", (True, False))
def test_products_match_the_flop_counter(skip):
    model = dict(core.read_json("configs", "gat-ppi.json")["model"],
                 skip=skip)
    model["widths"] = [model["widths"][0]] + [8] * (len(model["widths"]) - 2) \
        + [model["widths"][-1]]
    src, dst = _graph()
    n = 40
    params = init_weights(model, 5, "cpu")
    for t in gat.leaves(params):
        t.requires_grad_()
    x = torch.randn(n, model["widths"][0])
    with FlopCounterMode(display=False) as fwd:
        out = gat.forward(params, x, src, dst, alpha=0.2)
    with FlopCounterMode(display=False) as bwd:
        out.square().sum().backward()
    shapes = {"layers": layers(model),
              "passes": [dict(train=False, n_real=n, e_real=src.numel())]}
    want_fwd = sum(FLOPS.layer_forward(n, src.numel(), lay["f_in"],
                                       lay["f_out"], lay["heads"],
                                       bool(model.get("skip")))[0]
                   for lay in shapes["layers"])
    assert fwd.get_total_flops() == want_fwd
    train = sum(FLOPS.layer_forward(n, src.numel(), lay["f_in"], lay["f_out"],
                                    lay["heads"], bool(model.get("skip")))[0]
                * (1 if i == 0 else 2) for i, lay in enumerate(shapes["layers"]))
    assert bwd.get_total_flops() == train


def test_epoch_flops_by_brute_force():
    """Every node's and edge's operations counted one by one."""
    model = core.read_json("configs", "gat-ppi.json")["model"]
    lays = layers(model)
    passes = [dict(train=True, n_real=7, e_real=19),
              dict(train=True, n_real=5, e_real=11),
              dict(train=False, n_real=6, e_real=13)]
    want = 0.0
    for ps in passes:
        for i, lay in enumerate(lays):
            h, fi, fo = lay["heads"], lay["f_in"], lay["f_out"]
            prod = rest = 0
            for _ in range(ps["n_real"]):
                for _ in range(h):
                    prod += 2 * fi * fo * 2  # projection and skip
                    rest += 2 * fo + 2 * fo  # logit terms
                    rest += fo + fo  # normalisation, ELU or mean
            for _ in range(ps["e_real"]):
                for _ in range(h):
                    rest += 5 + 2 * fo
            want += prod + rest
            if ps["train"]:
                want += prod * (1 if i == 0 else 2) + 2 * rest
    got = FLOPS.epoch_flops(model, {"layers": lays, "passes": passes})
    assert got == want


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def test_stream_bounds_by_brute_force(man, cpu_threads):
    """Rows 1 and 2: the bytes of the very tensors each call reads and
    writes, on the batches the program collates from the tiny PPI cell's
    banks."""
    from pygat_tpu_torch.data.ppi import assemble_banked_batch

    cell = tiny_cell("ppi-gat-banked", 3, man)
    session = cell.driver().setup(cell, "cpu", cell.generate())
    shapes = session.shapes()
    b = int(cell.config["model"]["batch_size"])
    sums, fused = [], []
    batches = [(bank, list(range(lo, lo + b)))
               for bank in session.banks
               for lo in range(0, bank.n_graphs, b)]
    assert len(batches) == len(shapes["passes"])
    for (bank, idx), ps in zip(batches, shapes["passes"]):
        x, g, _ = assemble_banked_batch(bank, idx, [True] * b)
        n = x.shape[0]
        live = int(g.edge_mask.sum())
        assert (ps["n_pad"], ps["e_real"]) == (n, live)
        for lay in shapes["layers"]:
            h, f = lay["heads"], lay["f_out"]
            if ps["train"]:
                sums.append(_nbytes(torch.zeros(live, h), g.r_local,
                                    g.r_chunk, torch.zeros(n, h)))
                sums.append(_nbytes(torch.zeros(live, h * f), g.c_local,
                                    g.c_chunk, g.c_slot,
                                    torch.zeros(n, h * f)))
            fused.append(_nbytes(
                torch.zeros(n, h * f), torch.zeros(n, h), torch.zeros(n, h),
                torch.zeros(h, f), torch.zeros(live, h), g.senders,
                g.r_local, g.r_chunk, torch.zeros(n, h * f),
                torch.zeros(n, h)))
    assert core.load_module("bounds", "stream_scatter").calls(shapes) == sums
    assert core.load_module("bounds", "fused_v1").calls(shapes) == fused
    session.close()


def test_the_port_kernels_are_read_from_its_sources():
    names = port_kernels()
    assert {"tile_fused_kernel", "tile_sum_kernel", "gather_rows_kernel",
            "take_rows_kernel"} <= names


def _stretch():
    port = {"tile_fused_kernel", "gather_rows_kernel"}
    kernels = [
        ("void tile_fused_kernel<8, true, false, false, "
         "(anonymous namespace)::ListWalk, float>(FusedArgsT<float>, "
         "(anonymous namespace)::ListWalk)", 0.0, 10.0),
        ("void gather_rows_kernel<256, WindowRows, float>(float const*)",
         12.0, 4.0),
        ("ampere_sgemm_32x32_sliced1x4_nn", 14.0, 20.0),  # overlaps
        ("void at::native::elementwise_kernel<128, 4>(int)", 40.0, 5.0),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)", 50.0,
         2.0),
    ]
    host = [("cudaLaunchKernel", 33.0, 2.0), ("BankedEpochs.run", 0.0, 60.0)]
    return Stretch(epochs=2, wall_s=60e-6, kernels=kernels,
                   device_ops=kernels + [("Memcpy DtoH", 46.0, 1.0)],
                   host=host, port=port)


def test_stretch_arithmetic():
    st = _stretch()
    assert [st.kind(k[0]) for k in st.kernels] == [
        "port", "port", "gemm", "torch", "comm"]
    assert st.per_epoch_ms("port") == pytest.approx(14.0 / 1e3 / 2)
    assert st.per_epoch_ms("gemm") == pytest.approx(20.0 / 1e3 / 2)
    assert st.busy_intervals() == [(0.0, 10.0), (12.0, 34.0), (40.0, 45.0),
                                   (46.0, 47.0), (50.0, 52.0)]
    assert st.busy_s() == pytest.approx(40.0e-6)
    assert st.busy_s(collectives=False) == pytest.approx(38.0e-6)
    gaps = st.idle_gaps()
    assert gaps[0] == ["BankedEpochs.run", pytest.approx(6e-6)]
    assert [g[1] for g in gaps] == pytest.approx([6e-6, 3e-6, 2e-6, 1e-6])
    assert st.top_ops(1)[0][1] == pytest.approx(20e-6)
    ms, hits = st.matching_ms(core.load_module("bounds", "fused_v1").TRACE)
    assert hits == 1 and ms == pytest.approx(10.0 / 1e3 / 2)
    assert base_name(st.kernels[0][0]) == "tile_fused_kernel"


def test_metric_readers_on_a_made_stretch():
    from h100_bench.run import LayerContext

    st = _stretch()
    ctx = LayerContext(stretch=st, epoch_ms=0.025, spans={"setup.plan_s": 1.5},
                       shapes={}, launches={}, flops=67e12 * 0.025e-3 * 0.5)
    read = lambda name: core.load_module("metrics", name).read(ctx)  # noqa: E731
    # the collective's 2 us are waiting, not work
    assert read("idle_share") == pytest.approx(100 * (1 - 0.019 / 0.025))
    assert read("mfu") == pytest.approx(50.0)
    assert read("kernels.port_ms") == pytest.approx(0.007)
    assert read("model.gemm_ms") == pytest.approx(0.010)
    assert read("model.torch_ms") == pytest.approx(0.0025)
    assert read("loop.launches_per_epoch") == pytest.approx(2.5)
    assert read("setup.plan_s") == 1.5 and read("setup.data_s") is None
