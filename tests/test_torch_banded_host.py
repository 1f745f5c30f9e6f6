"""The PyTorch port's band plan against the JAX package's: every field of
``build_band_plan`` equal on the same edge arrays (clustered and uniform
graphs, a graph with empty tiles, a window clipped to the table), the
selection of ``maybe_plan_band`` / ``maybe_plan_large``, and the port's
``clustered_citation`` graph."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import banded as jbd
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data.synthetic import clustered_citation
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops.stream import DEAD, EC, TILE

JAX_FIELDS = ("band", "s_loc", "r_local", "r_chunk", "senders", "receivers",
              "edge_weight", "c_slot", "c_local", "c_chunk", "bs_band",
              "bs_chunk", "bs_sloc", "perm")


def _edges(kind):
    """(senders, receivers, weights, n, n_pad) of a few hundred nodes."""
    rng = np.random.default_rng({"clustered": 0, "uniform": 1,
                                 "empty_tiles": 2, "tiny": 3}[kind])
    if kind == "empty_tiles":  # receivers in tiles 0 and 2 only
        r = np.concatenate([rng.integers(0, 100, 700),
                            rng.integers(256, 380, 700)])
        s = rng.integers(0, 383, 1400)
        return s, r, rng.random(1400).astype(np.float32), 383, 512
    n, deg = {"clustered": (700, 5), "uniform": (700, 5), "tiny": (100, 3)}[kind]
    base = np.repeat(np.arange(n, dtype=np.int64), deg)
    if kind == "clustered":
        s = np.clip(base + rng.integers(-300, 300, base.shape[0]), 0, n - 1)
    else:
        s = rng.integers(0, n, base.shape[0])
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([base, np.arange(n)])
    return s, r, rng.random(s.shape[0]).astype(np.float32), n, None


def _graphs(kind):
    s, r, wt, n, n_pad = _edges(kind)
    return (jbuild_graph(s, r, wt, n, n_pad=n_pad),
            tbuild_graph(s, r, wt, n, n_pad=n_pad, device="cpu"))


def _assert_plans_equal(pj, pt):
    assert pt.w == pj.w and pt.fill == pj.fill
    for name in JAX_FIELDS:
        want = np.asarray(getattr(pj, name))
        got = getattr(pt, name)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.int32, name
            got = got.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pt.num_slots == pj.num_slots and pt.num_chunks == pj.num_chunks


@pytest.mark.parametrize("kind,w", [("clustered", 3), ("uniform", 3),
                                    ("empty_tiles", 2), ("tiny", 64)])
def test_build_band_plan_matches_jax(kind, w):
    """Exact equality, field by field (the JAX side is host numpy code);
    ``tiny`` asks for a window wider than the table."""
    gj, gt = _graphs(kind)
    pj = jbd.build_band_plan(gj, w=w)
    pt = tbd.build_band_plan(gt, w=w)
    _assert_plans_equal(pj, pt)
    assert pt.n_pad == gt.num_nodes_padded
    if kind == "tiny":
        assert pt.w == gt.num_nodes_padded // TILE
    # a dead slot of a chunk on the last band would name row N_pad: the
    # sender rows the port forms never leave the table
    rows = tbd.banded_senders(pt, -1)
    live = pt.r_local < DEAD
    assert bool((rows[live] < pt.n_pad).all()) and bool((rows[~live] == -1).all())


def test_build_band_plan_reads_the_device_without_a_host_copy():
    """A graph whose edges have no host copy (not built in this process)
    is read back once, and plans the same."""
    _, gt = _graphs("clustered")
    moved = gt._replace(senders=gt.senders.clone())
    _assert_plans_equal(tbd.build_band_plan(gt, w=4),
                        tbd.build_band_plan(moved, w=4))


def test_band_plan_to_moves_the_device_fields_only():
    _, gt = _graphs("tiny")
    plan = tbd.build_band_plan(gt, w=2)
    moved = plan.to("meta")
    assert all(getattr(moved, f).device.type == "meta"
               for f in ("band", "s_loc", "r_local", "r_chunk"))
    assert moved.perm is plan.perm and moved.n_pad == plan.n_pad


@pytest.fixture
def band_knobs(monkeypatch):
    """Restore the module's knobs after the test, whatever it sets."""
    for name in ("_BAND_MODE", "_BAND_N", "_BAND_W", "_BAND_MIN_FILL",
                 "_CORNER_MODE", "_CORNER_N"):
        monkeypatch.setattr(tbd, name, getattr(tbd, name))
    return monkeypatch


def test_maybe_plan_band_gating(band_knobs):
    """Mirrors tests/test_banded.py::test_maybe_plan_band_gating: the
    threshold, 'off', and the fill gate, which only 'auto' applies."""
    _, gt = _graphs("clustered")
    tbd.set_band("auto", n=10 ** 6)
    assert tbd.maybe_plan_band(gt) is None  # below the threshold
    tbd.set_band("auto", n=0, w=3)
    plan = tbd.maybe_plan_band(gt)
    assert isinstance(plan, tbd.BandPlan) and plan.w == 3
    tbd.set_band("off")
    assert tbd.maybe_plan_band(gt) is None
    _, gu = _graphs("uniform")
    tbd.set_band("auto", n=0, w=1)  # uniform senders: one tile wide packs poorly
    band_knobs.setattr(tbd, "_BAND_MIN_FILL", 0.9)
    assert tbd.build_band_plan(gu, w=1).fill < 0.9
    assert tbd.maybe_plan_band(gu) is None
    tbd.set_band("on")
    assert tbd.maybe_plan_band(gu) is not None
    with pytest.raises(ValueError, match="unknown band mode"):
        tbd.set_band("sometimes")


def test_maybe_plan_large_never_ignores_a_corner_request(band_knobs):
    _, gt = _graphs("tiny")
    tbd.set_band("off")
    assert tbd.maybe_plan_large(gt) is None  # the corner default is off
    band_knobs.setattr(tbd, "_CORNER_N", gt.num_nodes_padded)
    with pytest.raises(NotImplementedError, match="item 15"):
        tbd.maybe_plan_large(gt)
    band_knobs.setattr(tbd, "_CORNER_N", 2 ** 62)
    band_knobs.setattr(tbd, "_CORNER_MODE", "on")
    with pytest.raises(NotImplementedError, match="item 15"):
        tbd.maybe_plan_large(gt)
    tbd.set_band("on")  # a band plan comes first, as in the JAX package
    assert isinstance(tbd.maybe_plan_large(gt), tbd.BandPlan)


def test_clustered_citation_graph():
    """9 in-edges per node within +-spread plus a self-loop, labels by node
    band, 10/10/80 splits, and the same arrays in every call."""
    n, spread = 1000, 40
    data = clustered_citation(n, 100, 4, "banded-host", spread, device="cpu")
    g = data.graph
    live = g.edge_mask
    s, r = g.senders[live].long(), g.receivers[live].long()
    assert int(live.sum()) == 10 * n
    assert bool(((s - r).abs() <= spread).all())
    assert bool((torch.bincount(r, minlength=n)[:n] == 10).all())
    assert int((s == r).sum()) >= n
    assert data.features.shape == (g.num_nodes_padded, 100)
    assert float(data.features[:, 64:].abs().max()) == 0.0
    lab = data.labels[:n]
    assert lab.tolist() == sorted(lab.tolist()) and set(lab.tolist()) == {0, 1, 2, 3}
    assert (len(data.idx_train), len(data.idx_val), len(data.idx_test)) == (
        100, 100, 800)
    again = clustered_citation(n, 100, 4, "banded-host", spread, device="cpu")
    assert torch.equal(again.graph.senders, g.senders)
    assert torch.equal(again.features, data.features)
    plan = tbd.build_band_plan(g, w=4)
    assert plan.fill > 0.5  # local edges pack well
    assert plan.num_slots % (8 * EC) == 0
