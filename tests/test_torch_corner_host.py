"""The PyTorch port's corner planner against the JAX package's: every field
of ``plan_corner_turn`` equal on random, nearly sorted and ``care``-masked
permutations (a small ``p_cap`` forcing several passes, re-windowed tiles
and overflow rows), ``plan_csc_to_csr`` on a stream graph and on a bucketed
one, and the selection of ``maybe_plan_large`` / ``set_corner``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pygat_tpu.graph import build_graph as jbuild_graph
from pygat_tpu.ops import corner as jcorner
from pygat_tpu.ops import large as jlarge
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.graph import build_graph as tbuild_graph
from pygat_tpu_torch.ops import banded as tbd
from pygat_tpu_torch.ops import corner as tcorner
from pygat_tpu_torch.ops import large as tlarge


def _assert_plans_equal(pj, pt):
    """Field by field: per pass lo, g (with its padding to whole groups of 8
    tiles), ov_src and ov_dst (padded with duplicates of pair 0), p and
    n_overflow; and the row count."""
    assert pt.n_rows == pj.n_rows and len(pt.passes) == len(pj.passes)
    arrs_j, ps_j = jcorner.flatten_plan(pj)
    arrs_t, ps_t = tcorner.flatten_plan(pt)
    assert ps_t == ps_j
    for i, (aj, at) in enumerate(zip(arrs_j, arrs_t)):
        assert at.dtype == torch.int32, i
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj),
                                      err_msg=f"array {i}")
    assert [cp.n_overflow for cp in pt.passes] == [cp.n_overflow
                                                   for cp in pj.passes]
    assert pt.overflow_total == pj.overflow_total


def _dest(kind, e, rng):
    if kind == "random":
        return rng.permutation(e)
    # nearly sorted: each row moves by at most a few tiles
    return np.argsort(np.arange(e) + rng.integers(-400, 400, e), kind="stable")


@pytest.mark.parametrize("kind,e,p_cap,masked", [
    ("random", 4096, 56, False),  # one pass
    ("random", 128 * 200, 3, False),  # several passes, overflow
    ("nearly_sorted", 128 * 120, 4, False),
    ("random", 128 * 150, 3, True),  # care mask: dead rows left out
])
def test_plan_corner_turn_matches_jax(kind, e, p_cap, masked):
    rng = np.random.default_rng(e + p_cap)
    dest = _dest(kind, e, rng)
    care = rng.random(e) > 0.2 if masked else None
    pj = jcorner.plan_corner_turn(dest, p_cap, care=care)
    pt = tcorner.plan_corner_turn(dest, p_cap, care=care)
    _assert_plans_equal(pj, pt)
    if p_cap < 56:
        assert len(pt.passes) >= 2
    if kind == "random" and p_cap == 3:
        assert pt.overflow_total > 0  # the fix-up is exercised


def test_plan_pair_matches_jax():
    dest = np.random.default_rng(9).permutation(128 * 30)
    for pj, pt in zip(jcorner.plan_pair(dest), tcorner.plan_pair(dest)):
        _assert_plans_equal(pj, pt)


def test_plan_corner_turn_rejects_ragged_rows():
    with pytest.raises(ValueError, match="multiple of 128"):
        tcorner.plan_corner_turn(np.arange(100))


def _graph_edges(bucketed):
    rng = np.random.default_rng(11 if bucketed else 3)
    n = 140 if bucketed else 300
    m = 500 if bucketed else n * 6
    s = np.concatenate([rng.integers(0, n, m), np.arange(n)])
    r = np.concatenate([rng.integers(0, n, m), np.arange(n)])
    kw = dict(n_pad=512, e_pad=2048) if bucketed else {}
    return (jbuild_graph(s, r, None, n, **kw),
            tbuild_graph(s, r, None, n, device="cpu", **kw))


@pytest.mark.parametrize("bucketed,p_cap", [(False, None), (False, 3),
                                            (True, None)])
def test_plan_csc_to_csr_matches_jax(bucketed, p_cap):
    """The bucketed graph (as tests/test_corner.py builds it) has empty
    tiles, all-dead chunks and dead CSC slots."""
    gj, gt = _graph_edges(bucketed)
    pj = jlarge.plan_csc_to_csr(gj, p_cap=p_cap)
    pt = tlarge.plan_csc_to_csr(gt, p_cap=p_cap)
    _assert_plans_equal(pj.fwd, pt.fwd)
    _assert_plans_equal(pj.inv, pt.inv)
    assert pt.fwd.n_rows == gt.c_slot.shape[0]
    if p_cap == 3:
        assert pt.fwd.overflow_total > 0 and pt.inv.overflow_total > 0
    moved = pt.to("meta")
    assert all(t.device.type == "meta" for pl in moved for cp in pl.passes
               for t in (cp.lo, cp.g, cp.ov_src, cp.ov_dst))


@pytest.fixture
def knobs(monkeypatch):
    """Restore the selection knobs after the test, whatever it sets."""
    for name in ("_BAND_MODE", "_BAND_N", "_BAND_W"):
        monkeypatch.setattr(tbd, name, getattr(tbd, name))
    for name in ("_CORNER_MODE", "_CORNER_N"):
        monkeypatch.setattr(tlarge, name, getattr(tlarge, name))
    return monkeypatch


def test_maybe_plan_large_precedence(knobs):
    """Band first, then corner, then none, as the JAX package picks."""
    _, gt = _graph_edges(False)
    tbd.set_band("off")
    tlarge.set_corner("auto")
    assert tbd.maybe_plan_large(gt) is None  # 'auto' never plans by default
    knobs.setattr(tlarge, "_CORNER_N", gt.num_nodes_padded)
    assert isinstance(tbd.maybe_plan_large(gt), tlarge.CscCsrPlans)
    knobs.setattr(tlarge, "_CORNER_N", 2 ** 62)
    tlarge.set_corner("on")
    plans = tbd.maybe_plan_large(gt)
    assert isinstance(plans, tlarge.CscCsrPlans)
    _assert_plans_equal(plans.fwd, tlarge.plan_csc_to_csr(gt).fwd)
    tbd.set_band("on", w=2)
    assert isinstance(tbd.maybe_plan_large(gt), tbd.BandPlan)
    tbd.set_band("off")
    tlarge.set_corner("off")
    assert tbd.maybe_plan_large(gt) is None


def test_set_corner_validates_its_mode(knobs):
    with pytest.raises(ValueError, match="unknown corner mode"):
        tlarge.set_corner("sometimes")
    for mode in ("auto", "on", "off"):
        tlarge.set_corner(mode)
        assert tlarge._CORNER_MODE == mode
