"""The PyTorch port's inductive PPI pipeline against the JAX package on the
CPU: the multi-label metrics, the PPI loader's stand-ins, the host-built
block-diagonal batches (with their walks), the model on a PPI batch
(forward and gradients, both models) and the per-batch loop
``fit_inductive`` over three epochs from the same parameters."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from pygat_tpu.data import ppi as jppi
from pygat_tpu.graph import block_diag as jblock_diag
from pygat_tpu.models import gat as jgat
from pygat_tpu.ops import segment as jseg
from pygat_tpu.train import checkpoint as jckpt
from pygat_tpu.train import loop as jloop
from pygat_tpu.train import metrics as jmetrics
from pygat_tpu.train.logging import TrainLogger as JLogger
from tests.torch_ppi_data import CFG, synth_ppi
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data import ppi as tppi
from pygat_tpu_torch.data.citation import _search_roots
from pygat_tpu_torch.graph import block_diag as tblock_diag
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.ops.stream import build_stream_walk
from pygat_tpu_torch.train import checkpoint as tckpt
from pygat_tpu_torch.train import metrics as tmetrics
from pygat_tpu_torch.train.inductive import fit_inductive
from pygat_tpu_torch.train.logging import TrainLogger


def _quiet(cls=TrainLogger):
    return cls(stream=open(os.devnull, "w"))


@pytest.fixture(scope="module")
def data():
    return (synth_ppi(jppi.PPIGraph, jppi.PPIData),
            synth_ppi(tppi.PPIGraph, tppi.PPIData))


def _numpy_params(jparams):
    return [tuple(None if t is None else np.asarray(t) for t in p)
            for p in jparams]


def _assert_walk_is_built(g):
    """The graph's two walks equal ``build_stream_walk`` of its own
    fields."""
    n_tiles = g.num_nodes_padded // 128
    for local, chunk, walk in ((g.r_local, g.r_chunk, g.stream_walk),
                               (g.c_local, g.c_chunk, g.sender_walk)):
        ref = build_stream_walk(local.numpy(), chunk.numpy(), n_tiles, "cpu")
        for f in ("row_ptr", "tile_ptr", "split_at"):
            assert torch.equal(getattr(walk, f), getattr(ref, f)), f
        assert walk.max_run == ref.max_run and walk.order is None


@pytest.mark.parametrize("mask", [None, "rows", "elements"])
def test_multilabel_metrics_match_jax(mask):
    """bce_with_logits, f1_counts and micro_f1, with no mask, a 1-D mask
    of real rows and a 2-D mask, against the JAX package's."""
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((50, 7)) * 3).astype(np.float32)
    targets = (rng.random((50, 7)) < 0.4).astype(np.float32)
    m = {None: None, "rows": rng.random(50) < 0.7,
         "elements": rng.random((50, 7)) < 0.6}[mask]
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    lj, tj = jnp.asarray(logits), jnp.asarray(targets)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    np.testing.assert_allclose(
        float(tmetrics.bce_with_logits(lt, tt, tm)),
        float(jmetrics.bce_with_logits(lj, tj, jm)), rtol=1e-6)
    for a, b in zip(tmetrics.f1_counts(lt, tt, tm),
                    jmetrics.f1_counts(lj, tj, jm)):
        assert float(a) == float(b)
    np.testing.assert_allclose(float(tmetrics.micro_f1(lt, tt, tm)),
                               float(jmetrics.micro_f1(lj, tj, jm)), rtol=1e-6)


def test_load_ppi_valid_split_matches_jax():
    """The port's loader builds the JAX loader's stand-ins: the valid
    split array for array, and every split's real sizes."""
    ported = tppi.load_ppi()
    assert [len(s) for s in ported[:3]] == [20, 2, 2]
    assert [sum(g.num_nodes for g in s) for s in ported[:3]] == [
        44906, 6514, 5524]
    valid, synth = jppi._load_split("valid", _search_roots(None))
    assert [p for p in ported.synthetic_parts if p.startswith("valid")] == synth
    for gt, gj in zip(ported.valid, valid):
        assert gt.num_nodes == gj.num_nodes
        for f in ("features", "labels", "senders", "receivers", "weights"):
            a, b = getattr(gt, f), getattr(gj, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_block_diag_and_make_batches_match_jax(data):
    """Shuffled batches field for field (the shuffle order included), on
    the batch bound of all splits, each batch's walks those of its own
    fields; block_diag's graph ids and member count."""
    jdata, tdata = data
    bounds = [tppi.batch_bounds(g, 2) for g in tdata[:3]]
    assert bounds == [jppi.batch_bounds(g, 2) for g in jdata[:3]]
    n_pad, e_pad = max(b[0] for b in bounds), max(b[1] for b in bounds)
    kw = dict(n_pad=n_pad, e_pad=e_pad, shuffle=True, seed=5)
    jb = list(jppi.make_batches(jdata.train, 2, **kw))
    tb = list(tppi.make_batches(tdata.train, 2, device="cpu", **kw))
    assert len(jb) == len(tb) == 2
    for pj, pt in zip(jb, tb):
        np.testing.assert_array_equal(pt.features.numpy(),
                                      np.asarray(pj.features))
        np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(pj.labels))
        for f in pj.batch.graph._fields:
            a, b = getattr(pt.batch.graph, f), getattr(pj.batch.graph, f)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        _assert_walk_is_built(pt.batch.graph)
    members = [(g.senders, g.receivers, g.weights, g.num_nodes)
               for g in tdata.valid]
    bt = tblock_diag(members, device="cpu")
    bj = jblock_diag(members)
    np.testing.assert_array_equal(bt.graph_ids.numpy(),
                                  np.asarray(bj.graph_ids))
    assert int(bt.n_graph) == int(bj.n_graph) == 2
    assert bt.graph_ids.device == bt.graph.senders.device


@pytest.fixture(scope="module")
def batch(data):
    """The first train batch, built by each package."""
    jdata, tdata = data
    n_pad, e_pad = jppi.batch_bounds(jdata.train, 2)
    pj = next(jppi.make_batches(jdata.train, 2, n_pad=n_pad, e_pad=e_pad))
    pt = next(tppi.make_batches(tdata.train, 2, n_pad=n_pad, e_pad=e_pad,
                                device="cpu"))
    return pj, pt


@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_apply_gat_on_a_ppi_batch_matches_jax(batch, layer_type):
    """Forward and parameter gradients of the 3-layer skip model on a
    block-diagonal batch, the JAX side on its fused Pallas path in
    interpret mode at 'high' precision."""
    pj, pt = batch
    cfg_j = jgat.GATConfig(layer_type=layer_type, **CFG)
    cfg_t = tgat.GATConfig(layer_type=layer_type, **CFG)
    jparams = jgat.init_gat(jax.random.PRNGKey(3), cfg_j)
    mask = np.array(pj.batch.graph.node_mask)

    def loss(p):
        with jseg.use_impl("stream"):
            out = jgat.apply_gat(p, cfg_j, pj.features, pj.batch.graph,
                                 jax.random.PRNGKey(1), train=False)
        return jnp.sum(jnp.where(mask[:, None], jnp.sin(out), 0.0)), out

    prev = jseg._STREAM_PRECISION
    jseg._STREAM_PRECISION = "high"
    try:
        (_, out_j), grads_j = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(jparams)
    finally:
        jseg._STREAM_PRECISION = prev

    tparams = params_from_jax(_numpy_params(jparams), device="cpu")
    out_t = tgat.apply_gat(tparams, cfg_t, pt.features, pt.batch.graph, None,
                           train=False)
    torch.where(torch.from_numpy(mask)[:, None], torch.sin(out_t),
                0.0).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy()[mask],
                               np.asarray(out_j)[mask], atol=2e-4, rtol=1e-4)
    gj_flat = np.asarray(ravel_pytree(grads_j)[0])
    gt_flat = torch.cat([p.grad.reshape(-1)
                         for p in tgat.parameters(tparams)]).numpy()
    scale = float(np.abs(gj_flat).max())
    np.testing.assert_allclose(gt_flat, gj_flat, atol=5e-5 * scale)


def test_fit_inductive_matches_jax(data, tmp_path):
    """Three epochs of the per-batch loop from the same parameters: the
    validation history within rtol 1e-4, the same best epoch, test micro-F1
    within 1e-3, and the checkpoints kept = {best, final}."""
    jdata, tdata = data
    cfg_j = jgat.GATConfig(layer_type="GAT_sparse", **CFG)
    cfg_t = tgat.GATConfig(layer_type="GAT_sparse", **CFG)
    jparams = jgat.init_gat(jax.random.PRNGKey(5), cfg_j)
    kw = dict(batch_size=2, lr=0.01, weight_decay=0.0, epochs=3, patience=3,
              seed=7, log_batches=False)
    res_j = jloop.fit_inductive(cfg_j, jdata, init_params=jparams,
                                checkpoint_dir=str(tmp_path / "jax"),
                                logger=_quiet(JLogger), **kw)
    res_t = fit_inductive(cfg_t, tdata,
                          init_params=params_from_jax(_numpy_params(jparams),
                                                      device="cpu"),
                          checkpoint_dir=str(tmp_path / "torch"),
                          logger=_quiet(), device="cpu", **kw)
    np.testing.assert_allclose(res_t.history, res_j.history, rtol=1e-4)
    assert res_t.best_epoch == res_j.best_epoch
    assert res_t.epochs_run == res_j.epochs_run == 3
    assert abs(res_t.test_acc - res_j.test_acc) <= 1e-3
    np.testing.assert_allclose(res_t.test_loss, res_j.test_loss, rtol=1e-4)
    kept = [e for e, _ in tckpt.list_checkpoints(str(tmp_path / "torch"),
                                                 "ppi")]
    assert kept == sorted({res_t.best_epoch, 2})
    assert kept == [e for e, _ in jckpt.list_checkpoints(
        str(tmp_path / "jax"), "ppi")]
