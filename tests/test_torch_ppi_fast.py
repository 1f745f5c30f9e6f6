"""The port's stacked PPI loop, ``fit_inductive_fast``, on the CPU: its
stacked batches against the JAX package's ``stack_batches`` (leaf for leaf,
with each batch's walks), and the loop against the JAX
``fit_inductive_fast`` and the port's ``fit_inductive`` from the same
parameters on the tiny data of ``tests/test_ppi.py`` (history within 2e-4,
the same best epoch, test accuracy), its records and its checkpoints; a
mesh with a model axis raises."""

from __future__ import annotations

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from pygat_tpu.data import ppi as jppi
from pygat_tpu.models import gat as jgat
from pygat_tpu.train import loop as jloop
from pygat_tpu.train.logging import TrainLogger as JLogger
from tests.torch_ppi_data import synth_ppi
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data import ppi as tppi
from pygat_tpu_torch.models import gat as tgat
from pygat_tpu_torch.models.convert import params_from_jax
from pygat_tpu_torch.ops.stream import build_stream_walk
from pygat_tpu_torch.parallel.mesh import Mesh
from pygat_tpu_torch.train import checkpoint as tckpt
from pygat_tpu_torch.train.inductive import (
    fit_inductive,
    fit_inductive_fast,
    stack_batches,
)
from pygat_tpu_torch.train.logging import TrainLogger

# the model of tests/test_ppi.py::test_inductive_fast_matches_classic
CFG = dict(nlayers=2, nheads=(2, 2), nfeats=(128, 16, 6), dropout=0.0,
           alpha=0.2, skip_connection=True)
KW = dict(batch_size=2, lr=0.01, weight_decay=0.0, epochs=8, patience=8)


def _quiet(cls=TrainLogger):
    return cls(stream=open(os.devnull, "w"))


def _numpy_params(jparams):
    return [tuple(None if t is None else np.asarray(t) for t in p)
            for p in jparams]


@pytest.fixture(scope="module")
def data():
    return (synth_ppi(jppi.PPIGraph, jppi.PPIData),
            synth_ppi(tppi.PPIGraph, tppi.PPIData))


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX fast loop, and the port's fast and per-batch loops, from the
    same parameters, 8 epochs; the port's fast loop with checkpoints and
    its log."""
    jdata, tdata = data
    cfg_j = jgat.GATConfig(layer_type="GAT_sparse", **CFG)
    cfg_t = tgat.GATConfig(layer_type="GAT_sparse", **CFG)
    jparams = jgat.init_gat(jax.random.PRNGKey(5), cfg_j)

    def params():
        return params_from_jax(_numpy_params(jparams), device="cpu")

    res_j = jloop.fit_inductive_fast(cfg_j, jdata, init_params=jparams,
                                     logger=_quiet(JLogger), **KW)
    ckpt_dir = str(tmp_path_factory.mktemp("fast"))
    log = io.StringIO()
    jsonl = os.path.join(ckpt_dir, "m.jsonl")
    fast = fit_inductive_fast(cfg_t, tdata, init_params=params(),
                              checkpoint_dir=ckpt_dir,
                              logger=TrainLogger(stream=log, jsonl_path=jsonl),
                              device="cpu", **KW)
    per_batch = fit_inductive(cfg_t, tdata, init_params=params(),
                              log_batches=False, logger=_quiet(),
                              device="cpu", **KW)
    return dict(jax=res_j, fast=fast, per_batch=per_batch, dir=ckpt_dir,
                jsonl=jsonl)


@pytest.mark.parametrize("other", ["jax", "per_batch"])
def test_fast_loop_matches(runs, other):
    """History within rtol 2e-4, the same best epoch, the test metrics."""
    fast, ref = runs["fast"], runs[other]
    assert fast.epochs_run == ref.epochs_run == KW["epochs"]
    np.testing.assert_allclose(fast.history, ref.history, rtol=2e-4)
    assert fast.best_epoch == ref.best_epoch
    np.testing.assert_allclose(fast.test_acc, ref.test_acc, atol=2e-3)
    np.testing.assert_allclose(fast.test_loss, ref.test_loss, rtol=2e-4)


def test_fast_loop_records_and_checkpoints(runs):
    """One ppi_epoch record an epoch (no per-batch records) with finite
    means, a test record; the checkpoints kept are the best and the final
    epoch, and the returned state is the best one."""
    fast = runs["fast"]
    with open(runs["jsonl"]) as fh:
        recs = [json.loads(line) for line in fh]
    epochs = [r for r in recs if r["kind"] == "ppi_epoch"]
    assert [r["epoch"] for r in epochs] == list(range(KW["epochs"]))
    assert not [r for r in recs if r["kind"] == "ppi_batch"]
    assert [r["loss_val"] for r in epochs] == fast.history
    for r in epochs:
        assert all(np.isfinite(r[k]) for k in ("loss_train", "f1_train",
                                               "loss_val", "f1_val"))
    assert [r for r in recs if r["kind"] == "test"][0]["loss"] == \
        fast.test_loss
    kept = [e for e, _ in tckpt.list_checkpoints(runs["dir"], "ppi")]
    assert kept == sorted({fast.best_epoch, KW["epochs"] - 1})


@pytest.mark.parametrize("shuffle", [False, True])
def test_stack_batches_matches_jax(data, shuffle):
    """The port's stacked batches leaf for leaf against the JAX package's,
    at one static shape over the three splits; each batch's view carries
    the walks of its own fields."""
    jdata, tdata = data
    bounds = [tppi.batch_bounds(s, 2)
              for s in (tdata.train, tdata.valid, tdata.test)]
    n_pad, e_pad = max(b[0] for b in bounds), max(b[1] for b in bounds)
    kw = dict(n_pad=n_pad, e_pad=e_pad, shuffle=shuffle, seed=11)
    xs, gs, ys = jloop.stack_batches(list(jppi.make_batches(
        jdata.train, 2, **kw)))
    st = stack_batches(list(tppi.make_batches(tdata.train, 2, device="cpu",
                                              **kw)))
    assert st.n_batches == 2
    np.testing.assert_array_equal(st.features.numpy(), np.asarray(xs))
    np.testing.assert_array_equal(st.labels.numpy(), np.asarray(ys))
    for f in gs._fields:
        a, b = getattr(gs, f), getattr(st.graph, f)
        if a is None:
            assert b is None, f
            continue
        assert np.asarray(a).dtype == b.numpy().dtype, f
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    for i in range(st.n_batches):
        x, g, y = st.batch(i)
        assert torch.equal(x, st.features[i]) and torch.equal(y, st.labels[i])
        n_tiles = g.num_nodes_padded // 128
        for local, chunk, walk in ((g.r_local, g.r_chunk, g.stream_walk),
                                   (g.c_local, g.c_chunk, g.sender_walk)):
            ref = build_stream_walk(local.numpy(), chunk.numpy(), n_tiles,
                                    "cpu")
            for f in ("row_ptr", "tile_ptr", "split_at"):
                assert torch.equal(getattr(walk, f), getattr(ref, f)), f
            assert walk.max_run == ref.max_run and walk.order is None


def test_model_axis_raises(data):
    """A mesh with a model axis but no process group behind it (one that
    ``make_mesh`` did not build) raises at the first split layer: its heads
    could not be combined."""
    mesh = Mesh(n_data=1, n_model=2, rank=0, world_size=2,
                device=torch.device("cpu"))
    cfg = tgat.GATConfig(layer_type="GAT_sparse", **CFG)
    with pytest.raises(ValueError, match="no model group"):
        fit_inductive_fast(cfg, data[1], mesh=mesh, logger=_quiet(), **KW)
