"""The PyTorch port's device-resident PPI bank and banked loop on the CPU:
the bank's batches against the JAX package's (field for field, with a dead
member) and their walks against ``build_stream_walk`` of the assembled
fields; the banked loop against the per-batch loop, at two chunk sizes and
across a resume; and the PPI CLI."""

from __future__ import annotations

import io
import json
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygat_tpu.data import ppi as jppi
from tests.torch_ppi_data import CFG, synth_ppi
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.cli import train_ppi
from pygat_tpu_torch.data import ppi as tppi
from pygat_tpu_torch.models.gat import GATConfig, parameters
from pygat_tpu_torch.ops.stream import build_stream_walk
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.inductive import fit_inductive, fit_inductive_banked
from pygat_tpu_torch.train.logging import TrainLogger


def _quiet():
    return TrainLogger(stream=open(os.devnull, "w"))


@pytest.fixture(scope="module")
def data():
    return (synth_ppi(jppi.PPIGraph, jppi.PPIData),
            synth_ppi(tppi.PPIGraph, tppi.PPIData))


@pytest.mark.parametrize("idx,live", [([3, 1], [True, True]),
                                      ([2, 0, 3], [True, True, False])],
                         ids=["b2", "b3_dead"])
def test_banked_batch_matches_jax_and_its_walks(data, idx, live):
    """build_bank + assemble_banked_batch field for field against the JAX
    package's, at batch sizes 2 and 3 (a dead member); the assembled walks
    equal build_stream_walk over the assembled fields on both stream
    sides."""
    jdata, tdata = data
    splits = [tdata.train, tdata.valid, tdata.test]
    n_pg, e_pg = tppi.bank_bounds(splits)
    assert (n_pg, e_pg) == jppi.bank_bounds(
        [jdata.train, jdata.valid, jdata.test])
    jbank = jppi.build_bank(jdata.train, n_pg, e_pg)
    tbank = tppi.build_bank(tdata.train, n_pg, e_pg, device="cpu")
    xj, gj, yj = jppi.assemble_banked_batch(
        jbank, jnp.asarray(idx, jnp.int32), jnp.asarray(live))
    xt, gt, yt = tppi.assemble_banked_batch(tbank, idx, live)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    for f in gj._fields:
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    n_tiles = gt.num_nodes_padded // 128
    for local, chunk, walk in ((gt.r_local, gt.r_chunk, gt.stream_walk),
                               (gt.c_local, gt.c_chunk, gt.sender_walk)):
        ref = build_stream_walk(local.numpy(), chunk.numpy(), n_tiles, "cpu")
        for f in ("row_ptr", "tile_ptr", "split_at"):
            assert torch.equal(getattr(walk, f), getattr(ref, f)), f
        assert walk.max_run == ref.max_run and walk.order is None
    # a member followed by another keeps its trailing all-dead chunks
    assert not torch.equal(tbank.stream_walks.tile_ptr,
                           tbank.stream_walks.tile_ptr_last)


def _banked_kw(**kw):
    return {**dict(batch_size=2, lr=0.01, weight_decay=0.0, seed=3,
                   logger=_quiet(), device="cpu"), **kw}


@pytest.fixture(scope="module")
def per_batch(data):
    """Four epochs of the per-batch loop (the banked loop's reference)."""
    cfg = GATConfig(layer_type="GAT_sparse", **CFG)
    return fit_inductive(cfg, data[1], epochs=4, patience=10,
                         log_batches=False, **_banked_kw())


def test_banked_loop_matches_per_batch_loop(data, per_batch):
    """Same seed, same batches (the host-drawn order): the validation
    history within rtol 1e-5, the same selection and test metrics."""
    cfg = GATConfig(layer_type="GAT_sparse", **CFG)
    res = fit_inductive_banked(cfg, data[1], epochs=4, patience=10,
                               epoch_chunk=4, **_banked_kw())
    np.testing.assert_allclose(res.history, per_batch.history, rtol=1e-5)
    assert res.best_epoch == per_batch.best_epoch
    assert res.epochs_run == 4
    np.testing.assert_allclose(res.test_loss, per_batch.test_loss, rtol=1e-5)
    assert abs(res.test_acc - per_batch.test_acc) <= 1e-4


def test_epoch_chunk_never_changes_selection(data):
    """epoch_chunk 1 and 4 under a patience stop that fires inside a chunk
    (the overshoot epochs never become the best): the same history up to
    the stop, the same best epoch and the same best parameters."""
    tdata = data[1]
    cfg = GATConfig(layer_type="GAT_sparse", **CFG)
    # at lr 0.5 the validation loss is best at epoch 3, the stop fires
    # after epoch 6, and epoch 7, an overshoot of the second chunk of 4,
    # would be better still
    kw = _banked_kw(lr=0.5)
    one, four = [fit_inductive_banked(cfg, tdata, epochs=8, patience=3,
                                      epoch_chunk=k, **kw) for k in (1, 4)]
    assert one.epochs_run == four.epochs_run == 7
    assert one.best_epoch == 3
    assert one.history == four.history
    assert one.best_epoch == four.best_epoch
    assert one.best_val_loss == four.best_val_loss
    for a, b in zip(parameters(one.state.params),
                    parameters(four.state.params)):
        assert torch.equal(a, b)


def test_banked_resume_continues_exactly(data, tmp_path):
    """Two epochs, then a resume to four, against four epochs straight:
    the same history, best epoch and parameters; the checkpoints keep the
    last chunk boundary and the best."""
    tdata = data[1]
    cfg = GATConfig(layer_type="GATv2_sparse", **CFG)
    kw = _banked_kw(patience=10, epoch_chunk=2)
    straight = fit_inductive_banked(cfg, tdata, epochs=4, **kw)
    d = str(tmp_path)
    first = fit_inductive_banked(cfg, tdata, epochs=2, checkpoint_dir=d, **kw)
    assert [e for e, _ in ckpt.list_checkpoints(d, "ppi")] == [1]
    assert [e for e, _ in ckpt.list_checkpoints(d, "ppi-best")] == [
        first.best_epoch]
    resumed = fit_inductive_banked(cfg, tdata, epochs=4, checkpoint_dir=d,
                                   resume=True, **kw)
    assert resumed.history[:2] == first.history
    np.testing.assert_allclose(resumed.history, straight.history, rtol=0)
    assert resumed.best_epoch == straight.best_epoch
    for a, b in zip(parameters(resumed.state.params),
                    parameters(straight.state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv,item", [
    (["--model", "GAT"], "item 10"),
    (["--model", "GATv2"], "item 10"),
    (["--model", "GAT_sparse", "--backend", "xla"], "item 10"),
    (["--model", "GAT_sparse", "--mesh", "2,1"], "item 14"),
    (["--model", "GAT_sparse", "--distributed"], "item 14"),
    (["--model", "GAT_sparse", "--platform", "cpu"], "no counterpart"),
], ids=["GAT", "GATv2", "xla", "mesh", "distributed", "platform"])
def test_cli_rejects_unported_flags(argv, item):
    """Flags whose machinery is not ported raise, naming what ports them;
    the default model (the dense GAT) among them."""
    with pytest.raises(SystemExit, match=item):
        train_ppi.main(argv + ["--no-cuda"])
    assert train_ppi.build_parser().parse_args([]).model == "GAT"


@pytest.mark.parametrize("scan", [False, True], ids=["per_batch", "banked"])
def test_cli_trains_on_the_cpu(monkeypatch, tmp_path, scan):
    """``--no-cuda`` runs the PPI preset's model (full width) on a tiny
    load_ppi (PPI's 50 features and 121 labels a node): the
    per-batch loop, or the banked loop with --epoch-scan; the JSONL holds
    finite losses and the test record."""
    tiny = synth_ppi(tppi.PPIGraph, tppi.PPIData, n_feat=50, n_labels=121)
    monkeypatch.setattr(tppi, "load_ppi", lambda data_root=None: tiny)
    jsonl = str(tmp_path / "log.jsonl")
    argv = ["--model", "GATv2_sparse", "--no-cuda", "--epochs", "2",
            "--checkpoint-dir", str(tmp_path / "ck"), "--jsonl", jsonl,
            "--log-every", "1"] + (["--epoch-scan"] if scan else [])
    text = io.StringIO()
    with redirect_stdout(text):
        assert train_ppi.main(argv) == 0
    out = text.getvalue()
    assert "start training on cpu" in out and "Optimization Finished!" in out
    assert "Kernel launches" not in out
    with open(jsonl) as fh:
        recs = [json.loads(line) for line in fh]
    epochs = [r for r in recs if r["kind"] == "ppi_epoch"]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["loss_train"]) and np.isfinite(r["loss_val"])
               for r in epochs)
    assert any(r["kind"] == "ppi_batch" for r in recs) != scan
    assert [r["kind"] for r in recs][-1] == "test"
    tags = {"ppi", "ppi-best"} if scan else {"ppi"}
    assert {t for t in tags if ckpt.list_checkpoints(str(tmp_path / "ck"), t)
            } == tags
