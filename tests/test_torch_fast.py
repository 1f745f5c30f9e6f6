"""``fit_transductive_fast`` of the PyTorch port on the CPU: the per-epoch
loop's history and a best model no worse, exact resume from a chunk
checkpoint, the on-device patience gate, ``--fastmode``, and the CLI's
``--epoch-chunk`` (mirrors the fast-loop cases of tests/test_train.py)."""

from __future__ import annotations

import io
import json
import os
from contextlib import redirect_stdout
from typing import NamedTuple

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data import synthetic
from pygat_tpu_torch.data.citation import CitationDataset
from pygat_tpu_torch.graph import build_graph
from pygat_tpu_torch.models.gat import GATConfig, parameters
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train import loop
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.train.loop import (
    ChunkedEpochs,
    fit_transductive,
    fit_transductive_fast,
)
from pygat_tpu_torch.train.state import TrainState
from pygat_tpu_torch.utils.platform import make_generator


def _quiet():
    return TrainLogger(stream=open(os.devnull, "w"))


def _planted(name, classes, f_real, f_pad, splits):
    """The 200-node planted-partition data of tests/test_train.py."""
    n = 200
    s, r, labels = synthetic.planted_partition_graph(n, classes, name,
                                                     avg_degree=8)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([r, np.arange(n)])
    g = build_graph(s, r, None, n, device="cpu")
    feats = synthetic.class_features(labels, f_real, name, density=0.2)
    x = np.zeros((g.num_nodes_padded, f_pad), np.float32)
    x[:n, :f_real] = feats
    lab = np.full(g.num_nodes_padded, -1, np.int32)
    lab[:n] = labels
    tr, va, te = (torch.arange(a, b, dtype=torch.int32) for a, b in splits)
    return CitationDataset(
        graph=g, features=torch.from_numpy(x), labels=torch.from_numpy(lab),
        idx_train=tr, idx_val=va, idx_test=te, num_classes=classes,
        num_features=f_real, synthetic_parts=("all",))


@pytest.fixture(scope="module")
def fastfit_data():
    return _planted("fastfit", 3, 16, 128, ((0, 100), (100, 150), (150, 200)))


@pytest.fixture(scope="module")
def resume_data():
    return _planted("fres", 4, 32, 64, ((0, 100), (120, 160), (160, 200)))


@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_fit_fast_matches_classic(fastfit_data, layer_type):
    """The chunked fit selects the same best model as the per-epoch loop
    (same seeds, same generator stream => identical epoch losses)."""
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type=layer_type)
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=40, patience=15, seed=7,
              checkpoint_dir=None, logger=_quiet(), log_every=100)
    a = fit_transductive(cfg, fastfit_data, **kw)
    b = fit_transductive_fast(cfg, fastfit_data, epoch_chunk=16, **kw)
    n = min(len(a.history), len(b.history))
    assert n >= 16
    np.testing.assert_allclose(a.history[:n], b.history[:n], rtol=1e-5)
    # the fast loop may find a strictly better val model in the patience
    # overshoot window, never a worse one
    assert b.best_val_loss <= a.best_val_loss + 1e-6
    if b.best_epoch == a.best_epoch:
        np.testing.assert_allclose(a.test_acc, b.test_acc, rtol=1e-5)
        # the returned state carries the best epoch's parameters
        for pa, pb in zip(parameters(a.state.params),
                          parameters(b.state.params)):
            torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-7)
    # eager on the CPU: nothing captured, nothing replayed
    assert b.graph_replays == 0 and b.captured_launches == {}
    assert b.state.step % 16 == 0  # whole chunks ran


@pytest.mark.parametrize("layer_type", ["GAT_sparse", "GATv2_sparse"])
def test_fast_loop_resume_exactly_continues(tmp_path, resume_data, layer_type):
    """A run interrupted at a chunk boundary then resumed reproduces the
    uninterrupted run's history exactly (parameters, Adam moments, the
    dropout generator, the history and the best model all restored)."""
    cfg = GATConfig(nlayers=2, nheads=(3, 1), nfeats=(64, 8, 4), dropout=0.4,
                    alpha=0.2, layer_type=layer_type)
    kw = dict(lr=0.01, weight_decay=5e-4, patience=100, seed=72,
              epoch_chunk=3, log_every=100, logger=_quiet(), dataset_tag="u")
    full = fit_transductive_fast(cfg, resume_data, epochs=12,
                                 checkpoint_dir=str(tmp_path / "full"), **kw)
    part_dir = str(tmp_path / "part")
    fit_transductive_fast(cfg, resume_data, epochs=6, checkpoint_dir=part_dir,
                          **kw)
    # a chunk-boundary run keeps the newest checkpoint and one best file
    assert [e for e, _ in ckpt.list_checkpoints(part_dir, "u")] == [5]
    assert len(ckpt.list_checkpoints(part_dir, "u-best")) == 1
    res = fit_transductive_fast(cfg, resume_data, epochs=12,
                                checkpoint_dir=part_dir, resume=True, **kw)
    np.testing.assert_allclose(res.history, full.history, rtol=1e-5, atol=1e-6)
    assert res.best_epoch == full.best_epoch
    assert res.best_val_loss == pytest.approx(full.best_val_loss, rel=1e-6)
    np.testing.assert_allclose(res.test_acc, full.test_acc, rtol=1e-5)
    for pa, pb in zip(parameters(res.state.params),
                      parameters(full.state.params)):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-7)


class _P(NamedTuple):
    p: torch.Tensor


def test_chunked_best_tracking_respects_patience_stop(monkeypatch):
    """On-device patience gate: epochs that run inside a chunk AFTER the
    host's early stop would have fired must never update the best model,
    even when their val loss dips below the pre-stop best. Driven through a
    scripted model forward: a scalar parameter with (numerically) constant
    gradient makes the epoch index recoverable on the device, and the
    scripted val-loss sequence dips hard right after the stop point."""
    # val-logit script z[t]: val loss = log(1 + e^-z) falls as z grows.
    # Epoch e evaluates AFTER its update, so it reads z[e + 1]: improvement
    # at e = 1, none at e = 2, 3 (a host with patience 2 stops after e = 3),
    # then a dip that only overshoot epochs see.
    z = torch.tensor([0.0, 1.0, 2.0, 1.5, 1.2, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0])
    k_epochs = 10
    # Train node 0 has label 1 and logits [p, 0]: loss = log(1 + e^p) ~ p
    # for p >= 20, so SGD(1.0) walks p down by exactly 1.0 per epoch.
    p0 = 30.0

    def scripted(params, cfg, x, graph, gen, train, plans):
        assert plans is None  # no band plan below the threshold
        p = params[0].p
        t = (p0 - p.detach()).round().long().clamp(0, z.shape[0] - 1)
        zero = p.new_zeros(())
        rows = torch.stack([torch.stack([p, zero]), torch.stack([z[t], zero])])
        return torch.cat([rows, p.new_zeros(6, 2)])

    monkeypatch.setattr(loop, "apply_gat", scripted)
    cfg = GATConfig(nlayers=1, nheads=(1,), nfeats=(2, 2), dropout=0.0,
                    alpha=0.2, layer_type="GAT_sparse")
    params = [_P(torch.tensor(p0, requires_grad=True))]
    state = TrainState(step=0, params=params,
                       optimizer=torch.optim.SGD(parameters(params), lr=1.0),
                       generator=make_generator("cpu", 0))
    g = build_graph(np.arange(8), np.arange(8), None, 8, device="cpu")
    labels = torch.zeros(g.num_nodes_padded, dtype=torch.int32)
    labels[0] = 1
    chunk = ChunkedEpochs(
        cfg, state, torch.zeros(g.num_nodes_padded, 2), g, labels,
        torch.tensor([0]), torch.tensor([1]), n_epochs=k_epochs,
        max_epochs=k_epochs, patience=2)
    vals = np.asarray(chunk.run()[2])
    # the scripted dip is real: the full chunk's argmin is past the stop
    host_stop = next(e for e in range(k_epochs)
                     if e - int(np.argmin(vals[: e + 1])) >= 2)
    assert host_stop == 3
    assert int(np.argmin(vals)) >= 4 > host_stop
    # ...but the device selected the host-visible best (epoch 1)
    assert int(chunk.best_epoch) == int(np.argmin(vals[: host_stop + 1])) == 1
    np.testing.assert_allclose(float(chunk.best_val), vals[1], rtol=0)
    # best params are epoch 1's post-update params: p0 - 2 steps of 1.0
    np.testing.assert_allclose(float(chunk.best_params[0].p), p0 - 2.0, rtol=0)
    assert state.step == k_epochs

    # without the gate the overshoot epoch wins; past max_epochs nothing does
    for patience, max_epochs, want in ((None, k_epochs, int(np.argmin(vals))),
                                       (None, 1, 0)):
        with torch.no_grad():
            params[0].p.fill_(p0)
        state.step = 0
        free = ChunkedEpochs(
            cfg, state, torch.zeros(g.num_nodes_padded, 2), g, labels,
            torch.tensor([0]), torch.tensor([1]), n_epochs=k_epochs,
            max_epochs=max_epochs, patience=patience)
        free.run()
        assert int(free.best_epoch) == want


def test_fit_fast_patience_stops_at_the_host_policy(fastfit_data):
    """The host applies the patience policy over the whole history at chunk
    ends: the run stops at the epoch the per-epoch loop stops at, though the
    device ran the chunk to its end."""
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3), dropout=0.0,
                    alpha=0.2, layer_type="GATv2_sparse")
    kw = dict(lr=0.05, weight_decay=0.0, epochs=200, patience=3, seed=1,
              checkpoint_dir=None, logger=_quiet(), log_every=1000)
    a = fit_transductive(cfg, fastfit_data, **kw)
    b = fit_transductive_fast(cfg, fastfit_data, epoch_chunk=7, **kw)
    assert a.epochs_run < 200, "patience never stopped the per-epoch run"
    assert b.epochs_run == a.epochs_run
    assert b.best_epoch == a.best_epoch
    np.testing.assert_allclose(b.history, a.history, rtol=1e-5)
    np.testing.assert_allclose(b.best_val_loss, a.best_val_loss, rtol=1e-5)
    assert b.state.step >= b.epochs_run and b.state.step % 7 == 0


def test_fit_fast_fastmode_validates_on_the_training_forward(fastfit_data):
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type="GATv2_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, epochs=6, patience=50, seed=3,
              checkpoint_dir=None, logger=_quiet(), fastmode=True)
    a = fit_transductive(cfg, fastfit_data, **kw)
    b = fit_transductive_fast(cfg, fastfit_data, epoch_chunk=3, **kw)
    np.testing.assert_allclose(b.history, a.history, rtol=1e-5)
    assert b.best_epoch == a.best_epoch


def test_epoch_runners_time_the_same_epochs(fastfit_data):
    """The set-up the GPU timing scripts share: both runners start from the
    same seeds, so the chunk's epochs are the per-epoch loop's."""
    from pygat_tpu_torch.tools.profile_epoch import epoch_runners

    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 8, 3), dropout=0.4,
                    alpha=0.2, layer_type="GATv2_sparse")
    epoch, chunk = epoch_runners(cfg, fastfit_data, 3)
    vals = [float(epoch()) for _ in range(3)]
    np.testing.assert_allclose(chunk.run()[2], vals, rtol=1e-5)
    assert chunk.graph_replays == 0 and chunk.state.step == 3


def test_v2_state_checkpoint_roundtrip(tmp_path, fastfit_data):
    """A V2Params state saves, restores and resumes through the per-epoch
    loop; restore_params loads the parameters alone."""
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(128, 4, 3), dropout=0.4,
                    alpha=0.2, layer_type="GATv2_sparse", skip_connection=True)
    kw = dict(lr=0.01, weight_decay=5e-4, patience=50, seed=7,
              logger=_quiet())
    ref = fit_transductive(cfg, fastfit_data, epochs=6,
                           checkpoint_dir=str(tmp_path / "ref"), **kw)
    part = fit_transductive(cfg, fastfit_data, epochs=3,
                            checkpoint_dir=str(tmp_path / "res"), **kw)
    resumed = fit_transductive(cfg, fastfit_data, epochs=6,
                               checkpoint_dir=str(tmp_path / "res"),
                               resume=True, **kw)
    np.testing.assert_allclose(part.history + resumed.history, ref.history,
                               rtol=1e-6)
    assert resumed.best_epoch == ref.best_epoch
    # restore_params loads the parameters alone, into another state's set
    _, path = ckpt.latest(str(tmp_path / "ref"), "cora")
    gen_before = part.state.generator.get_state()
    with torch.no_grad():
        for p in parameters(part.state.params):
            p.zero_()
    ckpt.restore_params(path, into=part.state.params)
    saved, _ = ckpt.restore(path, like=ref.state)
    for pa, pb in zip(parameters(part.state.params), parameters(saved.params)):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert torch.equal(part.state.generator.get_state(), gen_before)


def test_train_cli_v2_epoch_chunk_on_cpu(tmp_path):
    from pygat_tpu_torch.cli.train import main

    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(["--dataset", "cora", "--model", "GATv2_sparse",
                   "--epoch-chunk", "2", "--epochs", "4", "--no-cuda",
                   "--log-every", "1", "--checkpoint-dir", str(tmp_path),
                   "--jsonl", str(tmp_path / "m.jsonl")])
    assert rc == 0
    text = out.getvalue()
    assert "start training on cpu" in text
    assert "Epoch: 0004 loss_train:" in text
    assert "Test set results: loss=" in text
    assert "CUDA graph replays" not in text
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert [e for e, _ in ckpt.list_checkpoints(str(tmp_path), "cora")] == [3]
    assert len(ckpt.list_checkpoints(str(tmp_path), "cora-best")) == 1
