"""Training stack of the PyTorch port: checkpoint rotation, early stopping,
exact resume, and the CLI, mirroring tests/test_train.py and
tests/test_cli.py on the CPU."""

from __future__ import annotations

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from pygat_tpu_torch.data import synthetic
from pygat_tpu_torch.data.citation import CitationDataset
from pygat_tpu_torch.graph import build_graph
from pygat_tpu_torch.models.gat import GATConfig, init_gat
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.train.loop import fit_transductive
from pygat_tpu_torch.train.state import init_state, make_optimizer
from pygat_tpu_torch.utils.platform import make_generator, resolve_device


def _quiet():
    return TrainLogger(stream=open(os.devnull, "w"))


def _planted(n, classes, name, f_real, f_pad, degree, splits, density):
    s, r, labels = synthetic.planted_partition_graph(n, classes, name,
                                                     avg_degree=degree)
    s = np.concatenate([s, np.arange(n)])
    r = np.concatenate([r, np.arange(n)])
    g = build_graph(s, r, None, n, device="cpu")
    feats = synthetic.class_features(labels, f_real, name, density=density)
    n_pad = g.num_nodes_padded
    x = np.zeros((n_pad, f_pad), np.float32)
    x[:n, :f_real] = feats
    lab = np.full(n_pad, -1, np.int32)
    lab[:n] = labels
    tr, va, te = (torch.arange(a, b, dtype=torch.int32) for a, b in splits)
    return CitationDataset(
        graph=g, features=torch.from_numpy(x), labels=torch.from_numpy(lab),
        idx_train=tr, idx_val=va, idx_test=te, num_classes=classes,
        num_features=f_real, synthetic_parts=("all",))


def _tiny_state(seed=0):
    cfg = GATConfig(nlayers=1, nheads=(2,), nfeats=(3, 2), dropout=0.5,
                    alpha=0.2)
    params = init_gat(cfg, make_generator("cpu", seed), device="cpu")
    return init_state(params, make_optimizer(params, 0.01, 0.0),
                      make_generator("cpu", seed))


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    state = _tiny_state()
    d = str(tmp_path)
    for epoch in range(5):
        state.step = epoch
        ckpt.save(d, epoch, "cora", state)
    assert len(ckpt.list_checkpoints(d, "cora")) == 5
    assert all(p.endswith(f"{e}_cora.ckpt.npz")
               for e, p in ckpt.list_checkpoints(d, "cora"))

    ckpt.rotate_below_best(d, "cora", 2)
    assert [e for e, _ in ckpt.list_checkpoints(d, "cora")] == [2, 3, 4]
    ckpt.rotate_above_best(d, "cora", 2)
    assert [e for e, _ in ckpt.list_checkpoints(d, "cora")] == [2]

    fresh = _tiny_state(seed=1)
    restored, header = ckpt.restore(ckpt.best_path(d, "cora", 2), like=fresh)
    assert header["epoch"] == 2 and restored.step == 2
    for a, b in zip(restored.params[0], state.params[0]):
        if a is not None:
            torch.testing.assert_close(a, b)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    state = _tiny_state()
    ckpt.save(str(tmp_path), 0, "x", state)
    cfg = GATConfig(nlayers=1, nheads=(2,), nfeats=(4, 2), dropout=0.5,
                    alpha=0.2)
    params = init_gat(cfg, make_generator("cpu", 0), device="cpu")
    bad = init_state(params, make_optimizer(params, 0.01, 0.0),
                     make_generator("cpu", 0))
    with pytest.raises(ValueError):
        ckpt.restore(ckpt.best_path(str(tmp_path), "x", 0), like=bad)


def test_fit_transductive_learns_and_early_stops(tmp_path):
    """2-layer GAT on a small planted-partition graph fits the training
    signal and early-stops via the patience policy; rotation keeps the best
    checkpoint plus the final epoch."""
    data = _planted(300, 4, "unit", 32, 128, 10,
                    ((0, 150), (150, 220), (220, 300)), 0.15)
    cfg = GATConfig(nlayers=2, nheads=(4, 1), nfeats=(128, 8, 4), dropout=0.3,
                    alpha=0.2, layer_type="GAT_sparse")
    res = fit_transductive(
        cfg, data, lr=0.01, weight_decay=5e-4, epochs=120, patience=20,
        checkpoint_dir=str(tmp_path), dataset_tag="unit", logger=_quiet(),
        log_every=50,
    )
    assert res.test_acc > 0.6, f"model failed to learn: test_acc={res.test_acc}"
    assert res.epochs_run < 120, "patience never stopped the run"
    kept = [e for e, _ in ckpt.list_checkpoints(str(tmp_path), "unit")]
    assert kept == sorted({res.best_epoch, res.epochs_run - 1})


def test_resume_exactly_continues(tmp_path):
    """Interrupt after 4 epochs and resume: with dropout on, the loss history
    and the result match an uninterrupted run exactly (parameters, Adam
    moments and the dropout generator all restored)."""
    data = _planted(90, 3, "resume", 16, 16, 6,
                    ((0, 30), (30, 60), (60, 90)), 0.3)
    cfg = GATConfig(nlayers=2, nheads=(2, 1), nfeats=(16, 4, 3), dropout=0.4,
                    alpha=0.2, layer_type="GAT_sparse")
    kw = dict(lr=0.01, weight_decay=5e-4, patience=50, seed=7, logger=_quiet())
    ref = fit_transductive(cfg, data, epochs=10,
                           checkpoint_dir=str(tmp_path / "ref"), **kw)
    part = fit_transductive(cfg, data, epochs=4,
                            checkpoint_dir=str(tmp_path / "res"), **kw)
    resumed = fit_transductive(cfg, data, epochs=10,
                               checkpoint_dir=str(tmp_path / "res"),
                               resume=True, **kw)
    np.testing.assert_allclose(part.history + resumed.history, ref.history,
                               rtol=1e-6)
    assert resumed.best_epoch == ref.best_epoch
    assert resumed.test_acc == ref.test_acc


def test_train_cli_two_epochs_on_cpu(tmp_path):
    from pygat_tpu_torch.cli.train import main

    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(["--dataset", "cora", "--model", "GAT_sparse",
                   "--epochs", "2", "--no-cuda", "--no-checkpoint",
                   "--jsonl", str(tmp_path / "m.jsonl")])
    assert rc == 0
    text = out.getvalue()
    assert "start training on cpu" in text
    assert "Epoch: 0002 loss_train:" in text
    assert "Test set results: loss=" in text
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("flags", [
    ["--mesh", "2,2"], ["--partition", "ring", "--mesh", "2,1", "--model",
                        "GAT"], ["--distributed", "--model", "GATv2"],
    ["--reorder", "--mesh", "2,2"],
])
def test_train_cli_unported_flags_name_the_roadmap(flags):
    """The flags that once named a ROADMAP item (a model axis, the dense
    types under a mesh) are ported: without a launcher they stop where
    every mesh stops, at the missing process group."""
    from pygat_tpu_torch.cli.train import main

    with pytest.raises(SystemExit, match="needs a process group"):
        main(["--no-cuda", "--epochs", "1", "--no-checkpoint", *flags])


@pytest.mark.parametrize("flags", [
    ["--model", "GATv2"], ["--model", "GAT_sparse", "--backend", "xla"],
], ids=["GATv2", "xla"])
def test_train_cli_runs_the_flags_once_unported(flags, tmp_path,
                                                monkeypatch):
    """``--model GATv2`` (the dense layer) and ``--backend xla`` (the
    unfused branch over index_add_ sums), which raised before their port,
    train on the CPU: a small citation graph stands in for Cora."""
    from pygat_tpu_torch.cli import train as cli
    from pygat_tpu_torch.data import citation

    small = _planted(300, 7, "cli", 32, 64, 6,
                     ((0, 100), (100, 200), (200, 300)), 0.2)
    monkeypatch.setattr(citation, "load_citation",
                        lambda *a, **k: small)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["--dataset", "cora", "--epochs", "2", "--no-cuda",
                       "--no-checkpoint", "--jsonl",
                       str(tmp_path / "m.jsonl"), *flags])
    assert rc == 0
    assert "Epoch: 0002 loss_train:" in out.getvalue()
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_device_defaults_to_cuda_and_never_falls_back():
    assert resolve_device(cpu=True) == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--no-cuda"):
            resolve_device()


def _entry_point_calls():
    import scipy.sparse as sp

    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.graph import from_scipy
    from pygat_tpu_torch.models.convert import params_from_jax

    cfg = GATConfig(nlayers=1, nheads=(2,), nfeats=(3, 2), dropout=0.0,
                    alpha=0.2)
    w = np.zeros((2, 3, 2), np.float32)
    a = np.zeros((2, 4), np.float32)
    return {
        "load_citation": lambda: load_citation("cora"),
        "build_graph": lambda: build_graph(np.arange(5), np.arange(5), None, 5),
        "from_scipy": lambda: from_scipy(sp.eye(5, format="csr")),
        "init_gat": lambda: init_gat(cfg, make_generator("cpu", 0)),
        "params_from_jax": lambda: params_from_jax([(w, a, None)]),
    }


@pytest.mark.parametrize("entry", sorted(_entry_point_calls()))
def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(entry,
                                                            monkeypatch):
    """Without a device argument an entry point runs on CUDA; with no GPU
    it raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_point_calls()[entry]()


def test_train_cli_platform_flag_points_to_no_cuda():
    from pygat_tpu_torch.cli.train import main

    with pytest.raises(SystemExit, match="--no-cuda"):
        main(["--platform", "cpu", "--epochs", "1", "--no-checkpoint"])
