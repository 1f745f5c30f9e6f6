"""Transductive training loop with the reference's early-stop and
checkpoint-rotation policy (port of ``make_transductive_steps`` and
``fit_transductive`` from ``pygat_tpu/train/loop.py``; train.py:191-236).

PyTorch runs eagerly, so a train step is a forward, a backward and an Adam
update run op by op; there is no mesh and no ring. The JAX package's
large-N plan (``maybe_plan_large``) returns None below 300k nodes, which
covers every citation dataset, so the port plans nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import torch

from pygat_tpu_torch.data.citation import CitationDataset
from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.train.metrics import accuracy, log_logits, nll_loss
from pygat_tpu_torch.train.state import TrainState, init_state, make_optimizer
from pygat_tpu_torch.utils.platform import make_generator


def make_transductive_steps(cfg: GATConfig):
    """(train_step, eval_step).

    ``train_step(state, x, graph, labels, idx) -> (state, loss, acc, out)``
    runs forward with dropout, backward and one Adam update, in place;
    ``eval_step(params, x, graph, labels, idx) -> (loss, acc, out)`` runs the
    forward without dropout or autograd. Losses and accuracies are 0-dim
    tensors on the data's device.
    """

    def _loss(params, x, graph, labels, idx, gen, train):
        out = apply_gat(params, cfg, x, graph, gen, train=train)
        lp = log_logits(out)
        loss = nll_loss(lp[idx], labels[idx])
        acc = accuracy(lp[idx], labels[idx])
        return loss, acc, out

    def train_step(state: TrainState, x, graph: Graph, labels, idx):
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc, out = _loss(state.params, x, graph, labels, idx,
                               state.generator, True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), acc, out.detach()

    @torch.no_grad()
    def eval_step(params, x, graph: Graph, labels, idx):
        return _loss(params, x, graph, labels, idx, None, False)

    return train_step, eval_step


@dataclass
class FitResult:
    best_epoch: int
    best_val_loss: float
    test_loss: float
    test_acc: float
    epochs_run: int
    state: Any
    history: list = field(default_factory=list)


def fit_transductive(
    cfg: GATConfig,
    data: CitationDataset,
    *,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    fastmode: bool = False,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "cora",
    logger: TrainLogger | None = None,
    log_every: int = 1,
    init_params: Any = None,
    resume: bool = False,
) -> FitResult:
    """Reference policy: track best val loss, patience counter, save every
    epoch, rotate non-best, restore best, test (train.py:191-236).

    Runs on the device of ``data``. Parameters are drawn from a CPU
    generator seeded with ``seed`` (the same initial weights on every
    device); dropout draws from a generator on the data's device seeded
    with ``seed + 1``.

    ``resume=True``: restore the newest checkpoint under ``checkpoint_dir``
    (parameters, Adam moments, generator state) and continue the epoch
    count / best-val / patience bookkeeping from its header.
    """
    logger = logger or TrainLogger()
    device = data.features.device
    if init_params is not None:
        params = init_params
    else:
        params = init_gat(cfg, make_generator("cpu", seed), device=device)
    state = init_state(params, make_optimizer(params, lr, weight_decay),
                       make_generator(device, seed + 1))

    start_epoch = 0
    resumed_best = None
    if resume and checkpoint_dir:
        found = ckpt.latest(checkpoint_dir, dataset_tag)
        if found is not None:
            _, path = found
            state, header = ckpt.restore(path, like=state)
            start_epoch = header["epoch"] + 1
            resumed_best = header
            logger.log("resume", epoch=header["epoch"],
                       best=header.get("best"), path=path,
                       from_best=(header["epoch"] == header.get("best_epoch")))
    train_step, eval_step = make_transductive_steps(cfg)

    x, g, labels = data.features, data.graph, data.labels

    best = float("inf")
    best_epoch = 0
    bad_counter = 0
    if resumed_best is not None and resumed_best.get("best") is not None:
        best = float(resumed_best["best"])
        best_epoch = int(resumed_best.get("best_epoch", start_epoch - 1))
        bad_counter = int(resumed_best.get("bad", 0))
    history = []
    epoch = start_epoch - 1

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        state, loss_tr, acc_tr, out_tr = train_step(state, x, g, labels, data.idx_train)
        if fastmode:
            # reference fastmode: reuse the training-forward output for val
            lp = log_logits(out_tr)
            loss_val = nll_loss(lp[data.idx_val], labels[data.idx_val])
            acc_val = accuracy(lp[data.idx_val], labels[data.idx_val])
        else:
            loss_val, acc_val, _ = eval_step(state.params, x, g, labels, data.idx_val)

        loss_val = float(loss_val)
        if epoch % log_every == 0 or epoch == epochs - 1:
            logger.log(
                "epoch",
                epoch=epoch,
                loss_train=float(loss_tr),
                acc_train=float(acc_tr),
                loss_val=loss_val,
                acc_val=float(acc_val),
                time=time.time() - t0,
            )
        history.append(loss_val)

        if loss_val < best:
            best = loss_val
            best_epoch = epoch
            bad_counter = 0
        else:
            bad_counter += 1
        if checkpoint_dir:
            ckpt.save(checkpoint_dir, epoch, dataset_tag, state,
                      extra={"best": best, "best_epoch": best_epoch,
                             "bad": bad_counter})
        # >= (not ==): a resumed patience-stopped run restores bad_counter
        # already at the limit and must stop again, not train past it
        if bad_counter >= patience:
            break
        if checkpoint_dir:
            ckpt.rotate_below_best(checkpoint_dir, dataset_tag, best_epoch)

    if checkpoint_dir:
        # keep the final-epoch checkpoint too: resume then continues from
        # where the run stopped instead of replaying post-best epochs
        ckpt.rotate_above_best(checkpoint_dir, dataset_tag, best_epoch,
                               keep_epoch=epoch)
        state, _ = ckpt.restore(
            ckpt.best_path(checkpoint_dir, dataset_tag, best_epoch), like=state
        )

    test_loss, test_acc, _ = eval_step(state.params, x, g, labels, data.idx_test)
    logger.log("test", loss=float(test_loss), accuracy=float(test_acc))
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=best,
        test_loss=float(test_loss),
        test_acc=float(test_acc),
        epochs_run=epoch + 1,
        state=state,
        history=history,
    )
