"""Transductive training loops with the reference's early-stop and
checkpoint-rotation policy (port of ``make_transductive_steps``,
``fit_transductive``, ``make_scanned_epochs_with_best`` and
``fit_transductive_fast`` from ``pygat_tpu/train/loop.py``;
train.py:191-236).

PyTorch runs eagerly, so in :func:`fit_transductive` a train step is a
forward, a backward and an Adam update run op by op, and the host reads the
validation loss every epoch. :func:`fit_transductive_fast` syncs with the
host once per chunk of epochs: :class:`ChunkedEpochs` keeps the per-epoch
metrics and the best model on the device and, on CUDA, captures one epoch
in a CUDA graph and replays it (what ``lax.scan`` under ``jit`` gives the
JAX package). There is no mesh and no ring. Both loops ask
:func:`~pygat_tpu_torch.ops.banded.maybe_plan_large` for a large-N plan, as
the JAX package's do: past 300k padded nodes (or with ``PYGAT_BAND=on``)
it returns a band plan, and every layer then runs over the banded order;
with ``PYGAT_CORNER=on`` / ``set_corner("on")`` (and no band plan) it
returns the corner plans, and every layer builds its sender windows by
expand and corner-turn; otherwise (the citation datasets) it returns None.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pygat_tpu_torch.data.citation import CitationDataset
from pygat_tpu_torch.graph import Graph
from pygat_tpu_torch.models.gat import (
    GATConfig,
    apply_gat,
    init_gat,
    parameters,
)
from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.banded import BandPlan, maybe_plan_large
from pygat_tpu_torch.ops.large import CscCsrPlans
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.train.metrics import accuracy, log_logits, nll_loss
from pygat_tpu_torch.train.state import (
    TrainState,
    init_state,
    make_optimizer,
    tensor_leaves,
)
from pygat_tpu_torch.utils.platform import make_generator


def _make_loss(cfg: GATConfig, plans: BandPlan | CscCsrPlans | None = None):
    """``loss(params, x, graph, labels, idx, gen, train) -> (loss, acc,
    out)``."""

    def _loss(params, x, graph, labels, idx, gen, train):
        out = apply_gat(params, cfg, x, graph, gen, train=train, plans=plans)
        lp = log_logits(out)
        loss = nll_loss(lp[idx], labels[idx])
        acc = accuracy(lp[idx], labels[idx])
        return loss, acc, out

    return _loss


def make_transductive_steps(cfg: GATConfig,
                            plans: BandPlan | CscCsrPlans | None = None):
    """(train_step, eval_step), over the large-N plan ``plans`` (a band
    plan or the corner plans) when one is given.

    ``train_step(state, x, graph, labels, idx) -> (state, loss, acc, out)``
    runs forward with dropout, backward and one Adam update, in place;
    ``eval_step(params, x, graph, labels, idx) -> (loss, acc, out)`` runs the
    forward without dropout or autograd. Losses and accuracies are 0-dim
    tensors on the data's device.
    """

    _loss = _make_loss(cfg, plans)

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


def _plan_large(data: CitationDataset, logger: TrainLogger):
    """The trainers' large-N plan for ``data.graph``, logged when there is
    one."""
    plans = maybe_plan_large(data.graph)
    if isinstance(plans, BandPlan):
        logger.log("band_plan", w=plans.w, chunks=plans.num_chunks,
                   slots=plans.num_slots, fill=plans.fill)
    elif plans is not None:
        fwd, inv = plans
        logger.log("corner_plan", rows=fwd.n_rows,
                   passes=[len(fwd.passes), len(inv.passes)],
                   p=[[cp.p for cp in pl.passes] for pl in plans],
                   overflow=[fwd.overflow_total, inv.overflow_total])
    return plans


@dataclass
class FitResult:
    best_epoch: int
    best_val_loss: float
    test_loss: float
    test_acc: float
    epochs_run: int
    state: Any
    history: list = field(default_factory=list)
    # fit_transductive_fast on CUDA: replays of the captured epoch, and the
    # kernel launches one replay holds, by kernel name (else 0 and empty)
    graph_replays: int = 0
    captured_launches: dict = field(default_factory=dict)


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
    plans = _plan_large(data, logger)
    train_step, eval_step = make_transductive_steps(cfg, plans)

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


class ChunkedEpochs:
    """``n_epochs`` full epochs (train step, validation, best-model
    tracking) per :meth:`run`, with no host sync inside the chunk: the
    counterpart of ``make_scanned_epochs_with_best``.

    Everything an epoch reads or writes lives in device tensors that keep
    their address: the state (updated in place), the per-epoch metrics
    ``[4, n_epochs]`` (train loss, train accuracy, validation loss,
    validation accuracy), the epoch counter, and the best validation loss,
    its epoch and a copy of its parameters, updated with ``torch.where``
    under the reference's gate: an epoch past ``max_epochs`` never becomes
    the best, and with ``patience`` neither does an epoch that runs after
    the host's early stop would have fired (the chunk's overshoot), so the
    selected model is one the per-epoch policy could reach.

    On a CUDA device the epoch is captured once in a CUDA graph (after one
    warm-up epoch on a side stream whose effects are undone) and replayed;
    the optimizer must then be capturable and the dropout generator is
    registered with the graph. A replay launches the kernels without
    passing through their Python wrappers, whose counters it leaves alone:
    ``captured_launches`` holds what one replay launches, by kernel name
    (the wrapper calls the capture recorded), and ``graph_replays`` counts
    the replays. On the CPU the epochs run eagerly.
    """

    def __init__(self, cfg: GATConfig, state: TrainState, x, graph: Graph,
                 labels, idx_train, idx_val, *, n_epochs: int, max_epochs: int,
                 patience: int | None = None, fastmode: bool = False,
                 plans: BandPlan | CscCsrPlans | None = None):
        dev = x.device
        self.state = state
        self.n_epochs = n_epochs
        self._args = (x, graph, labels, idx_train, idx_val)
        self._loss = _make_loss(cfg, plans)
        self._max_epochs = max_epochs
        self._patience = patience
        self._fastmode = fastmode
        self.best_val = torch.full((), float("inf"), device=dev)
        self.best_epoch = torch.full((), -1, dtype=torch.int64, device=dev)
        self.best_params = [
            type(p)(*(None if t is None else t.detach().clone() for t in p))
            for p in state.params]
        self._step = torch.full((), state.step, dtype=torch.int64, device=dev)
        self._metrics = torch.zeros(4, n_epochs, device=dev)
        self._slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self._graph = None
        self.captured_launches: dict[str, int] = {}
        self.graph_replays = 0

    def _epoch(self) -> None:
        state = self.state
        x, graph, labels, idx_train, idx_val = self._args
        state.optimizer.zero_grad(set_to_none=True)
        loss_tr, acc_tr, out = self._loss(state.params, x, graph, labels,
                                          idx_train, state.generator, True)
        loss_tr.backward()
        state.optimizer.step()
        self._step += 1
        with torch.no_grad():
            if self._fastmode:
                # reference fastmode: reuse the training-forward output
                lp = log_logits(out.detach())
                loss_val = nll_loss(lp[idx_val], labels[idx_val])
                acc_val = accuracy(lp[idx_val], labels[idx_val])
            else:
                loss_val, acc_val, _ = self._loss(
                    state.params, x, graph, labels, idx_val, None, False)
            # this epoch's index is step - 1; epochs past the budget never
            # update the best model
            improved = (loss_val < self.best_val) & (
                self._step - 1 < self._max_epochs)
            if self._patience is not None:
                # the host stops after epoch e once e - best_epoch >=
                # patience, so gate on the previous epoch (the one the host
                # checked); best_epoch freezes once gated
                improved &= (self._step - 2 - self.best_epoch) < self._patience
            self.best_val.copy_(torch.where(improved, loss_val, self.best_val))
            self.best_epoch.copy_(
                torch.where(improved, self._step - 1, self.best_epoch))
            for best, new in zip(parameters(self.best_params),
                                 parameters(state.params)):
                best.copy_(torch.where(improved, new, best))
            row = torch.stack([loss_tr.detach(), acc_tr, loss_val, acc_val])
            self._metrics.index_copy_(1, self._slot, row[:, None])
            self._slot += 1

    def _capture(self) -> None:
        state = self.state
        carry = (tensor_leaves(state) + parameters(self.best_params)
                 + [self.best_val, self.best_epoch, self._step, self._slot])
        # detached copies: a clone that tracks gradients would keep the
        # parameters' AccumulateGrad nodes alive on this stream, and the
        # captured backward would then sync with it and break the capture
        saved = [t.detach().clone() for t in carry]
        gen_state = state.generator.get_state()
        # one eager epoch on a side stream builds and loads the kernels and
        # settles the allocator and the library workspaces; then undo it
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._epoch()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, old in zip(carry, saved):
                t.copy_(old)
        del saved
        state.generator.set_state(gen_state)
        before = build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        with torch.cuda.graph(graph):
            self._epoch()
        # the wrapper calls of the capture: recorded, run at every replay
        self.captured_launches = {
            name: n - before[name]
            for name, n in build.launch_counts().items()}
        self._graph = graph

    def run(self) -> list[list[float]]:
        """Run the chunk; returns the four metric rows, read with one
        transfer (the chunk's only host sync)."""
        self._slot.zero_()
        on_cuda = self._metrics.device.type == "cuda"
        if on_cuda and self._graph is None:
            self._capture()
        for _ in range(self.n_epochs):
            if on_cuda:
                self._graph.replay()
                self.graph_replays += 1
            else:
                self._epoch()
        self.state.step += self.n_epochs
        return self._metrics.tolist()

    def set_best(self, best_val: float, best_epoch: int) -> None:
        """Continue a resumed run's best-model bookkeeping (the caller loads
        ``best_params`` itself)."""
        self.best_val.fill_(best_val)
        self.best_epoch.fill_(best_epoch)


def fit_transductive_fast(
    cfg: GATConfig,
    data: CitationDataset,
    *,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    fastmode: bool = False,
    epoch_chunk: int = 50,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "cora",
    logger: TrainLogger | None = None,
    log_every: int = 50,
    init_params: Any = None,
    resume: bool = False,
) -> FitResult:
    """Same policy and result as :func:`fit_transductive` (the best-val
    parameters are restored exactly, tracked on the device), but the host
    syncs once per ``epoch_chunk`` epochs: early stopping can overshoot by up
    to ``epoch_chunk - 1`` epochs of extra compute, never changing the
    selected model. Checkpoints are written at chunk boundaries (full state)
    rather than every epoch. Seeds as :func:`fit_transductive`, so both
    loops see the same initial weights and dropout masks.

    ``resume=True`` continues exactly from the newest chunk checkpoint: the
    header carries the val-loss history (for the patience policy) and the
    best-val bookkeeping; the best parameters reload from the
    ``{tag}-best`` checkpoint refreshed at every chunk boundary.
    """
    logger = logger or TrainLogger()
    device = data.features.device
    if init_params is not None:
        params = init_params
    else:
        params = init_gat(cfg, make_generator("cpu", seed), device=device)
    optimizer = make_optimizer(params, lr, weight_decay,
                               capturable=device.type == "cuda")
    state = init_state(params, optimizer, make_generator(device, seed + 1))
    best_tag = dataset_tag + "-best"

    history: list[float] = []
    resumed = None
    if resume and checkpoint_dir:
        found = ckpt.latest(checkpoint_dir, dataset_tag)
        if found is not None:
            state, resumed = ckpt.restore(found[1], like=state)
            history = [float(v) for v in resumed.get("history", [])]
    x, g, labels = data.features, data.graph, data.labels
    plans = _plan_large(data, logger)
    chunk = ChunkedEpochs(cfg, state, x, g, labels, data.idx_train,
                          data.idx_val, n_epochs=epoch_chunk,
                          max_epochs=epochs, patience=patience,
                          fastmode=fastmode, plans=plans)
    if resumed is not None:
        best_val = float(resumed.get("best", np.inf))
        best_epoch = int(resumed.get("best_epoch", -1))
        chunk.set_best(best_val, best_epoch)
        bfound = ckpt.latest(checkpoint_dir, best_tag)
        if bfound is not None and best_epoch >= 0:
            ckpt.restore_params(bfound[1], into=chunk.best_params)
        logger.log("resume", epoch=len(history) - 1, best=best_val,
                   path=found[1])

    t0 = time.time()
    stopped = False
    while len(history) < epochs and not stopped:
        chunk_tr, chunk_acc_tr, chunk_vals, chunk_acc_val = chunk.run()
        for j, lv in enumerate(chunk_vals):
            epoch_idx = len(history)
            history.append(lv)
            if epoch_idx % log_every == 0:
                logger.log("epoch", epoch=epoch_idx, loss_train=chunk_tr[j],
                           acc_train=chunk_acc_tr[j], loss_val=lv,
                           acc_val=chunk_acc_val[j], time=time.time() - t0)
                t0 = time.time()
            # reference patience policy over the full history
            if epoch_idx - int(np.argmin(history)) >= patience:
                stopped = True
                break
            if epoch_idx + 1 >= epochs:
                break
        if checkpoint_dir:
            # chunk-boundary checkpoint with full resume bookkeeping: the
            # header carries the history (patience state) and the best val;
            # the best parameters refresh in the {tag}-best file
            be = int(chunk.best_epoch)
            last = len(history) - 1
            ckpt.save(checkpoint_dir, last, dataset_tag, state,
                      extra={"best": float(chunk.best_val), "best_epoch": be,
                             "history": history})
            ckpt.rotate_below_best(checkpoint_dir, dataset_tag, last)
            if be >= 0:
                ckpt.save(checkpoint_dir, be, best_tag, state,
                          params=chunk.best_params)
                ckpt.rotate_except(checkpoint_dir, best_tag, be)

    # the returned state carries the best parameters (and the last Adam
    # moments), as the JAX package's does; the {tag}-best file of the last
    # chunk boundary already holds them
    with torch.no_grad():
        for p, best in zip(parameters(state.params),
                           parameters(chunk.best_params)):
            p.copy_(best)
    best_epoch = int(chunk.best_epoch)

    _, eval_step = make_transductive_steps(cfg, plans)
    test_loss, test_acc, _ = eval_step(state.params, x, g, labels, data.idx_test)
    logger.log("test", loss=float(test_loss), accuracy=float(test_acc))
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=float(chunk.best_val),
        test_loss=float(test_loss),
        test_acc=float(test_acc),
        epochs_run=len(history),
        state=state,
        history=history,
        graph_replays=chunk.graph_replays,
        captured_launches=chunk.captured_launches,
    )
