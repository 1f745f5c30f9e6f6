"""Inductive (PPI) training loops with the reference's early-stop and
checkpoint-rotation policy (port of ``make_inductive_steps``,
``fit_inductive``, ``_banked_eval_fn``, ``make_banked_epochs`` and
``fit_inductive_banked`` from ``pygat_tpu/train/loop.py``;
train_ppi.py:112-216, whose broken checkpoint rotation is replaced by the
intended policy).

Two loops, both single-device and eager:

* :func:`fit_inductive` builds every epoch's block-diagonal batches on the
  host (:func:`~pygat_tpu_torch.data.ppi.make_batches`, walks included),
  shuffled by ``np.random.default_rng(seed + epoch)``, and reads the
  validation loss every epoch;
* :func:`fit_inductive_banked` keeps every graph on the device once
  (:func:`~pygat_tpu_torch.data.ppi.build_bank`) and collates each batch
  there (:func:`~pygat_tpu_torch.data.ppi.assemble_banked_batch`);
  :class:`BankedEpochs` runs a chunk of epochs with one host read, keeping
  the per-epoch metrics, the best model and the patience gate on the
  device.

The banked loop draws each epoch's graph order on the host with the same
``np.random.default_rng(seed + epoch)`` shuffle as the per-batch loop, where
the JAX package draws ``jax.random.permutation`` on the device (the same
distribution, not the same bits); with the same order the two loops train
on the same batches, and the members of every batch are host integers, so
assembling one needs no device read. Padding slots of the last batch
repeat the first members, as in the JAX package, and drop out of every
loss through the masks. There is no large-N plan here: the JAX inductive
loops never ask for one.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat, parameters
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.logging import TrainLogger
from pygat_tpu_torch.train.loop import FitResult
from pygat_tpu_torch.train.metrics import bce_with_logits, f1_counts, micro_f1
from pygat_tpu_torch.train.state import TrainState, init_state, make_optimizer
from pygat_tpu_torch.utils.platform import make_generator, resolve_device


def _make_loss(cfg: GATConfig):
    """``loss(params, x, graph, y, gen, train) -> (loss, f1, out)``: mean
    BCE over the graph's real rows and their micro-F1."""

    def _loss(params, x, graph, y, gen, train):
        out = apply_gat(params, cfg, x, graph, gen, train=train)
        mask = graph.node_mask
        loss = bce_with_logits(out, y, mask=mask)
        with torch.no_grad():
            f1 = micro_f1(out, y, mask=mask)
        return loss, f1, out

    return _loss


def make_inductive_steps(cfg: GATConfig):
    """(train_step, eval_step).

    ``train_step(state, x, graph, y) -> (state, loss, f1)`` runs forward
    with dropout, backward and one Adam update, in place;
    ``eval_step(params, x, graph, y) -> (loss, f1, tp, fp, fn)`` runs the
    forward without dropout or autograd. All results are 0-dim tensors on
    the data's device.
    """
    _loss = _make_loss(cfg)

    def train_step(state: TrainState, x, graph, y):
        state.optimizer.zero_grad(set_to_none=True)
        loss, f1, _ = _loss(state.params, x, graph, y, state.generator, True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), f1

    @torch.no_grad()
    def eval_step(params, x, graph, y):
        loss, f1, out = _loss(params, x, graph, y, None, False)
        tp, fp, fn = f1_counts(out, y, mask=graph.node_mask)
        return loss, f1, tp, fp, fn

    return train_step, eval_step


def _init(cfg, seed, lr, weight_decay, init_params, device) -> TrainState:
    """Parameters drawn from a CPU generator seeded with ``seed`` (the same
    weights on every device), or ``init_params``; dropout from a generator
    on ``device`` seeded with ``seed + 1``."""
    params = (init_params if init_params is not None
              else init_gat(cfg, make_generator("cpu", seed), device=device))
    return init_state(params, make_optimizer(params, lr, weight_decay),
                      make_generator(device, seed + 1))


def fit_inductive(
    cfg: GATConfig,
    data,  # pygat_tpu_torch.data.ppi.PPIData
    *,
    batch_size: int,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "ppi",
    logger: TrainLogger | None = None,
    log_batches: bool = True,
    init_params: Any = None,
    device: torch.device | str | None = None,
) -> FitResult:
    """The per-batch loop (train_ppi.py:112-216) on ``device`` (CUDA unless
    the caller names another device; raises without CUDA): every epoch
    the shuffled train batches, then the validation batches in order; save
    every epoch, drop checkpoints older than the best, stop after
    ``patience`` epochs without a better validation loss, keep the best
    and the last checkpoint and restore the best; then the test loss (the
    mean of its batches) and micro-F1 (from the summed counts). Each epoch
    logs a ``ppi_epoch`` record (the means of its batches); ``log_batches``
    adds one ``ppi_batch`` record per batch."""
    from pygat_tpu_torch.data.ppi import batch_bounds, make_batches

    device = resolve_device(device)
    logger = logger or TrainLogger()
    state = _init(cfg, seed, lr, weight_decay, init_params, device)
    train_step, eval_step = make_inductive_steps(cfg)

    # ONE static batch shape across all splits and epochs
    bounds = [batch_bounds(g, batch_size)
              for g in (data.train, data.valid, data.test)]
    n_pad = max(b[0] for b in bounds)
    e_pad = max(b[1] for b in bounds)

    def batches(graphs, **kw):
        return make_batches(graphs, batch_size, n_pad=n_pad, e_pad=e_pad,
                            device=device, **kw)

    best = float("inf")
    best_epoch = 0
    bad_counter = 0
    history: list[float] = []
    epoch = -1

    for epoch in range(epochs):
        t_epoch = t0 = time.time()
        tr_loss, tr_f1 = [], []
        for bi, pb in enumerate(batches(data.train, shuffle=True,
                                        seed=seed + epoch)):
            state, loss_tr, f1_tr = train_step(state, pb.features,
                                               pb.batch.graph, pb.labels)
            tr_loss.append(loss_tr)
            tr_f1.append(f1_tr)
            if log_batches:
                logger.log("ppi_batch", split="train", epoch=epoch, batch=bi,
                           loss=float(loss_tr), f1=float(f1_tr),
                           time=time.time() - t0)
            t0 = time.time()

        val_losses, val_f1 = [], []
        for bi, pb in enumerate(batches(data.valid)):
            loss_v, f1_v, *_ = eval_step(state.params, pb.features,
                                         pb.batch.graph, pb.labels)
            if log_batches:
                logger.log("ppi_batch", split="valid", epoch=epoch, batch=bi,
                           loss=float(loss_v), f1=float(f1_v),
                           time=time.time() - t0)
            t0 = time.time()
            val_losses.append(float(loss_v))
            val_f1.append(float(f1_v))
        loss_val = sum(val_losses) / len(val_losses)
        history.append(loss_val)
        logger.log("ppi_epoch", epoch=epoch,
                   loss_train=float(torch.stack(tr_loss).mean()),
                   f1_train=float(torch.stack(tr_f1).mean()),
                   loss_val=loss_val, f1_val=sum(val_f1) / len(val_f1),
                   time=time.time() - t_epoch)

        if checkpoint_dir:
            ckpt.save(checkpoint_dir, epoch, dataset_tag, state)
        if loss_val < best:
            best = loss_val
            best_epoch = epoch
            bad_counter = 0
        else:
            bad_counter += 1
        if bad_counter >= patience:
            break
        if checkpoint_dir:
            ckpt.rotate_below_best(checkpoint_dir, dataset_tag, best_epoch)

    if checkpoint_dir:
        # keep the final-epoch checkpoint too: a resume then continues from
        # where the run stopped instead of replaying post-best epochs
        ckpt.rotate_above_best(checkpoint_dir, dataset_tag, best_epoch,
                               keep_epoch=epoch)
        state, _ = ckpt.restore(
            ckpt.best_path(checkpoint_dir, dataset_tag, best_epoch), like=state)

    # test: mean batch loss + micro-F1 over the concatenation of all batches
    # (summed counts == concatenated micro-F1), train_ppi.py:155-174
    losses, tp, fp, fn = [], 0.0, 0.0, 0.0
    for pb in batches(data.test):
        loss_t, _, tp_b, fp_b, fn_b = eval_step(state.params, pb.features,
                                                pb.batch.graph, pb.labels)
        losses.append(float(loss_t))
        tp += float(tp_b)
        fp += float(fp_b)
        fn += float(fn_b)
    test_loss = sum(losses) / len(losses)
    test_f1 = 2 * tp / max(2 * tp + fp + fn, 1.0)
    logger.log("test", loss=test_loss, accuracy=test_f1)
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=best,
        test_loss=test_loss,
        test_acc=test_f1,
        epochs_run=epoch + 1,
        state=state,
        history=history,
    )


# ---------------------------------------------------------------------------
# The banked loop: every graph on the device once, batches collated there.
# ---------------------------------------------------------------------------


def _batch_slots(n_graphs: int, batch_size: int, order: np.ndarray
                 ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(members, live) of each batch of ``order``, the last batch padded
    with its first graphs, which are not live."""
    nb = -(-n_graphs // batch_size)
    pad = nb * batch_size - n_graphs
    if pad:
        order = np.concatenate([order, order[:pad]])
    live = np.arange(nb * batch_size) < n_graphs
    return list(zip(order.reshape(nb, batch_size),
                    live.reshape(nb, batch_size)))


def banked_eval(cfg: GATConfig, bank, batch_size: int):
    """``eval_bank(params) -> (losses [nb], f1s [nb], tp, fp, fn)``: a whole
    split of ``bank`` in order (the padding slots of the last batch repeat
    its first graphs), without dropout or autograd, as device tensors."""
    from pygat_tpu_torch.data.ppi import assemble_banked_batch

    _loss = _make_loss(cfg)
    slots = _batch_slots(bank.n_graphs, batch_size, np.arange(bank.n_graphs))

    @torch.no_grad()
    def eval_bank(params):
        losses, f1s, counts = [], [], []
        for idx, live in slots:
            x, g, y = assemble_banked_batch(bank, idx, live)
            loss, f1, out = _loss(params, x, g, y, None, False)
            losses.append(loss)
            f1s.append(f1)
            counts.append(torch.stack(f1_counts(out, y, mask=g.node_mask)))
        tp, fp, fn = torch.stack(counts).sum(0)
        return torch.stack(losses), torch.stack(f1s), tp, fp, fn

    return eval_bank


class BankedEpochs:
    """Banked epochs, ``n_epochs`` per :meth:`run` at most, with no host
    read inside the chunk: the counterpart of ``make_banked_epochs`` on
    one device.

    An epoch trains on the shuffled train bank (the order drawn on the
    host, see the module docstring) and evaluates the validation bank.
    The per-epoch metrics ``[4, n_epochs]`` (mean train loss, mean train
    micro-F1, mean validation loss, mean validation micro-F1), the best
    validation loss, its epoch and a copy of its parameters live on the
    device and are updated with ``torch.where`` under the reference's
    gate, as :class:`~pygat_tpu_torch.train.loop.ChunkedEpochs` does: an
    epoch past ``max_epochs`` never becomes the best, and with
    ``patience`` neither does an epoch that runs after the host's early
    stop would have fired (the chunk's overshoot), so the selected model is
    one the per-batch policy could reach. The epochs run eagerly;
    capturing one in a CUDA graph is later work.
    """

    def __init__(self, cfg: GATConfig, state: TrainState, bank_train,
                 bank_val, batch_size: int, *, n_epochs: int, seed: int,
                 max_epochs: int, patience: int | None = None):
        dev = bank_train.features.device
        self.state = state
        self.n_epochs = n_epochs
        self._bank = bank_train
        self._b = batch_size
        self._seed = seed
        self._loss = _make_loss(cfg)
        self._eval_val = banked_eval(cfg, bank_val, batch_size)
        self._max_epochs = max_epochs
        self._patience = patience
        self.best_val = torch.full((), float("inf"), device=dev)
        self.best_epoch = torch.full((), -1, dtype=torch.int64, device=dev)
        self.best_params = [
            type(p)(*(None if t is None else t.detach().clone() for t in p))
            for p in state.params]
        self._metrics = torch.zeros(4, n_epochs, device=dev)

    def _order(self, epoch: int) -> np.ndarray:
        """The train graphs' order in ``epoch``: the per-batch loop's
        shuffle, ``np.random.default_rng(seed + epoch)``."""
        order = np.arange(self._bank.n_graphs)
        np.random.default_rng(self._seed + epoch).shuffle(order)
        return order

    def _epoch(self, epoch: int, j: int) -> None:
        from pygat_tpu_torch.data.ppi import assemble_banked_batch

        state = self.state
        slots = _batch_slots(self._bank.n_graphs, self._b, self._order(epoch))
        tr_loss, tr_f1 = [], []
        for idx, live in slots:
            x, g, y = assemble_banked_batch(self._bank, idx, live)
            state.optimizer.zero_grad(set_to_none=True)
            loss, f1, _ = self._loss(state.params, x, g, y, state.generator,
                                     True)
            loss.backward()
            state.optimizer.step()
            state.step += 1
            tr_loss.append(loss.detach())
            tr_f1.append(f1)
        losses_v, f1s_v, *_ = self._eval_val(state.params)
        with torch.no_grad():
            loss_val = losses_v.mean()
            # epochs past the budget never update the best model
            improved = (loss_val < self.best_val) & (epoch < self._max_epochs)
            if self._patience is not None:
                # the host stops after epoch e once e - best_epoch >=
                # patience, so gate on the previous epoch (the one the host
                # checked); best_epoch freezes once gated
                improved &= (epoch - 1 - self.best_epoch) < self._patience
            self.best_val.copy_(torch.where(improved, loss_val, self.best_val))
            self.best_epoch.copy_(torch.where(
                improved, torch.full_like(self.best_epoch, epoch),
                self.best_epoch))
            for best, new in zip(parameters(self.best_params),
                                 parameters(state.params)):
                best.copy_(torch.where(improved, new, best))
            self._metrics[:, j] = torch.stack([
                torch.stack(tr_loss).mean(), torch.stack(tr_f1).mean(),
                loss_val, f1s_v.mean()])

    def run(self, first_epoch: int, n: int | None = None) -> list[list[float]]:
        """Run epochs ``first_epoch`` .. ``first_epoch + n - 1`` (``n`` at
        most, and by default, ``n_epochs``); returns the four metric rows,
        read with one transfer (the chunk's only host sync)."""
        n = self.n_epochs if n is None else n
        if not 0 < n <= self.n_epochs:
            raise ValueError(f"a chunk runs 1 to {self.n_epochs} epochs, not {n}")
        for j in range(n):
            self._epoch(first_epoch + j, j)
        return self._metrics[:, :n].tolist()

    def set_best(self, best_val: float, best_epoch: int) -> None:
        """Continue a resumed run's best-model bookkeeping (the caller loads
        ``best_params`` itself)."""
        self.best_val.fill_(best_val)
        self.best_epoch.fill_(best_epoch)


def fit_inductive_banked(
    cfg: GATConfig,
    data,  # pygat_tpu_torch.data.ppi.PPIData
    *,
    batch_size: int,
    lr: float,
    weight_decay: float,
    epochs: int,
    patience: int,
    seed: int = 72,
    epoch_chunk: int = 10,
    checkpoint_dir: str | None = None,
    dataset_tag: str = "ppi",
    logger: TrainLogger | None = None,
    log_every: int = 10,
    init_params: Any = None,
    resume: bool = False,
    device: torch.device | str | None = None,
) -> FitResult:
    """:func:`fit_inductive` over device-resident banks with one host sync
    per ``epoch_chunk`` epochs: early stopping can overshoot by up to
    ``epoch_chunk - 1`` epochs of extra compute, never changing the
    selected model (the last chunk stops at ``epochs``). Seeds and batch
    order as :func:`fit_inductive`, so both loops train the same model on
    the same batches. Checkpoints at chunk boundaries carry the val-loss
    history and the best bookkeeping in their header, the best parameters
    in the ``{tag}-best`` checkpoint; ``resume=True`` continues exactly
    from the newest ones."""
    from pygat_tpu_torch.data.ppi import bank_bounds, build_bank

    device = resolve_device(device)
    logger = logger or TrainLogger()
    state = _init(cfg, seed, lr, weight_decay, init_params, device)
    best_tag = dataset_tag + "-best"

    n_pg, e_pg = bank_bounds([data.train, data.valid, data.test])
    bank_tr = build_bank(data.train, n_pg, e_pg, device)
    bank_va = build_bank(data.valid, n_pg, e_pg, device)
    bank_te = build_bank(data.test, n_pg, e_pg, device)

    history: list[float] = []
    resumed = found = None
    if resume and checkpoint_dir:
        found = ckpt.latest(checkpoint_dir, dataset_tag)
        if found is not None:
            state, resumed = ckpt.restore(found[1], like=state)
            history = [float(v) for v in resumed.get("history", [])]
    chunk = BankedEpochs(cfg, state, bank_tr, bank_va, batch_size,
                         n_epochs=epoch_chunk, seed=seed, max_epochs=epochs,
                         patience=patience)
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
        n = min(epoch_chunk, epochs - len(history))
        chunk_tr, chunk_ftr, chunk_vals, chunk_fv = chunk.run(len(history), n)
        for j, lv in enumerate(chunk_vals):
            epoch_idx = len(history)
            history.append(lv)
            if epoch_idx % log_every == 0:
                logger.log("ppi_epoch", epoch=epoch_idx,
                           loss_train=chunk_tr[j], f1_train=chunk_ftr[j],
                           loss_val=lv, f1_val=chunk_fv[j],
                           time=time.time() - t0)
                t0 = time.time()
            # reference patience policy over the full history
            if epoch_idx - int(np.argmin(history)) >= patience:
                stopped = True
                break
        if checkpoint_dir:
            # chunk-boundary checkpoint with full resume bookkeeping
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
    # moments), as the JAX package's does
    with torch.no_grad():
        for p, best in zip(parameters(state.params),
                           parameters(chunk.best_params)):
            p.copy_(best)
    best_epoch = int(chunk.best_epoch)

    losses_t, _, tp, fp, fn = banked_eval(cfg, bank_te, batch_size)(
        state.params)
    test_loss = float(losses_t.mean())
    tp, fp, fn = float(tp), float(fp), float(fn)
    test_f1 = 2 * tp / max(2 * tp + fp + fn, 1.0)
    logger.log("test", loss=test_loss, accuracy=test_f1)
    return FitResult(
        best_epoch=best_epoch,
        best_val_loss=float(chunk.best_val),
        test_loss=test_loss,
        test_acc=test_f1,
        epochs_run=len(history),
        state=state,
        history=history,
    )
